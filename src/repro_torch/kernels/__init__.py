"""Hand-written CUDA kernels of the port, for Hopper (``sm_90a``).

  flash_attention — DiT and LM attention: ``csrc/flash_attention_sm90.cu``
                    (wgmma + TMA, bf16 at head dim 128, the video DiT and
                    the D-128 LMs' prefill, and at 64 and 80 from 128
                    queries up, the LM prefill and training forward),
                    ``csrc/flash_decode.cu`` (split-KV, bf16 at 64, 80 and
                    128 up to 8 queries, the LM decode step) and
                    ``csrc/flash_attention.cu`` (mma.sync for bf16 at 64 and
                    80 in between, 3xTF32 mma.sync for f32; on no serving
                    path); all share ``csrc/flash_common.cuh``; their
                    training backward ``csrc/flash_attention_bwd_sm90.cu``
                    (bf16, D 64 and 80), ``csrc/flash_attention_bwd_f32.cu``
                    (f32, 3xTF32) and ``csrc/flash_attention_bwd.cu``
                    (mma.sync, on no path)
  latent_blend    — LP's position-aware reconstruction (``csrc/latent_blend.cu``)
  int8_quantize   — per-slab max-abs int8 quantize of wire messages
                    (``csrc/int8_quantize.cu``)
  dequant_blend   — int8 dequantize fused with the LP stitch
                    (``csrc/dequant_blend.cu``)
  mamba_ssd       — the chunked Mamba2/SSD scan of the hybrid LM
                    (``csrc/mamba_ssd.cu``; an entry that also writes the
                    state entering each chunk, for the backward)
  mamba_ssd_bwd   — the scan's gradient, the hybrid LM's training path
                    (``csrc/mamba_ssd_bwd.cu``; no Pallas counterpart)
  mamba_ssd_wide  — the scan with B and C in groups, widths past 128 and
                    p = 1: the xLSTM's mLSTM (``csrc/mamba_ssd_wide.cu``)
  guidance_update — fused CFG combine + Euler step, an entry point of its
                    own (``csrc/guidance_update.cu``)

``ops.py`` holds the wrappers and launch counters, ``ref.py`` the plain
PyTorch versions (CPU tensors, and the yardstick on the card),
``build.py`` compiles the sources at first use.
"""
from . import ops, ref  # noqa: F401
