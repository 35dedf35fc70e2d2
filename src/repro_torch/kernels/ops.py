"""Wrappers of the port's CUDA kernels, with their launch counters.

Each wrapper takes its plain version (``kernels/ref.py``) for CPU
tensors only.  A CUDA tensor launches the kernel or raises: there is no
fallback.  ``<wrapper>.launches`` counts kernel launches, so a run can
show that the main path went through the kernels.

No wrapper takes part in autograd: under grad mode, an input that
requires grad is refused before anything runs (a kernel's output would
reach autograd as a constant).  Three routes differentiate:
``FlashAttention``, whose forward launches a flash kernel that writes each
row's log-sum-exp and whose backward ``flash_attention_bwd`` reads it (bf16
at D 64 and 80, f32 at D 32, 64, 80 and 128); ``MambaSSD``, whose forward
launches ``mamba_ssd``'s state-writing entry and whose backward
``mamba_ssd_bwd`` reads the states; and ``MambaSSDWide``, the same for the
grouped, wide-head scan (``mamba_ssd_wide(..., return_states=True)``, then
``mamba_ssd_wide_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import build, ref

INT32_MAX = ref.INT32_MAX
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_PARTITIONS = 32                 # latent_blend.cu: kMaxK
_SMEM_MAX = 232448                   # bytes of shared memory a block may use


def _dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return _DTYPE_CODES[t.dtype]


def _require_device(tensors: Dict[str, torch.Tensor], device: torch.device) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _require_aligned(tensors: Dict[str, torch.Tensor], align: int = 16) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary")


def _refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and one of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(getattr(t, "requires_grad", False) for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and this kernel has no backward: its output "
            "would reach autograd as a constant.  Call it under torch.no_grad(), or, for "
            "attention, through ops.flash_attention_autograd (the SSD scan: "
            "ops.mamba_ssd_autograd or ops.mamba_ssd_wide_autograd)")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# Which flash kernel computes what.  bf16 at head dims 64, 80 and 128 with at
# most DECODE_MAX_QUERIES queries (the LM decode steps) run on the split-KV
# kernel of csrc/flash_decode.cu; bf16 at head dim 128 with more queries (the
# video DiT's self- and cross-attention, the D-128 LMs' prefill), and bf16 at
# head dims 64 and 80 with at least SM90_MIN_QUERIES queries (the dense LM's
# training forward, the LM prefill) on the wgmma + TMA kernel of
# csrc/flash_attention_sm90.cu; every other case on csrc/flash_attention.cu
# (f32 at head dims 32 - the reduced configs' - 64, 80 and 128 there).
# A forward that must write the log-sum-exp (return_lse, FlashAttention)
# never takes flash_decode.cu.
FLASH_KERNELS = ("flash_attention", "flash_attention_sm90", "flash_decode")
_SM90_TILE = 128                     # flash_attention_sm90.cu: kBM query rows, kBN keys
SM90_MIN_QUERIES = _SM90_TILE
DECODE_MAX_QUERIES = 8
_DECODE_CHUNK = 64                   # flash_decode.cu: kChunk keys, the unit of a split
_FLASH_TAKES = {                     # kernel -> {dtype: head dims it is built for}
    "flash_attention": {torch.bfloat16: (64, 80), torch.float32: (32, 64, 80, 128)},
    "flash_attention_sm90": {torch.bfloat16: (64, 80, 128)},
    "flash_decode": {torch.bfloat16: (64, 80, 128)},
}
_LSE_KERNELS = ("flash_attention", "flash_attention_sm90")   # write the log-sum-exp


def flash_kernel(dtype: torch.dtype, head_dim: int, q_len: int) -> str:
    """The flash kernel that computes ``dtype`` at ``head_dim`` for
    ``q_len`` queries per batch row.

    bf16 at D 64, 80 and 128 with ``q_len <= DECODE_MAX_QUERIES``, as in
    a decode step (one query per request), goes to ``flash_decode``
    (split-KV over the attendable keys only, ``mma.sync`` bf16 products
    with f32 accumulators, one 16-row tile a warp).  bf16 at D 128 with
    more queries goes to ``flash_attention_sm90`` (``wgmma`` + TMA); bf16
    at D 64 and 80 goes there too when ``q_len >= SM90_MIN_QUERIES`` (128:
    one full block of its 128 query rows), as in a prefill or granite's
    training forward.  Everything else (bf16 D 64 and 80 with 9-127
    queries, f32 at D 32, 64, 80 and 128) runs on ``flash_attention``,
    which raises on what it is not built for (bf16 D 32).
    """
    if dtype == torch.bfloat16 and head_dim in (64, 80, 128) and q_len <= DECODE_MAX_QUERIES:
        return "flash_decode"
    if dtype == torch.bfloat16 and (head_dim == 128
                                    or (head_dim in (64, 80) and q_len >= SM90_MIN_QUERIES)):
        return "flash_attention_sm90"
    return "flash_attention"


def decode_split(Skv: int, batch_heads: int, resident: int):
    """``flash_decode``'s key split: ``(splits, split_len)`` for ``Skv``
    keys, ``batch_heads`` = B * KV (batch row, kv head) pairs and
    ``resident`` blocks the card holds at once.  As many splits as fill
    the resident blocks once (at least one, at most one a 64-key chunk),
    each a multiple of 64 keys; the last may be short."""
    splits = min(max(1, resident // max(batch_heads, 1)), max(1, -(-Skv // _DECODE_CHUNK)))
    split_len = -(-max(Skv, 1) // splits)
    split_len = -(-split_len // _DECODE_CHUNK) * _DECODE_CHUNK
    return -(-max(Skv, 1) // split_len), split_len


_DECODE_RESIDENT: Dict[tuple, int] = {}
_DECODE_TICKETS: Dict[tuple, torch.Tensor] = {}


def _decode_resident(device: torch.device, head_dim: int) -> int:
    """Blocks of ``flash_decode`` at ``head_dim`` that the card holds at
    once (occupancy x SMs), asked once per device."""
    key = (device.index, head_dim)
    if key not in _DECODE_RESIDENT:
        per_sm = build.library("flash_decode").flash_decode_blocks_per_sm(head_dim)
        if per_sm < 1:
            raise RuntimeError(f"flash_decode: occupancy query failed ({per_sm})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _DECODE_RESIDENT[key] = per_sm * sms
    return _DECODE_RESIDENT[key]


def _decode_tickets(device: torch.device, n: int) -> torch.Tensor:
    """``flash_decode``'s ticket counters, one per (batch row, kv head):
    zeroed once per device and stream and left zero by every launch, so
    they serve every call on that stream (calls on one stream never
    overlap).  Grown (zeroed again) when a call needs more."""
    key = (device, _stream(device))
    t = _DECODE_TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _DECODE_TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def _lists_shape(B: int, Sq: int, Skv: int):
    """The shape of ``flash_attention_sm90``'s live-tile lists: (B, q
    blocks of 128, key tiles of 128 + 1)."""
    return (B, -(-Sq // _SM90_TILE), -(-Skv // _SM90_TILE) + 1)


def flash_attention(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                    window: int = 0, kv_len=None, kernel=None, return_lse: bool = False):
    """Softmax attention: q ``(B,Sq,H,D)``, k/v ``(B,Skv,KV,D)``, int
    positions ``(B,S)`` (int32-max marks a padded kv slot); ``kv_len``
    ``(B,)`` masks keys at positions ``>= kv_len``.  ``return_lse``: return
    ``(out, lse)``, ``lse`` each row's log-sum-exp, f32 ``(B, H, Sq)`` in
    the units of ``ref.flash_attention_lse_ref`` (the backward's input).

    CUDA: ``flash_kernel(dtype, D, Sq)`` names the kernel, or ``kernel``
    (one of ``FLASH_KERNELS``) forces one; it raises on a dtype and head
    dim it is not built for.  With ``return_lse`` a choice of
    ``flash_decode``, which writes no log-sum-exp, becomes
    ``flash_attention`` (``flash_attention_sm90`` at D 128).  No gradient: see ``flash_attention_autograd``.
    ``csrc/flash_attention_sm90.cu`` (``wgmma`` + TMA) takes bf16 at D 64,
    80 and 128 and any key count: its live-tile lists go to a global buffer
    allocated here.  ``csrc/flash_attention.cu`` takes bf16 at D 64 and 80
    (``mma.sync``) and f32 at D 32, 64, 80 and 128 (3xTF32 ``mma.sync``).
    Both skip key tiles that hold no attendable pair, and their kernels
    (bf16 and f32) write the log-sum-exp into a buffer allocated here when
    asked.
    ``csrc/flash_decode.cu`` takes bf16 at D 64, 80 and 128 and any query count
    (rows in passes of 16): ``decode_split`` key splits, their partials in
    a workspace allocated here, merged by the last block of each (batch
    row, kv head) through ticket counters kept per device and stream; it
    masks ``kv_len`` itself.
    """
    _refuse_grad("flash_attention", q, k, v)
    if kernel is not None:
        takes = _FLASH_TAKES.get(kernel)
        if takes is None:
            raise ValueError(f"flash_attention: no flash kernel {kernel!r} ({FLASH_KERNELS})")
        if q.shape[-1] not in takes.get(q.dtype, ()):
            raise ValueError(f"flash_attention: {kernel} is not built for {q.dtype} at head "
                             f"dim {q.shape[-1]} (takes {takes})")
        if return_lse and kernel not in _LSE_KERNELS:
            raise ValueError(f"flash_attention: {kernel} writes no log-sum-exp "
                             f"({_LSE_KERNELS} do)")
    if q.device.type == "cpu":
        if kv_len is not None:
            kv_positions = torch.where(kv_positions < kv_len[:, None], kv_positions,
                                       INT32_MAX)
        out = ref.flash_attention_ref(q, k, v, q_positions, kv_positions, causal, window)
        if return_lse:
            return out, ref.flash_attention_lse_ref(q, k, q_positions, kv_positions, causal,
                                                    window)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if H % KV:
        raise ValueError(f"flash_attention: {H} heads not divisible by {KV} kv heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    code = _dtype_code(q, "flash_attention")
    if kernel is None:
        kernel = flash_kernel(q.dtype, D, Sq)
        if return_lse and kernel == "flash_decode":
            kernel = "flash_attention_sm90" if D == 128 else "flash_attention"
        if D not in _FLASH_TAKES[kernel].get(q.dtype, ()):
            raise ValueError(f"flash_attention: no kernel for {q.dtype} at head dim {D} "
                             f"(takes {_FLASH_TAKES})")
    if kv_len is not None:
        if kv_len.shape != (B,):
            raise ValueError(f"flash_attention: kv_len {tuple(kv_len.shape)} must be ({B},)")
        if kernel == "flash_decode":          # masked inside the kernel
            kv_len = kv_len.to(torch.int32).contiguous()
            _require_device({"kv_len": kv_len}, q.device)
        else:
            kv_positions = torch.where(kv_positions < kv_len[:, None], kv_positions,
                                       INT32_MAX)
            kv_len = None
    if q_positions.shape != (B, Sq) or kv_positions.shape != (B, Skv):
        raise ValueError("flash_attention: positions must be (B, Sq) and (B, Skv)")
    qp = q_positions.to(torch.int32)
    kp = kv_positions.to(torch.int32)
    if qp.stride(1) != 1:
        qp = qp.contiguous()
    if kp.stride(1) != 1:
        kp = kp.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    _require_device({"k": k, "v": v, "q_positions": qp, "kv_positions": kp}, q.device)
    _require_aligned({"q": q, "k": k, "v": v, "out": out})
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lse_ptr = None if lse is None else lse.data_ptr()
    lib = build.library(kernel)
    if kernel == "flash_attention_sm90":
        lists = torch.empty(_lists_shape(B, Sq, Skv), dtype=torch.int32, device=q.device)
        rc = lib.flash_attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            lists.data_ptr(), out.data_ptr(), lse_ptr, B, Sq, Skv, H, KV, D, qp.stride(0),
            kp.stride(0), int(bool(causal)), int(window), _stream(q.device),
        )
    elif kernel == "flash_decode":
        splits, split_len = decode_split(Skv, B * KV, _decode_resident(q.device, D))
        n = B * KV * splits * Sq * (H // KV)              # partial rows: (m, l) and acc[D]
        ws = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        rc = lib.flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
            ws.data_ptr() + 8 * n, _decode_tickets(q.device, B * KV).data_ptr(), B, Sq, Skv,
            H, KV, D, qp.stride(0), kp.stride(0), int(bool(causal)), int(window), splits,
            split_len, _stream(q.device),
        )
    else:
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            out.data_ptr(), lse_ptr, B, Sq, Skv, H, KV, D, qp.stride(0), kp.stride(0),
            int(bool(causal)), int(window), code, _stream(q.device),
        )
    build.check(kernel, rc)
    WRAPPERS[kernel].launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_sm90(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                         window: int = 0, kv_len=None, return_lse: bool = False):
    """``flash_attention`` on the ``wgmma`` + TMA kernel
    (``csrc/flash_attention_sm90.cu``) whatever the query count: bf16 at
    head dim 64, 80 or 128; raises on others.  Its ``launches`` count that
    kernel's launches, whichever wrapper made them."""
    return flash_attention(q, k, v, q_positions, kv_positions, causal=causal,
                           window=window, kv_len=kv_len, kernel="flash_attention_sm90",
                           return_lse=return_lse)


flash_attention_sm90.launches = 0


def flash_decode(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                 window: int = 0, kv_len=None) -> torch.Tensor:
    """``flash_attention`` on the split-KV kernel (``csrc/flash_decode.cu``)
    whatever the query count: bf16 at head dim 64, 80 or 128; raises on others.
    Its ``launches`` count that kernel's launches, whichever wrapper made
    them."""
    return flash_attention(q, k, v, q_positions, kv_positions, causal=causal,
                           window=window, kv_len=kv_len, kernel="flash_decode")


flash_decode.launches = 0


def flash_live_tiles(q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                     causal: bool, window: int) -> torch.Tensor:
    """The live-tile lists that ``flash_attention_sm90``'s pre-pass writes
    for these positions: int32 ``(B, q blocks of 128, key tiles of 128 +
    1)``, laid out as ``ref.live_tiles_plain`` says.  A check of that
    pre-pass alone (the attention launches it itself, as part of its
    one counted launch); CPU tensors get the plain version."""
    if q_positions.device.type == "cpu":
        return ref.live_tiles_plain(q_positions, kv_positions, _SM90_TILE, _SM90_TILE, causal,
                                    window)
    if q_positions.device.type != "cuda":
        raise ValueError(f"flash_live_tiles: no kernel for device {q_positions.device}")
    B, Sq = q_positions.shape
    Skv = kv_positions.shape[1]
    if kv_positions.shape[0] != B:
        raise ValueError("flash_live_tiles: positions must be (B, Sq) and (B, Skv)")
    qp = q_positions.to(torch.int32).contiguous()
    kp = kv_positions.to(torch.int32).contiguous()
    _require_device({"kv_positions": kp}, qp.device)
    lists = torch.empty(_lists_shape(B, Sq, Skv), dtype=torch.int32, device=qp.device)
    if lists.numel() == 0:
        return lists
    rc = build.library("flash_attention_sm90").flash_attention_sm90_live_tiles(
        qp.data_ptr(), kp.data_ptr(), lists.data_ptr(), B, Sq, Skv, qp.stride(0), kp.stride(0),
        int(bool(causal)), int(window), _stream(qp.device))
    build.check("flash_attention_sm90", rc)
    return lists


# The backward kernels: csrc/flash_attention_bwd_sm90.cu (wgmma + TMA) at bf16
# D 64 and 80, csrc/flash_attention_bwd_f32.cu (3xTF32 mma.sync) at f32 D 32,
# 64, 80 and 128 (the reduced configs' training and the checks), csrc/flash_attention_bwd.cu
# (mma.sync) at bf16 D 64 and 80, on no path (reached only through ``kernel=``:
# the same-run timing twin).
BWD_KERNELS = ("flash_attention_bwd", "flash_attention_bwd_sm90", "flash_attention_bwd_f32")
_BWD_TAKES = {"flash_attention_bwd_sm90": {torch.bfloat16: (64, 80)},
              "flash_attention_bwd": {torch.bfloat16: (64, 80)},
              "flash_attention_bwd_f32": {torch.float32: (32, 64, 80, 128)}}


def bwd_kernel(dtype: torch.dtype, head_dim: int):
    """The backward kernel that ``flash_attention_bwd`` runs for ``dtype``
    at ``head_dim``, or None: bf16 D 64 (granite's training attention) and
    D 80 (Zamba2's) on ``flash_attention_bwd_sm90``; f32 at D 32 (every
    reduced config), 64, 80 and 128 on ``flash_attention_bwd_f32``."""
    if dtype == torch.bfloat16 and head_dim in (64, 80):
        return "flash_attention_bwd_sm90"
    if dtype == torch.float32 and head_dim in _BWD_TAKES["flash_attention_bwd_f32"][dtype]:
        return "flash_attention_bwd_f32"
    return None


def flash_attention_bwd(q, k, v, out, dout, lse, q_positions, kv_positions, *,
                        causal: bool = True, window: int = 0, kernel=None):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention`` at ``(q, k, v)``
    for the output gradient ``dout``; ``out`` and ``lse`` are the forward's
    output and log-sum-exp there (``flash_attention(..., return_lse=True)``;
    f32 ``(B, H, Sq)``, the units of ``ref.flash_attention_lse_ref``).
    Shapes and masks as ``flash_attention`` (int32-max marks a padded key;
    fold a ``kv_len`` into the positions first).  A query row that attends
    no key gets zero gradients; with GQA dk and dv sum over the heads of a
    group.  Results in the dtypes of q, k and v.  On CPU tensors the plain
    ``ref.flash_attention_bwd_ref``, which derives its own softmax (``lse``
    may be None there).

    CUDA: ``bwd_kernel(dtype, D)`` names the kernel, or ``kernel`` (one of
    ``BWD_KERNELS``) forces one; it raises on what no kernel takes.  All
    are deterministic and launch three kernels (the f32 one at D 128 four:
    dv and dk apart), counted as one: ``Delta = rowsum(dout o out)`` into
    an f32 workspace allocated here, then dk and dv per key block, then dq
    per query block, each reading ``lse``.
    """
    _refuse_grad("flash_attention_bwd", q, k, v, out, dout)
    if kernel is not None and kernel not in _BWD_TAKES:
        raise ValueError(f"flash_attention_bwd: no backward kernel {kernel!r} ({BWD_KERNELS})")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, q_positions, kv_positions,
                                           causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KV, D) or v.shape != k.shape or out.shape != q.shape \
            or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} do not match")
    if H % KV:
        raise ValueError(f"flash_attention_bwd: {H} heads not divisible by {KV} kv heads")
    if any(t.dtype != q.dtype for t in (k, v, out, dout)):
        raise TypeError("flash_attention_bwd: q, k, v, out and dout must share one dtype")
    kernel = kernel or bwd_kernel(q.dtype, D)
    if kernel is None or D not in _BWD_TAKES[kernel].get(q.dtype, ()):
        raise ValueError(f"flash_attention_bwd: no kernel for {q.dtype} at head dim {D} "
                         f"(takes {_BWD_TAKES})")
    if q_positions.shape != (B, Sq) or kv_positions.shape != (B, Skv):
        raise ValueError("flash_attention_bwd: positions must be (B, Sq) and (B, Skv)")
    if lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        got = None if lse is None else (lse.dtype, tuple(lse.shape))
        raise ValueError(f"flash_attention_bwd: lse must be the forward's float32 "
                         f"{(B, H, Sq)} log-sum-exp, got {got}")
    qp = q_positions.to(torch.int32)
    kp = kv_positions.to(torch.int32)
    if qp.stride(1) != 1:
        qp = qp.contiguous()
    if kp.stride(1) != 1:
        kp = kp.contiguous()
    _require_device({"k": k, "v": v, "out": out, "dout": dout, "lse": lse, "q_positions": qp,
                     "kv_positions": kp}, q.device)
    _require_aligned({"q": q, "k": k, "v": v, "out": out, "dout": dout, "lse": lse})
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            qp.data_ptr(), kp.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KV, D, qp.stride(0), kp.stride(0),
            int(bool(causal)), int(window))
    lib = build.library(kernel)
    if kernel == "flash_attention_bwd_sm90":
        rc = lib.flash_attention_bwd_sm90(*args, _stream(q.device))
    elif kernel == "flash_attention_bwd_f32":
        rc = lib.flash_attention_bwd_f32(*args, _stream(q.device))
    else:
        rc = lib.flash_attention_bwd(*args, _DTYPE_CODES[q.dtype], _stream(q.device))
    build.check(kernel, rc)
    WRAPPERS[kernel].launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_bwd_sm90(q, k, v, out, dout, lse, q_positions, kv_positions, *,
                             causal: bool = True, window: int = 0):
    """``flash_attention_bwd`` on the ``wgmma`` + TMA kernel
    (``csrc/flash_attention_bwd_sm90.cu``): bf16 at head dim 64 or 80;
    raises on others.  Its ``launches`` count that kernel's launches, whichever
    wrapper made them."""
    return flash_attention_bwd(q, k, v, out, dout, lse, q_positions, kv_positions,
                               causal=causal, window=window, kernel="flash_attention_bwd_sm90")


flash_attention_bwd_sm90.launches = 0


def flash_attention_bwd_f32(q, k, v, out, dout, lse, q_positions, kv_positions, *,
                            causal: bool = True, window: int = 0):
    """``flash_attention_bwd`` on the f32 3xTF32 kernel
    (``csrc/flash_attention_bwd_f32.cu``): f32 at head dim 32, 64, 80 or
    128; raises on others.  Its ``launches`` count that kernel's launches,
    whichever wrapper made them."""
    return flash_attention_bwd(q, k, v, out, dout, lse, q_positions, kv_positions,
                               causal=causal, window=window, kernel="flash_attention_bwd_f32")


flash_attention_bwd_f32.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward on the flash kernel
    ``flash_kernel`` names, writing each row's log-sum-exp (never
    ``flash_decode``, which writes none), the backward on
    ``flash_attention_bwd``, which reads it.  It saves q, k, v, the output,
    the log-sum-exp and the positions; under activation checkpointing the
    forward runs (and launches) again in the backward pass and saves them
    anew."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window):
        out, lse = flash_attention(q, k, v, q_positions, kv_positions, causal=causal,
                                   window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, kv_positions)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qp, kp = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, qp, kp,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention_autograd(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                             window: int = 0, kv_len=None) -> torch.Tensor:
    """``flash_attention`` that autograd differentiates (``FlashAttention``);
    ``kv_len`` is folded into the key positions.  On CUDA it raises before
    any launch for a dtype and head dim no backward kernel takes."""
    if kv_len is not None:
        kv_positions = torch.where(kv_positions < kv_len[:, None], kv_positions, INT32_MAX)
    if q.device.type == "cuda" and bwd_kernel(q.dtype, q.shape[-1]) is None:
        raise ValueError(f"flash_attention_autograd: no backward kernel for {q.dtype} at "
                         f"head dim {q.shape[-1]} (takes {_BWD_TAKES})")
    return FlashAttention.apply(q, k, v, q_positions, kv_positions, causal, window)


def latent_blend(preds: torch.Tensor, weights: torch.Tensor,
                 normalizer: torch.Tensor, starts: Sequence[int],
                 window: int, extent: int) -> torch.Tensor:
    """Stitch K window predictions ``(K, W, F)`` into ``(E, F)``:
    ``out[x,f] = sum_k W_k[x-s_k] preds[k,x-s_k,f] / Z[x]`` with an f32
    accumulator.  ``weights`` ``(K, W)`` and ``normalizer`` ``(E,)`` are
    f32; ``starts`` are the K window offsets.

    CUDA: ``csrc/latent_blend.cu``, f32 preds (the serving path's type);
    16-byte loads where F % 4 == 0, 4-byte loads otherwise.
    """
    _refuse_grad("latent_blend", preds, weights, normalizer)
    if preds.device.type == "cpu":
        return ref.latent_blend_ref(preds, weights, normalizer, starts,
                                    window, extent)
    if preds.device.type != "cuda":
        raise ValueError(f"latent_blend: no kernel for device {preds.device}")
    K, W, F = preds.shape
    starts = [int(s) for s in starts]
    if W != window or len(starts) != K or not 1 <= K <= _MAX_PARTITIONS:
        raise ValueError(f"latent_blend: preds {tuple(preds.shape)} do not match "
                         f"window {window} and {len(starts)} starts (K <= {_MAX_PARTITIONS})")
    if any(s < 0 or s + window > extent for s in starts):
        raise ValueError(f"latent_blend: starts {starts} leave [0, {extent})")
    if weights.shape != (K, W) or weights.dtype != torch.float32:
        raise ValueError("latent_blend: weights must be float32 (K, W)")
    if normalizer.shape != (extent,) or normalizer.dtype != torch.float32:
        raise ValueError("latent_blend: normalizer must be float32 (E,)")
    if preds.dtype != torch.float32:
        raise TypeError(f"latent_blend: dtype {preds.dtype} not supported (float32)")
    out = torch.empty((extent, F), dtype=preds.dtype, device=preds.device)
    _require_device({"weights": weights, "normalizer": normalizer}, preds.device)
    _require_aligned({"preds": preds, "weights": weights,
                      "normalizer": normalizer, "out": out})
    if out.numel() == 0:
        return out
    lib = build.library("latent_blend")
    c_starts = (ctypes.c_int * K)(*starts)
    rc = lib.latent_blend_fwd(
        preds.data_ptr(), weights.data_ptr(), normalizer.data_ptr(),
        out.data_ptr(), c_starts, K, W, extent, F, _stream(preds.device),
    )
    build.check("latent_blend", rc)
    latent_blend.launches += 1
    return out


latent_blend.launches = 0

def int8_quantize(x: torch.Tensor, qmax: int = 127):
    """Quantize N slabs at once: ``x`` ``(N, R, F)`` f32 -> the int8 wire
    ``(N, R, F)`` and N f32 scales, one per slab,
    ``scale_n = max(max|x_n|, 1e-20) / qmax``; codes are
    ``clip(round_half_even(x_n / scale_n), -qmax, qmax)``.  qmax 127 is
    the int8 codec, 7 the int4 codes before packing.

    CUDA: ``csrc/int8_quantize.cu``, one cooperative launch of one block
    an SM: a slab's blocks exchange their maxes through a scratch word
    each, allocated here, across a grid barrier.
    """
    _refuse_grad("int8_quantize", x)
    if x.device.type == "cpu":
        return ref.int8_quantize_ref(x, qmax)
    if x.device.type != "cuda":
        raise ValueError(f"int8_quantize: no kernel for device {x.device}")
    if x.ndim != 3 or x.dtype != torch.float32:
        raise ValueError(f"int8_quantize: x must be float32 (N, R, F), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 1 <= qmax <= 127:
        raise ValueError(f"int8_quantize: qmax {qmax} outside [1, 127]")
    N = x.shape[0]
    M = x.shape[1] * x.shape[2]
    wire = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((N,), dtype=torch.float32, device=x.device)
    if wire.numel() == 0:
        return wire, scales
    _require_aligned({"x": x}, align=1)    # contiguity only: the kernel takes any slab start
    lib = build.library("int8_quantize")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    part = torch.empty((sms,), dtype=torch.int32, device=x.device)
    rc = lib.int8_quantize_fwd(x.data_ptr(), wire.data_ptr(), scales.data_ptr(),
                               part.data_ptr(), sms, N, M, int(qmax), _stream(x.device))
    build.check("int8_quantize", rc)
    int8_quantize.launches += 1
    return wire, scales


int8_quantize.launches = 0


def dequant_blend(wire: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
                  normalizer: torch.Tensor, starts: Sequence[int], window: int,
                  extent: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``latent_blend`` of int8 windows dequantized on the fly:
    ``out[x,f] = sum_k W_k[x-s_k] * scale_k * wire[k,x-s_k,f] / Z[x]`` with
    an f32 accumulator, ``wire`` ``(K, W, F)`` int8, ``scales`` ``(K,)``,
    ``weights`` ``(K, W)`` and ``normalizer`` ``(E,)`` f32; the output
    ``(E, F)`` is ``out_dtype`` (f32 or bf16).

    CUDA: ``csrc/dequant_blend.cu``: 16 codes a thread (one 16-byte load a
    covering window) where F % 16 == 0, the wire starts on 16 bytes and
    the runs fill the card once (the 480p latent), 4 where F % 4 == 0 (the
    smoke's latent), else 1.
    """
    _refuse_grad("dequant_blend", scales, weights, normalizer)
    if wire.device.type == "cpu":
        return ref.dequant_blend_ref(wire, scales, weights, normalizer, starts,
                                     window, extent, out_dtype)
    if wire.device.type != "cuda":
        raise ValueError(f"dequant_blend: no kernel for device {wire.device}")
    K, W, F = wire.shape
    starts = [int(s) for s in starts]
    if W != window or len(starts) != K or not 1 <= K <= _MAX_PARTITIONS:
        raise ValueError(f"dequant_blend: wire {tuple(wire.shape)} does not match "
                         f"window {window} and {len(starts)} starts (K <= {_MAX_PARTITIONS})")
    if any(s < 0 or s + window > extent for s in starts):
        raise ValueError(f"dequant_blend: starts {starts} leave [0, {extent})")
    if wire.dtype != torch.int8:
        raise TypeError(f"dequant_blend: wire dtype {wire.dtype} not supported (int8)")
    if scales.shape != (K,) or scales.dtype != torch.float32:
        raise ValueError("dequant_blend: scales must be float32 (K,)")
    if weights.shape != (K, W) or weights.dtype != torch.float32:
        raise ValueError("dequant_blend: weights must be float32 (K, W)")
    if normalizer.shape != (extent,) or normalizer.dtype != torch.float32:
        raise ValueError("dequant_blend: normalizer must be float32 (E,)")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"dequant_blend: out_dtype {out_dtype} not supported "
                        "(float32 or bfloat16)")
    out = torch.empty((extent, F), dtype=out_dtype, device=wire.device)
    _require_device({"scales": scales, "weights": weights, "normalizer": normalizer},
                    wire.device)
    # contiguity only: the launcher takes 16-, 4- or 1-byte code loads as F
    # and the wire's start allow
    _require_aligned({"wire": wire, "scales": scales, "weights": weights,
                      "normalizer": normalizer, "out": out}, align=1)
    if out.numel() == 0:
        return out
    lib = build.library("dequant_blend")
    c_starts = (ctypes.c_int * K)(*starts)
    rc = lib.dequant_blend_fwd(
        wire.data_ptr(), scales.data_ptr(), weights.data_ptr(), normalizer.data_ptr(),
        out.data_ptr(), c_starts, K, W, extent, F, _DTYPE_CODES[out_dtype],
        _stream(wire.device),
    )
    build.check("dequant_blend", rc)
    dequant_blend.launches += 1
    return out


dequant_blend.launches = 0

def _ssd_shapes(what: str, x, log_decay, scale, B, C, chunk: int):
    """Check the scan's inputs on the card: shapes, f32, p / n / chunk."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if log_decay.shape != (b, s, h) or scale.shape != (b, s, h):
        raise ValueError(f"{what}: log_decay {tuple(log_decay.shape)} and scale "
                         f"{tuple(scale.shape)} must be {(b, s, h)}")
    if B.shape != (b, s, n) or C.shape != (b, s, n):
        raise ValueError(f"{what}: B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"(b, s, n) with b, s of x {tuple(x.shape)} (ssm_groups 1)")
    for name, t in {"x": x, "log_decay": log_decay, "scale": scale, "B": B, "C": C}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} dtype {t.dtype} not supported (float32)")
    for name, v in (("head dim p", p), ("state n", n), ("chunk", chunk)):
        if not (16 <= v <= 128 and v % 16 == 0):
            raise ValueError(f"{what}: {name} {v} not supported (a multiple of 16 "
                             "in [16, 128])")
    return b, s, h, p, n


def mamba_ssd(x: torch.Tensor, log_decay: torch.Tensor, scale: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, chunk: int = 64, return_states: bool = False):
    """Chunked Mamba2/SSD scan for ``ssm_groups == 1``: x ``(b, s, h, p)``,
    log_decay and scale ``(b, s, h)``, B and C ``(b, s, n)``; returns y
    ``(b, s, h, p)`` in x's dtype.  ``S_t = exp(log_decay_t) S_{t-1} +
    scale_t B_t (x) x_t``, ``y_t = C_t . S_t``, computed in chunks of
    ``chunk`` tokens in the factorized form of
    ``models/ssm.gated_linear_scan`` (centred exponents clipped to +-60),
    so ``chunk`` changes the result in the last bits.  ``return_states``
    also returns the f32 state entering each chunk, ``(b, ceil(s /
    chunk), h, n, p)``, for ``mamba_ssd_bwd``.

    CUDA: ``csrc/mamba_ssd.cu`` (3xTF32 tensor-core products), f32, p, n
    and chunk multiples of 16 in [16, 128] whose block fits the card's
    shared memory (the launcher refuses the rest).  A scratch buffer of the
    chunks' Gram matrices and per-head decay scalars, written by the
    kernel's pre-pass, is allocated here.  ``return_states`` runs the
    kernel's state-writing entry (``mamba_ssd_fwd_states``), the same
    launch with one more store.
    """
    _refuse_grad("mamba_ssd", x, log_decay, scale, B, C)
    if x.device.type == "cpu":
        return ref.mamba_ssd_plain(x, log_decay, scale, B, C, chunk, return_states)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_ssd: no kernel for device {x.device}")
    b, s, h, p, n = _ssd_shapes("mamba_ssd", x, log_decay, scale, B, C, chunk)
    tensors = {"x": x, "log_decay": log_decay, "scale": scale, "B": B, "C": C}
    y = torch.empty_like(x)
    states = torch.empty((b, -(-s // chunk), h, n, p), dtype=torch.float32,
                         device=x.device) if return_states else None
    _require_device(tensors, x.device)
    _require_aligned({**tensors, "y": y})
    if y.numel() == 0:
        return (y, states) if return_states else y
    lib = build.library("mamba_ssd")
    scratch = torch.empty(lib.mamba_ssd_scratch_bytes(b, s, h, n, int(chunk)) // 4,
                          dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), log_decay.data_ptr(), scale.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), scratch.data_ptr())
    if return_states:
        rc = lib.mamba_ssd_fwd_states(*args, states.data_ptr(), b, s, h, p, n, int(chunk),
                                      _stream(x.device))
    else:
        rc = lib.mamba_ssd_fwd(*args, b, s, h, p, n, int(chunk), _stream(x.device))
    build.check("mamba_ssd", rc)
    mamba_ssd.launches += 1
    return (y, states) if return_states else y


mamba_ssd.launches = 0


def mamba_ssd_bwd(x: torch.Tensor, log_decay: torch.Tensor, scale: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, states: torch.Tensor,
                  chunk: int = 64):
    """Gradients ``(dx, dlog_decay, dscale, dB, dC)`` of ``mamba_ssd`` at
    its inputs for the output gradient ``dy`` ``(b, s, h, p)``; ``states``
    are the forward's (``mamba_ssd(..., return_states=True)``).  f32, the
    inputs' shapes.  The function differentiated is autograd's of
    ``ref.ssd_scan`` (the clip passes no gradient where it bites, the centre
    passes its share to the tied extremes, the padding of a ragged chunk
    takes none).  On CPU tensors the plain ``ref.mamba_ssd_bwd_plain``,
    which derives the states itself (``states`` may be None there).

    CUDA: ``csrc/mamba_ssd_bwd.cu`` (3xTF32 tensor-core products),
    deterministic: four launches, counted as one (the local state terms
    per chunk and head, their carry over the chunks in reverse, the
    chunk-local gradients per (chunk, head group), the head groups' shares
    of dB and dC summed in order), with a scratch buffer allocated here
    (``mamba_ssd_bwd_scratch_bytes``); the shapes of ``mamba_ssd`` whose
    tiles fit 227 KB (p, n, chunk 64 take 205 KB); it raises on the rest.
    """
    _refuse_grad("mamba_ssd_bwd", x, log_decay, scale, B, C, dy)
    if x.device.type == "cpu":
        return ref.mamba_ssd_bwd_plain(x, log_decay, scale, B, C, dy, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_ssd_bwd: no kernel for device {x.device}")
    b, s, h, p, n = _ssd_shapes("mamba_ssd_bwd", x, log_decay, scale, B, C, chunk)
    nc = -(-s // chunk)
    if dy.shape != x.shape or dy.dtype != torch.float32:
        raise ValueError(f"mamba_ssd_bwd: dy {dy.dtype} {tuple(dy.shape)} must be float32 "
                         f"{tuple(x.shape)}")
    if states is None or states.shape != (b, nc, h, n, p) or states.dtype != torch.float32:
        got = None if states is None else (states.dtype, tuple(states.shape))
        raise ValueError(f"mamba_ssd_bwd: states must be the forward's float32 "
                         f"{(b, nc, h, n, p)}, got {got}")
    tensors = {"x": x, "log_decay": log_decay, "scale": scale, "B": B, "C": C, "dy": dy,
               "states": states}
    _require_device(tensors, x.device)
    _require_aligned(tensors)
    outs = [torch.empty_like(t) for t in (x, log_decay, scale, B, C)]
    if x.numel() == 0 or B.numel() == 0:
        return tuple(o.zero_() for o in outs)
    lib = build.library("mamba_ssd_bwd")
    scratch = torch.empty(lib.mamba_ssd_bwd_scratch_bytes(b, s, h, p, n, int(chunk)) // 4,
                          dtype=torch.float32, device=x.device)
    rc = lib.mamba_ssd_bwd(*(t.data_ptr() for t in tensors.values()),
                           *(o.data_ptr() for o in outs), scratch.data_ptr(), b, s, h, p, n,
                           int(chunk), _stream(x.device))
    build.check("mamba_ssd_bwd", rc)
    mamba_ssd_bwd.launches += 1
    return tuple(outs)


mamba_ssd_bwd.launches = 0


class MambaSSD(torch.autograd.Function):
    """The SSD scan with a gradient: the forward on ``mamba_ssd``'s
    state-writing entry, the backward on ``mamba_ssd_bwd``, which reads
    the states.  It saves the inputs and the states; under activation
    checkpointing the forward runs (and launches) again in the backward
    pass and saves them anew."""

    @staticmethod
    def forward(ctx, x, log_decay, scale, B, C, chunk):
        y, states = mamba_ssd(x, log_decay, scale, B, C, chunk=chunk, return_states=True)
        ctx.save_for_backward(x, log_decay, scale, B, C, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, log_decay, scale, B, C, states = ctx.saved_tensors
        grads = mamba_ssd_bwd(x, log_decay, scale, B, C, dy.float().contiguous(), states,
                              chunk=ctx.chunk)
        return (*grads, None)


def mamba_ssd_autograd(x, log_decay, scale, B, C, chunk: int = 64) -> torch.Tensor:
    """``mamba_ssd`` that autograd differentiates (``MambaSSD``), f32 in and
    out.  On CUDA it raises before any launch for a shape the backward
    kernel does not take."""
    if x.device.type == "cuda":
        _ssd_shapes("mamba_ssd_autograd", x, log_decay, scale, B, C, chunk)
        lib = build.library("mamba_ssd_bwd")
        if lib.mamba_ssd_bwd_smem_bytes(B.shape[-1], x.shape[-1], int(chunk)) > _SMEM_MAX:
            raise ValueError(f"mamba_ssd_autograd: no backward kernel for p {x.shape[-1]}, "
                             f"n {B.shape[-1]}, chunk {chunk} (its tiles exceed 227 KB)")
    return MambaSSD.apply(x, log_decay, scale, B, C, chunk)


def ssd_kernel(groups: int, p: int, n: int, chunk: int) -> str:
    """The kernel that runs the SSD scan on the card: ``mamba_ssd`` for one
    group with p, n and chunk multiples of 16 in [16, 128] (Zamba2's
    shapes), ``mamba_ssd_wide`` for the rest (groups g | h, widths past
    128, p = 1: the mLSTM's scans)."""
    fits = all(16 <= v <= 128 and v % 16 == 0 for v in (p, n, chunk))
    return "mamba_ssd" if groups == 1 and fits else "mamba_ssd_wide"


def _wide_shapes(what: str, x, log_decay, scale, B, C, chunk: int):
    """Check the grouped scan's inputs on the card: shapes, f32, n, chunk
    and the launch grid's limits (``mamba_ssd_wide_scratch_bytes``)."""
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be (b, s, h, p) and B "
                         f"{tuple(B.shape)} (b, s, g, n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if log_decay.shape != (b, s, h) or scale.shape != (b, s, h):
        raise ValueError(f"{what}: log_decay {tuple(log_decay.shape)} and scale "
                         f"{tuple(scale.shape)} must be {(b, s, h)}")
    if B.shape[:2] != (b, s) or C.shape != B.shape or g < 1 or h % g:
        raise ValueError(f"{what}: B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"(b, s, g, n) with g dividing h {h}")
    for name, t in {"x": x, "log_decay": log_decay, "scale": scale, "B": B, "C": C}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} dtype {t.dtype} not supported (float32)")
    if n < 16 or n % 16:
        raise ValueError(f"{what}: state n {n} not supported (a multiple of 16)")
    if not (16 <= chunk <= 128 and chunk % 16 == 0):
        raise ValueError(f"{what}: chunk {chunk} not supported (a multiple of 16 in "
                         "[16, 128])")
    if b * -(-s // chunk) > 65535 or b * g > 65535 or h > 65535:
        raise ValueError(f"{what}: shape {(b, s, h, g, p, n)} at chunk {chunk} not "
                         "supported (batch x chunks and batch x groups <= 65535)")
    return b, s, h, g, p, n


def mamba_ssd_wide(x: torch.Tensor, log_decay: torch.Tensor, scale: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
                   return_states: bool = False):
    """The chunked scan of ``models/ssm.gated_linear_scan(factorized=True)``
    with B and C in groups: x ``(b, s, h, p)``, log_decay and scale ``(b,
    s, h)``, B and C ``(b, s, g, n)`` with ``g | h`` (head ``i`` reads group
    ``i // (h / g)``); returns f32 y ``(b, s, h, p)``.  Its plain version
    is ``ref.ssd_scan``.  ``return_states`` also returns the f32 state
    entering each chunk, ``(b, ceil(s / chunk), h, n, p)``, for
    ``mamba_ssd_wide_bwd``.

    CUDA: ``csrc/mamba_ssd_wide.cu`` (3xTF32 products on ``wgmma``; p <= 4,
    the normaliser, in f32 FMA), f32, any p (p = 1 included), n a multiple
    of 16, chunk a multiple of 16 in [16, 128]; it raises on the rest.  Two
    launches, counted as one (three past n = 1024): the Gram and decay
    scalars, then the scan, a cluster of 8 blocks per (batch, head, 128
    columns of p) keeping the state on chip over the chunks and writing y;
    a scratch buffer (the Grams and scalars) is allocated here.
    ``return_states`` has the scan also write the state entering each
    chunk, f32 ``(b, chunks, h, n, p)``, at the head of the scratch buffer,
    and returns a view of it.
    """
    _refuse_grad("mamba_ssd_wide", x, log_decay, scale, B, C)
    if x.device.type == "cpu":
        return ref.ssd_scan(x, log_decay, scale, B, C, chunk, True, return_states)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_ssd_wide: no kernel for device {x.device}")
    b, s, h, g, p, n = _wide_shapes("mamba_ssd_wide", x, log_decay, scale, B, C, chunk)
    tensors = {"x": x, "log_decay": log_decay, "scale": scale, "B": B, "C": C}
    y = torch.empty_like(x)
    _require_device(tensors, x.device)
    _require_aligned({**tensors, "y": y})
    nc = -(-s // chunk)
    if y.numel() == 0:
        states = torch.zeros((b, nc, h, n, p), dtype=torch.float32, device=x.device)
        return (y, states) if return_states else y
    lib = build.library("mamba_ssd_wide")
    nbytes = lib.mamba_ssd_wide_scratch_bytes(b, s, h, g, p, n, int(chunk), int(return_states))
    if nbytes <= 0:
        raise ValueError(f"mamba_ssd_wide: shape {(b, s, h, g, p, n)} at chunk {chunk} not "
                         "supported (batch x chunks and batch x groups <= 65535)")
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    rc = lib.mamba_ssd_wide_fwd(*(t.data_ptr() for t in tensors.values()), y.data_ptr(),
                                scratch.data_ptr(), b, s, h, g, p, n, int(chunk),
                                int(return_states), _stream(x.device))
    build.check("mamba_ssd_wide", rc)
    mamba_ssd_wide.launches += 1
    if return_states:
        return y, scratch[:b * nc * h * n * p].view(b, nc, h, n, p)
    return y


mamba_ssd_wide.launches = 0


def mamba_ssd_wide_bwd(x: torch.Tensor, log_decay: torch.Tensor, scale: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                       states: torch.Tensor, chunk: int = 128, need_dx: bool = True):
    """Gradients ``(dx, dlog_decay, dscale, dB, dC)`` of ``mamba_ssd_wide``
    at its inputs for the output gradient ``dy`` ``(b, s, h, p)``; ``states``
    are the forward's (``mamba_ssd_wide(..., return_states=True)``).  f32,
    the inputs' shapes; dB and dC ``(b, s, g, n)`` sum the shares of a
    group's heads in head order.  The function differentiated is autograd's
    of ``ref.ssd_scan`` (the clip passes no gradient where it bites, the
    centre passes its share to the tied extremes, the padding of a ragged
    chunk takes none).  ``need_dx=False`` returns None for dx and skips its
    work (the other four are bit-equal either way).  On CPU tensors the
    plain ``ref.ssd_scan_bwd``, which derives the states itself (``states``
    may be None there).

    CUDA: ``csrc/mamba_ssd_wide_bwd.cu`` (3xTF32 tensor-core products),
    deterministic, every shape ``mamba_ssd_wide`` takes: five launches,
    counted as one (the Gram and the decay scalars; the chunk-local Q x Q
    terms, and in blocks beside them the in-chunk term of dx; the sweep of
    dS over the chunks in reverse, clusters of ceil(n / 128) blocks holding
    it on chip and adding z (B dS) to dx, or for p <= 4 the narrow f32
    launch; dB and dC per group; the scalars' chain; past n = 1024 a sixth
    adds the clusters' shares of dx), with a scratch buffer allocated here
    (``mamba_ssd_wide_bwd_scratch_bytes``, dS the bulk of it: the size of
    the states).
    """
    _refuse_grad("mamba_ssd_wide_bwd", x, log_decay, scale, B, C, dy)
    if x.device.type == "cpu":
        grads = ref.ssd_scan_bwd(x, log_decay, scale, B, C, dy, chunk)
        return grads if need_dx else (None, *grads[1:])
    if x.device.type != "cuda":
        raise ValueError(f"mamba_ssd_wide_bwd: no kernel for device {x.device}")
    b, s, h, g, p, n = _wide_shapes("mamba_ssd_wide_bwd", x, log_decay, scale, B, C, chunk)
    nc = -(-s // chunk)
    if dy.shape != x.shape or dy.dtype != torch.float32:
        raise ValueError(f"mamba_ssd_wide_bwd: dy {dy.dtype} {tuple(dy.shape)} must be float32 "
                         f"{tuple(x.shape)}")
    if states is None or states.shape != (b, nc, h, n, p) or states.dtype != torch.float32:
        got = None if states is None else (states.dtype, tuple(states.shape))
        raise ValueError(f"mamba_ssd_wide_bwd: states must be the forward's float32 "
                         f"{(b, nc, h, n, p)}, got {got}")
    tensors = {"x": x, "log_decay": log_decay, "scale": scale, "B": B, "C": C, "dy": dy,
               "states": states}
    _require_device(tensors, x.device)
    _require_aligned(tensors)
    outs = [torch.empty_like(t) if need_dx or i else None
            for i, t in enumerate((x, log_decay, scale, B, C))]
    if x.numel() == 0 or B.numel() == 0:
        return tuple(o if o is None else o.zero_() for o in outs)
    lib = build.library("mamba_ssd_wide_bwd")
    nbytes = lib.mamba_ssd_wide_bwd_scratch_bytes(b, s, h, g, p, n, int(chunk))
    if nbytes <= 0:
        raise ValueError(f"mamba_ssd_wide_bwd: shape {(b, s, h, g, p, n)} at chunk {chunk} "
                         "not supported")
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    rc = lib.mamba_ssd_wide_bwd(*(t.data_ptr() for t in tensors.values()),
                                *(0 if o is None else o.data_ptr() for o in outs),
                                scratch.data_ptr(), b, s, h, g, p, n, int(chunk), int(need_dx),
                                _stream(x.device))
    build.check("mamba_ssd_wide_bwd", rc)
    mamba_ssd_wide_bwd.launches += 1
    return tuple(outs)


mamba_ssd_wide_bwd.launches = 0


class MambaSSDWide(torch.autograd.Function):
    """The grouped, wide-head scan with a gradient: the forward on
    ``mamba_ssd_wide(..., return_states=True)``, the backward on
    ``mamba_ssd_wide_bwd``, which reads the states.  It saves the inputs and
    the states; under activation checkpointing the forward runs (and
    launches) again in the backward pass and saves them anew."""

    @staticmethod
    def forward(ctx, x, log_decay, scale, B, C, chunk):
        y, states = mamba_ssd_wide(x, log_decay, scale, B, C, chunk=chunk, return_states=True)
        ctx.save_for_backward(x, log_decay, scale, B, C, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, log_decay, scale, B, C, states = ctx.saved_tensors
        grads = mamba_ssd_wide_bwd(x, log_decay, scale, B, C, dy.float().contiguous(), states,
                                   chunk=ctx.chunk, need_dx=ctx.needs_input_grad[0])
        return (*grads, None)


def mamba_ssd_wide_autograd(x, log_decay, scale, B, C, chunk: int = 128) -> torch.Tensor:
    """``mamba_ssd_wide`` that autograd differentiates (``MambaSSDWide``),
    f32 in and out.  On CUDA it raises before any launch for a shape the
    kernels do not take."""
    if x.device.type == "cuda":
        _wide_shapes("mamba_ssd_wide_autograd", x, log_decay, scale, B, C, chunk)
    return MambaSSDWide.apply(x, log_decay, scale, B, C, chunk)


def guidance_update(z: torch.Tensor, cond: torch.Tensor, uncond: torch.Tensor,
                    w: float, dt: float) -> torch.Tensor:
    """Fused CFG combine + flow-matching Euler step: ``z + dt * (u + w *
    (c - u))`` in f32, cast back to z's dtype; z, cond and uncond share one
    shape and one dtype (f32 or bf16), ``w`` and ``dt`` are floats.

    The reference's ``blk`` and ``interpret`` arguments are TPU tiling and
    emulation knobs; the port takes neither.  No path of the port calls
    it: the sampler keeps ``cfg_combine``'s rounding of the guided
    prediction to the model dtype before the Euler update, which this
    fused update does not do.

    CUDA: ``csrc/guidance_update.cu``, contiguous inputs.
    """
    _refuse_grad("guidance_update", z, cond, uncond)
    if cond.shape != z.shape or uncond.shape != z.shape:
        raise ValueError(f"guidance_update: z {tuple(z.shape)}, cond {tuple(cond.shape)} "
                         f"and uncond {tuple(uncond.shape)} must share one shape")
    if cond.dtype != z.dtype or uncond.dtype != z.dtype:
        raise TypeError(f"guidance_update: mixed dtypes (z {z.dtype}, cond {cond.dtype}, "
                        f"uncond {uncond.dtype})")
    if z.device.type == "cpu":
        return ref.guidance_update_plain(z, cond, uncond, w, dt)
    if z.device.type != "cuda":
        raise ValueError(f"guidance_update: no kernel for device {z.device}")
    code = _dtype_code(z, "guidance_update")
    _require_device({"cond": cond, "uncond": uncond}, z.device)
    _require_aligned({"z": z, "cond": cond, "uncond": uncond}, align=1)  # vector loads
    if z.numel() == 0:                                                   # when aligned
        return torch.empty_like(z)
    lib = build.library("guidance_update")
    out = torch.empty_like(z)
    rc = lib.guidance_update_fwd(z.data_ptr(), cond.data_ptr(), uncond.data_ptr(),
                                 out.data_ptr(), z.numel(), float(w), float(dt), code,
                                 _stream(z.device))
    build.check("guidance_update", rc)
    guidance_update.launches += 1
    return out


guidance_update.launches = 0

WRAPPERS = {"flash_attention": flash_attention, "flash_attention_sm90": flash_attention_sm90,
            "flash_decode": flash_decode, "flash_attention_bwd": flash_attention_bwd,
            "flash_attention_bwd_sm90": flash_attention_bwd_sm90, "latent_blend": latent_blend,
            "int8_quantize": int8_quantize, "dequant_blend": dequant_blend,
            "mamba_ssd": mamba_ssd, "mamba_ssd_bwd": mamba_ssd_bwd,
            "mamba_ssd_wide": mamba_ssd_wide, "mamba_ssd_wide_bwd": mamba_ssd_wide_bwd,
            "flash_attention_bwd_f32": flash_attention_bwd_f32,
            "guidance_update": guidance_update}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
