#!/usr/bin/env python3
"""Where the wgmma flash kernel's time goes, on one GPU.

    python3 tools/flash_sm90_ablation.py

Builds copies of ``csrc/flash_attention_sm90.cu`` with one part taken
out, serves each in place of the kernel and times it (CUDA events, 20
calls after 3) against the kernel as it is, in turns (as is, each copy,
each copy in reverse order, as is), at the D-80 causal prefill (2, 4096,
32 x 80), the video self- (16, 3120, 12 x 128) and cross-attention
(16, 3120 x 512) and granite's training forward (2, 2048, 32 / 8 x 64,
causal, writing the log-sum-exp).  The copies compute wrong answers: they
are for timing only, and the kernel as it is is checked against its plain
version; ``stages5`` alone computes the right answer.

  no_exp         the softmax's exp2 left out (the multiply-add kept)
  no_pv          no O += P V product
  no_softmax     the online softmax left out (P = the raw scores)
  one_hot_tile   every listed tile read from keys 0 .. 127 (memory traffic
                 out of the way; the same products)
  stages5        a K/V ring of 5 stages, not 3 (D 64's tiles leave the room)

Prints one line per timing and writes chiprun_out/flash_sm90_ablation.json.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "flash_attention_sm90.cu"
ABLATIONS = {
    "no_exp": (SRC, "      s[4 * nb + j] = exp2_approx(fmaf(s[4 * nb + j], p.sl2, -ms0));\n"
                    "      s[4 * nb + 2 + j] = exp2_approx(fmaf(s[4 * nb + 2 + j], p.sl2, -ms1));",
               "      s[4 * nb + j] = fmaf(s[4 * nb + j], p.sl2, -ms0);\n"
               "      s[4 * nb + 2 + j] = fmaf(s[4 * nb + 2 + j], p.sl2, -ms1);"),
    "no_pv": (SRC, "    if constexpr (L::kTail == 0)\n"
                   "      wgmma_rs(o, pa[kk], desc(vs + kk * 2048, L::kKBox, 1024));\n"
                   "    else\n"
                   "      wgmma_rs(o, pa[kk], desc(vs + kk * 2048, L::kKBox, 1024),\n"
                   "               desc32(vs + L::kTileTail + kk * 512));", ""),
    "no_softmax": (SRC, "                                             float& corr1) {\n"
                        "  if (entry & 1) {",
                   "                                             float& corr1) {\n"
                   "  return;\n  if (entry & 1) {"),
    "one_hot_tile": (SRC, "key0 = (__ldg(live + i) >> 1) * kBN;", "key0 = 0;"),
    "stages5": (SRC, "static constexpr int kStages = 3;",
                "static constexpr int kStages = kD == 64 ? 5 : 3;"),
}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    build.build(("flash_attention_sm90",))
    tmp, built = cs.build_mutants("flash_sm90_ablation_", ABLATIONS,
                                  ("flash_common.cuh", SRC),
                                  {m: ("flash_attention_sm90",) for m in ABLATIONS})
    try:
        libs = {"as_is": build.library("flash_attention_sm90")}
        libs.update({m: build.load("flash_attention_sm90", sos["flash_attention_sm90"])
                     for m, sos in built.items()})
        cases = {"prefill_d80": cs.flash_inputs(2, 4096, 4096, 32, 32, 80, torch.bfloat16,
                                                causal=True),
                 "self_d128": cs.flash_inputs(16, 3120, 3120, 12, 12, 128, torch.bfloat16),
                 "cross_d128": cs.flash_inputs(16, 3120, 512, 12, 12, 128, torch.bfloat16),
                 "granite_d64": cs.flash_inputs(2, 2048, 2048, 32, 8, 64, torch.bfloat16,
                                                causal=True)}
        for name, (args, causal, window) in cases.items():
            q, k, v, qp, kp, _ = args
            out = ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window,
                                      kernel="flash_attention_sm90")
            err, share, ok = cs.flash_agrees(out, args, causal, window)
            cs.check(ok, f"{name}: the kernel as it is disagrees with its plain version")
        order = ["as_is", *ABLATIONS, *reversed(ABLATIONS), "as_is"]
        ms = {}
        for variant in order:
            with build.substituted("flash_attention_sm90", libs[variant]):
                for name, (args, causal, window) in cases.items():
                    q, k, v, qp, kp, _ = args
                    t = cs.time_ms(lambda: ops.flash_attention(
                        q, k, v, qp, kp, causal=causal, window=window,
                        kernel="flash_attention_sm90",
                        return_lse=name == "granite_d64"), 20, warmup=3)
                    ms.setdefault(variant, {}).setdefault(name, []).append(t)
                    print(f"variant={variant} case={name} ms={t:.4f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_sm90_ablation.json").write_text(
        json.dumps({"nvidia_smi": smi, "ms": ms}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
