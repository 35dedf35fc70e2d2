#!/usr/bin/env python3
"""The mamba_ssd kernel's design choices, timed on one GPU.

    python3 tools/mamba_ssd_variants.py

Builds copies of ``csrc/mamba_ssd.cu`` (and of ``csrc/ssd_common.cuh``,
its TF32 helpers) with one choice changed, serves
each in place of the kernel and times it (CUDA events, 20 calls after 3)
against the kernel as it is, in turns (as is, each copy, each copy in
reverse order, as is), at Zamba2-2.7B's prefill scan (x (2, 4096, 80,
64), n 64, chunk 64, f32), and holds each copy's output to the plain
version (its share of the ``5e-4 + 5e-4 |plain|`` limit).

  slice32         32-column work units (320 at the prefill), up to 3 a block
  one_unit        one unit a block (the B, C tiles and the Gram not shared;
                  blocks take units in turn, 2 resident on an SM)
  one_stage       no double buffer: each chunk's copies wait at its start
  one_pass_tf32   one TF32 product per product instead of 3xTF32 (out of
                  tolerance: for its time and its share of the limit)
  cvt_rna         each rounding to TF32 by the PTX cvt.rna.tf32.f32 (four
                  instructions in SASS) instead of the integer add and mask
  lo_unrounded    lo = v - hi handed to mma as it is (the tensor core reads
                  its top 19 bits: truncation instead of rounding)
  no_prep, no_state_update, no_output, no_cs, no_unit_barrier
                  the pre-pass (each chunk's Gram and decay scalars); the
                  state update; all of y; the C.S part of y; the barrier
                  between y and the state update, each left out (wrong: for
                  timing)

Prints one line per timing and writes chiprun_out/mamba_ssd_variants.json.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "mamba_ssd.cu"
HDR = "ssd_common.cuh"   # the TF32 helpers it shares with the backward
VARIANTS = {
    "slice32": (SRC, "constexpr int kSlice = 16;", "constexpr int kSlice = 32;"),
    "one_unit": (SRC, "constexpr int kMaxUnits = kSlice == 16 ? 5 : 3;",
                 "constexpr int kMaxUnits = 1;"),
    "one_stage": (SRC, "for (int st = 2; st >= 1", "for (int st = 1; st >= 1"),
    "one_pass_tf32": (HDR, "  mma(small, alo, bhi);\n  mma(small, ahi, blo);\n", ""),
    "cvt_rna": (HDR, "  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
                     "  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;\n",
                r'''  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float r = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
'''),
    "lo_unrounded": (HDR, "  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;\n",
                     "  lo = __float_as_uint(v - __uint_as_float(hi));\n"),
    "no_prep": (SRC, "  prep<<<dim3(nch, b), kPrepThreads, prep_smem, st>>>(prm);\n", ""),
    "no_state_update": (SRC, "        if (n0 >= N) break;", "        break;"),
    "no_output": (SRC, "      for (int rt = uw; rt < R; rt += 4) {",
                  "      for (int rt = uw; rt < 0; rt += 4) {"),
    "no_cs": (SRC, "          if (k0 < N) {", "          if (k0 < 0) {"),
    "no_unit_barrier": (SRC, "      unit_barrier(unit);  // every strip has read S\n", ""),
}
CORRECT = ("as_is", "slice32", "one_unit", "one_stage", "cvt_rna", "lo_unrounded")   # the others are for timing
SHAPE = (2, 4096, 80, 64, 64)   # b, s, h, p, n
CHUNK = 64


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("mamba_ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    smi = cs.nvidia_smi_line()
    print(build.build(("mamba_ssd",))["mamba_ssd"], flush=True)
    tmp, built = cs.build_mutants("mamba_ssd_variants_", VARIANTS, (SRC, HDR),
                                  {m: ("mamba_ssd",) for m in VARIANTS})
    result = {"nvidia_smi": smi, "shape": SHAPE, "chunk": CHUNK, "share_of_limit": {},
              "ms": {}}
    try:
        libs = {"as_is": build.library("mamba_ssd")}
        libs.update({m: build.load("mamba_ssd", sos["mamba_ssd"]) for m, sos in built.items()})
        args = cs.ssd_inputs(*SHAPE, seed=1)
        plain = ref.mamba_ssd_plain(*args, chunk=CHUNK)
        for variant, lib in libs.items():
            with build.substituted("mamba_ssd", lib):
                out = ops.mamba_ssd(*args, chunk=CHUNK)
            torch.cuda.synchronize()
            err, share, ok = cs.ssd_agrees(out, plain)
            result["share_of_limit"][variant] = share
            print(f"variant={variant} max_abs_err={err:.3e} share_of_limit={share:.4g}",
                  flush=True)
            if variant in CORRECT:
                cs.check(ok, f"{variant}: disagrees with the plain version")
        for variant in ["as_is", *VARIANTS, *reversed(VARIANTS), "as_is"]:
            with build.substituted("mamba_ssd", libs[variant]):
                t = cs.time_ms(lambda: ops.mamba_ssd(*args, chunk=CHUNK), 20, warmup=3)
            result["ms"].setdefault(variant, []).append(t)
            print(f"variant={variant} ms={t:.4f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mamba_ssd_variants.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
