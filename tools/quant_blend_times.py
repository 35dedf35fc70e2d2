#!/usr/bin/env python3
"""int8_quantize and latent_blend timed on one GPU, at the chip smoke's
shapes and at the 480p (vdm_5s) shapes, for one checkout's kernels.

    python3 tools/quant_blend_times.py [--src DIR] [--tag NAME] [--variants]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the same cases time another checkout's
kernels (say, the parent commit unpacked into a directory that
``.gitignore`` lists): run it once per tree in turns (parent, change,
change, parent) in one call to compare the two.  The wrappers'
signatures are the same in both.  Each case first holds the kernel to
its plain version (codes and scales, or the blend, bit for bit), then
times it by ``torch.profiler`` device time over 20 calls
(``chip_smoke.device_ms``; the 480p cases with a cold L2) and lists the
device operations one call runs (kernels and memsets).

``--variants`` (this checkout only) also builds copies of
``csrc/int8_quantize.cu`` with one choice changed and times them in
turns against the kernel as it is (as is, each copy, each copy in
reverse order, as is):

  reread        no shared-memory staging: the quantize pass reads x again
                (from L2) instead of keeping each block's share on chip
  float_to_int  each code by a float-to-int conversion of rintf's result
                instead of the exact add of 1.5 * 2^23
  zero_divided  zeros divided by the scale too (__fdiv_rn's slow path)
                instead of taken as their own quotient
  threads256, threads1024
                256 or 1024 threads a block instead of 512
  no_divide, no_arith, skeleton
                the division replaced by a product; all of the quantize
                arithmetic left out; no share at all (the launch, the grid
                barrier and the scales alone) (wrong: for timing)

Prints one line per case and writes chiprun_out/quant_blend_times_<tag>.json.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "int8_quantize.cu"
VARIANTS = {
    "reread": (SRC, "constexpr int kMaxStageBytes = 224 * 1024;",
               "constexpr int kMaxStageBytes = 0;"),
    "float_to_int": (SRC, "  return __float_as_uint(q + 12582912.0f);",
                     "  return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(q)));"),
    "threads256": (SRC, "constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
    "threads1024": (SRC, "constexpr int kThreads = 512;", "constexpr int kThreads = 1024;"),
    "zero_divided": (SRC, "v == 0.f && scale == scale ? v : __fdiv_rn(v, scale)",
                     "__fdiv_rn(v, scale)"),
    "no_divide": (SRC, "__fdiv_rn(v, scale)", "__fmul_rn(v, scale)"),
    "no_arith": (SRC, "float q = rintf(v == 0.f && scale == scale ? v : __fdiv_rn(v, scale));\n"
                      "  q = fminf(fmaxf(q, -qmax), qmax);", "float q = v;"),
    "skeleton": (SRC, "    const long long per = (nvec + P - 1) / P;",
                 "    const long long per = 0;"),
}
WRONG = ("no_divide", "no_arith", "skeleton")     # for timing only
LATENT_480P = (21, 60, 104)     # vdm_5s: 81 frames at 480p
# name, N, R, F, qmax, cold L2
QUANT = [("T_transfer", 4, 3, 49920, 127, False), ("T_cores", 4, 4, 49920, 127, False),
         ("H_cores", 4, 8, 21632, 127, False), ("T_transfer_int4", 4, 3, 49920, 7, False),
         ("T_cores_480p", 4, 6, 199680, 127, True)]
# name, latent, dim, cold L2 (2 requests, 16 channels, K 4, r 0.5)
BLEND = [("blend_dim0", (13, 30, 52), 0, False), ("blend_dim1", (13, 30, 52), 1, False),
         ("blend_dim2", (13, 30, 52), 2, False), ("blend_dim0_480p", LATENT_480P, 0, True)]
REPS = 20


def quant_inputs(N, R, F, qmax, seed=0):
    import torch
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, R, F), generator=g, device="cuda")
    x[0] *= 40.0
    x[1] = 0.0
    ref.plant_halfway_inputs(x[2], qmax)
    return x


def blend_inputs(latent, dim):
    import torch
    from repro_torch.core.spmd import BlendTables
    from repro_torch.core.uniform import plan_uniform

    plan = plan_uniform(latent[dim], (1, 2, 2)[dim], 4, 0.5, dim)
    F = 2 * math.prod(latent[d] for d in range(3) if d != dim) * 16
    g = torch.Generator(device="cuda").manual_seed(dim)
    preds = torch.randn((4, plan.window, F), generator=g, device="cuda")
    tables = BlendTables.build(plan, "cuda")
    return (preds, tables.weights, tables.normalizer, plan.starts, plan.window, plan.extent)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="as_is")
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(a.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("quant_blend_times: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    smi = cs.nvidia_smi_line()
    print(f"tag={a.tag} src={a.src} card=[{smi}]", flush=True)
    for name, rep in build.build(("int8_quantize", "latent_blend")).items():
        print(f"ptxas {name}: {rep}", flush=True)
    result = {"nvidia_smi": smi, "tag": a.tag, "src": a.src, "cases": {}}
    quant = {c[0]: (quant_inputs(*c[1:5]), c[4], c[5]) for c in QUANT}
    for name, (x, qmax, cold) in quant.items():
        wire, scales = ops.int8_quantize(x, qmax)
        pw, ps = ref.int8_quantize_ref(x, qmax)
        torch.cuda.synchronize()
        cs.check(torch.equal(wire, pw) and torch.equal(scales.view(torch.int32),
                                                       ps.view(torch.int32)),
                 f"{a.tag} quant_{name}: kernel differs from plain")
        d_ops = cs.device_ops(lambda: ops.int8_quantize(x, qmax))
        ms = cs.device_ms(lambda: ops.int8_quantize(x, qmax), REPS, cold_l2=cold)
        result["cases"][f"quant_{name}"] = {"ms": ms, "device_ops": d_ops, "cold_l2": cold}
        print(f"tag={a.tag} case=quant_{name} ms={ms:.5f} cold_l2={cold} device_ops={d_ops}",
              flush=True)
    for name, latent, dim, cold in BLEND:
        args = blend_inputs(latent, dim)
        out = ops.latent_blend(*args)
        plain = ref.latent_blend_ref(*args)
        torch.cuda.synchronize()
        cs.check(torch.equal(out, plain), f"{a.tag} {name}: kernel differs from plain")
        d_ops = cs.device_ops(lambda: ops.latent_blend(*args))
        ms = cs.device_ms(lambda: ops.latent_blend(*args), REPS, cold_l2=cold)
        result["cases"][name] = {"ms": ms, "device_ops": d_ops, "cold_l2": cold}
        print(f"tag={a.tag} case={name} ms={ms:.5f} cold_l2={cold} device_ops={d_ops}",
              flush=True)
        del args, out, plain
    if a.variants:
        tmp, built = cs.build_mutants("quant_variants_", VARIANTS, (SRC,),
                                      {m: ("int8_quantize",) for m in VARIANTS})
        try:
            libs = {"as_is": build.library("int8_quantize")}
            libs.update({m: build.load("int8_quantize", sos["int8_quantize"])
                         for m, sos in built.items()})
            result["variants"] = {}
            for variant in ["as_is", *VARIANTS, *reversed(VARIANTS), "as_is"]:
                with build.substituted("int8_quantize", libs[variant]):
                    for name, (x, qmax, cold) in quant.items():
                        wire, scales = ops.int8_quantize(x, qmax)
                        pw, ps = ref.int8_quantize_ref(x, qmax)
                        cs.check(variant in WRONG or (torch.equal(wire, pw)
                                                      and torch.equal(scales, ps)),
                                 f"variant {variant} quant_{name}: differs from plain")
                        ms = cs.device_ms(lambda: ops.int8_quantize(x, qmax), REPS,
                                          cold_l2=cold)
                        result["variants"].setdefault(variant, {}).setdefault(
                            f"quant_{name}", []).append(ms)
                        print(f"variant={variant} case=quant_{name} ms={ms:.5f}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"quant_blend_times_{a.tag}.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
