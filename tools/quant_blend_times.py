#!/usr/bin/env python3
"""int8_quantize, latent_blend, dequant_blend and the LM decode step's
flash attention timed on one GPU, at the chip smoke's shapes and at the
480p (vdm_5s) shapes, for one checkout's kernels.

    python3 tools/quant_blend_times.py [--src DIR] [--tag NAME] [--variants] [--crossover]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the same cases time another checkout's
kernels (say, the parent commit unpacked into a directory that
``.gitignore`` lists): run it once per tree in turns (parent, change,
change, parent) in one call to compare the two.  The wrappers'
signatures are the same in both.  Each case first holds the kernel to
its plain version (codes and scales, or the blend, bit for bit; the
decode flash within ``ref.flash_bf16_tolerance``), then times it by
``torch.profiler`` device time over 20 calls (``chip_smoke.device_ms``;
the 480p cases with a cold L2) and lists the device operations one call
runs (kernels and memsets).  The decode flash runs on whichever kernel
the tree's ``ops.flash_kernel`` picks for one bf16 query at head dim 80,
on Zamba2-2.7B's decode step (4 requests, 32 x 80 heads, 4096 slots, 63
valid) and on a full cache.

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

``--parts`` (this checkout only) builds copies of ``csrc/flash_decode.cu``
and ``csrc/dequant_blend.cu`` with one part taken out or one choice
changed and times them in turns against the kernels as they are:

  decode:no_tail      no fence, ticket or merge after the splits' partials
  decode:no_products  no Q.K^T, softmax or P.V (the loads stay)
  decode:no_kv_loads  no K or V copies (the products run on what the
                      stages hold)
  decode:skeleton     none of the three: positions, scan, partials
  decode:empty        the launch alone: every block returns at once
  dequant:loads4      4 codes a thread (4-byte loads) where 16 would do
  dequant:loads16     16 codes a thread wherever F and the wire allow,
                      however few the runs
  dequant:one_window  one covering window's load in flight at a time
  dequant:unstaged    each lane stores its own 16 quotients (4 or 2 strided
                      16-byte stores) instead of the warp's staged ones
  dequant:no_store    the quotients computed and staged, not stored
                      (decode:* and no_store wrong: for timing)

``--crossover`` (this checkout only) times ``flash_decode`` and the
``mma.sync`` kernel of ``flash_attention.cu`` in turns at 1-64 causal
queries a request against the decode step's cache (63 valid slots plus
the queries) and a full one: where the decode kernel stops being the
faster sets ``ops.DECODE_MAX_QUERIES``.

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
DQ, FD, HDR = "dequant_blend.cu", "flash_decode.cu", "flash_common.cuh"
PARTS = {
    "decode:no_tail": (FD, "\n  // the last split of (b, kv head)",
                       "\n  return;\n  // the last split of (b, kv head)"),
    "decode:empty": (FD, "  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;",
                     "  if (p.B > 0) return;\n"
                     "  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;"),
    "decode:no_products": (FD, "if (jw < n) {", "if (jw < 0) {"),
    # cp_async16 is flash_common.cuh's, shared with flash_attention*.cu
    "decode:no_kv_loads": (HDR, "  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16, %2;"
                                "\\n\"\n               ::\"r\"(smem_u32(dst)), \"l\"(src), "
                                "\"r\"(valid ? 16 : 0));",
                           "  (void)dst; (void)src; (void)valid;"),
    "dequant:loads4": (DQ, "if (F % 16 == 0 && a % 16 == 0 && o % 16 == 0 &&", "if (false &&"),
    "dequant:loads16": (DQ, "static_cast<long long>(E) * (F / 16) >= "
                            "static_cast<long long>(sms) * 8 * kThreads)", "true)"),
    "dequant:one_window": (DQ, "for (; c + 4 <= nc; c += 4)\n    sum_windows<L, 4>",
                           "for (; c + 1 <= nc; c += 1)\n    sum_windows<L, 1>"),
    "dequant:unstaged": (DQ, "    store_warp<Out>(orow, stage, acc, i, n_runs);",
                         "    for (int pc = 0; active && pc < 4 * (int)sizeof(Out) / 4; ++pc)\n"
                         "      __stcs(reinterpret_cast<uint4*>(orow) + i * (sizeof(Out)) + pc,"
                         " piece<Out>(acc, pc));"),
    "dequant:no_store": (DQ, "if (first + owner < n_runs) __stcs(",
                         "if (first + owner < 0) __stcs("),
}

LATENT_480P = (21, 60, 104)     # vdm_5s: 81 frames at 480p
# name, N, R, F, qmax, cold L2
QUANT = [("T_transfer", 4, 3, 49920, 127, False), ("T_cores", 4, 4, 49920, 127, False),
         ("H_cores", 4, 8, 21632, 127, False), ("T_transfer_int4", 4, 3, 49920, 7, False),
         ("T_cores_480p", 4, 6, 199680, 127, True)]
# name, latent, dim, cold L2 (2 requests, 16 channels, K 4, r 0.5)
BLEND = [("blend_dim0", (13, 30, 52), 0, False), ("blend_dim1", (13, 30, 52), 1, False),
         ("blend_dim2", (13, 30, 52), 2, False), ("blend_dim0_480p", LATENT_480P, 0, True)]
# name, latent, dim, cold L2 (2 requests, 16 channels, K 4, r 0.5; f32 out)
DEQUANT = [("dequant_blend_dim0", (13, 30, 52), 0, False),
           ("dequant_blend_dim1", (13, 30, 52), 1, False),
           ("dequant_blend_dim2", (13, 30, 52), 2, False),
           ("dequant_blend_dim0_480p", LATENT_480P, 0, True)]
# name, valid slots of the 4096 (Zamba2-2.7B's decode step: B 4, 32 x 80 heads)
DECODE = [("flash_lm_decode_bf16", 63), ("flash_lm_decode_fullcache_bf16", 4096)]
CROSSOVER_QUERIES = (1, 2, 4, 8, 12, 16, 24, 32, 64)
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


def dequant_inputs(latent, dim):
    from repro_torch.kernels import ref

    preds, weights, norm, starts, window, extent = blend_inputs(latent, dim)
    wire, scales = ref.int8_quantize_ref(preds, 127)
    return (wire, scales, weights, norm, starts, window, extent)


def decode_inputs(Sq, valid, seed=0):
    """q, k, v, positions (the kv_len mask folded in) of a decode step of
    4 requests with ``Sq`` causal queries at positions valid - Sq .. valid - 1."""
    import torch
    from repro_torch.kernels import ref

    B, Skv, H, D = 4, 4096, 32, 80
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((B, Sq, H, D), (B, Skv, H, D), (B, Skv, H, D)))
    qp = (torch.arange(Sq, device="cuda", dtype=torch.int32) + valid - Sq)[None].expand(B, Sq)
    kp = torch.arange(Skv, device="cuda", dtype=torch.int32)[None].expand(B, Skv).contiguous()
    kp = torch.where(kp < valid, kp, ref.INT32_MAX)
    return q, k, v, qp.contiguous(), kp


def decode_check(cs, out, q, k, v, qp, kp, what):
    import torch
    from repro_torch.kernels import ref

    plain = ref.flash_attention_ref(q, k, v, qp, kp, True, 0)
    limit = ref.flash_bf16_tolerance(q, k, v, qp, kp, True, 0, plain)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs()
    cs.check(bool((err <= limit).all()), f"{what}: kernel disagrees with plain "
                                         f"({float((err / limit).max()):.3g} of the limit)")


def time_parts(cs, build, ops, ref):
    """The ``PARTS`` copies, built outside the checkout, timed in turns with
    the kernels as they are (as is, each copy, each copy in reverse
    order, as is) on the decode step, the full cache and the smoke's and
    480p T dims; the right ones (loads4) are held to their plain version."""
    import torch

    mutants = dict(PARTS)
    skel = {f: (build.CSRC / f).read_text() for f in (FD, HDR)}
    for m in ("decode:no_tail", "decode:no_products", "decode:no_kv_loads"):
        f, old, new = PARTS[m]
        skel[f] = skel[f].replace(old, new)
    tmp, built = cs.build_mutants("redesign_parts_", mutants, (DQ, FD, HDR),
                                  {m: (m.split(":")[0].replace("decode", "flash_decode")
                                       .replace("dequant", "dequant_blend"),) for m in mutants})
    try:
        (tmp / "skeleton").mkdir()
        for f, text in skel.items():
            (tmp / "skeleton" / f).write_text(text)
        so = tmp / "skeleton" / "libflash_decode.so"
        proc = __import__("subprocess").run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(tmp / "skeleton" / FD)],
            capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"skeleton did not build: {proc.stdout[-2000:]}")
        built["decode:skeleton"] = {"flash_decode": so}
        libs = {lib: {"as_is": build.library(lib)} for lib in ("flash_decode", "dequant_blend")}
        for m, sos in built.items():
            (lib, path), = sos.items()
            libs[lib][m] = build.load(lib, path)
        cases = {"flash_decode": [(n, decode_inputs(1, valid)) for n, valid in DECODE],
                 "dequant_blend": [(n, dequant_inputs(lat, d), cold) for n, lat, d, cold in DEQUANT
                                   if d == 0]}
        out = {}
        for lib, by_variant in libs.items():
            order = [v for v in by_variant if v != "as_is"]
            for variant in ["as_is", *order, *reversed(order), "as_is"]:
                with build.substituted(lib, by_variant[variant]):
                    for case in cases[lib]:
                        if lib == "flash_decode":
                            name, (q, k, v, qp, kp) = case
                            run = lambda: ops.flash_attention(q, k, v, qp, kp, causal=True,
                                                              kernel="flash_decode")
                            cold = False
                        else:
                            name, args, cold = case
                            run = lambda: ops.dequant_blend(*args)
                            if variant != "dequant:no_store":
                                cs.check(torch.equal(run(), ref.dequant_blend_ref(*args)),
                                         f"{variant} {name}: differs from plain")
                        ms = cs.device_ms(run, REPS, cold_l2=cold)
                        out.setdefault(f"{lib}:{variant}", {}).setdefault(name, []).append(ms)
                        print(f"part={lib}:{variant} case={name} ms={cs.num(ms, '.5f')}", flush=True)
        return out
    finally:
        __import__("shutil").rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="as_is")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--parts", action="store_true")
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
    dec_kernel = ops.flash_kernel(torch.bfloat16, 80, 1)
    for name, rep in build.build(("int8_quantize", "latent_blend", "dequant_blend",
                                  dec_kernel)).items():
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
        print(f"tag={a.tag} case=quant_{name} ms={cs.num(ms, '.5f')} cold_l2={cold} device_ops={d_ops}",
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
        print(f"tag={a.tag} case={name} ms={cs.num(ms, '.5f')} cold_l2={cold} device_ops={d_ops}",
              flush=True)
        del args, out, plain
    for name, latent, dim, cold in DEQUANT:
        args = dequant_inputs(latent, dim)
        out = ops.dequant_blend(*args)
        plain = ref.dequant_blend_ref(*args)
        torch.cuda.synchronize()
        cs.check(torch.equal(out, plain), f"{a.tag} {name}: kernel differs from plain")
        d_ops = cs.device_ops(lambda: ops.dequant_blend(*args))
        ms = cs.device_ms(lambda: ops.dequant_blend(*args), REPS, cold_l2=cold)
        result["cases"][name] = {"ms": ms, "device_ops": d_ops, "cold_l2": cold}
        print(f"tag={a.tag} case={name} ms={cs.num(ms, '.5f')} cold_l2={cold} device_ops={d_ops}",
              flush=True)
        del args, out, plain
    for name, valid in DECODE:
        q, k, v, qp, kp = decode_inputs(1, valid)
        decode_check(cs, ops.flash_attention(q, k, v, qp, kp, causal=True), q, k, v, qp, kp,
                     f"{a.tag} {name}")
        d_ops = cs.device_ops(lambda: ops.flash_attention(q, k, v, qp, kp, causal=True))
        ms = cs.device_ms(lambda: ops.flash_attention(q, k, v, qp, kp, causal=True), REPS)
        result["cases"][name] = {"ms": ms, "kernel": dec_kernel, "device_ops": d_ops}
        print(f"tag={a.tag} case={name} kernel={dec_kernel} ms={cs.num(ms, '.5f')} device_ops={d_ops}",
              flush=True)
        del q, k, v
    if a.crossover:
        result["crossover"] = {}
        for valid in (63, 4096):
            for sq in CROSSOVER_QUERIES:
                q, k, v, qp, kp = decode_inputs(sq, min(valid + sq, 4096), seed=sq)
                for kern in ("flash_decode", "flash_attention", "flash_attention", "flash_decode"):
                    run = lambda: ops.flash_attention(q, k, v, qp, kp, causal=True, kernel=kern)
                    decode_check(cs, run(), q, k, v, qp, kp, f"crossover {kern} q={sq}")
                    ms = cs.device_ms(run, REPS)
                    result["crossover"].setdefault(f"valid{valid}_q{sq}", {}).setdefault(
                        kern, []).append(ms)
                    print(f"crossover valid={valid} queries={sq} kernel={kern} ms={cs.num(ms, '.5f')}",
                          flush=True)
                del q, k, v
    if a.parts:
        result["parts"] = time_parts(cs, build, ops, ref)
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
                        print(f"variant={variant} case=quant_{name} ms={cs.num(ms, '.5f')}", flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"quant_blend_times_{a.tag}.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
