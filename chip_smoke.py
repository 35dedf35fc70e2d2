#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, one line each (any failed check exits non-zero):
  1. device  — the card, the toolchain, the four kernels' build from csrc/.
  2. kernels — each hand-written kernel against its plain PyTorch version
               on the card at the serving path's shapes, with kernel,
               plain, library and bound times.
  3. serve   — LPServingEngine on the full-width wan21-dit-1.3b (bf16,
               random weights), K=4, r=0.5, 4 steps (dims T, H, W, T),
               3 requests at latent (13, 30, 52) in two batches; launch
               counters must show every DiT attention and every LP stitch
               going through the kernels.
  4. serve_codec — the same engine settings with wire_codec "int8" and
               "displaced:int8-residual" (the halo wire mirror), one
               2-request batch each: every wire quantize must go through
               int8_quantize (one launch per halo round and one for the
               cores, per step), none through latent_blend; PSNR of each
               request against the fp32 engine's latent.
  5. coded_stitch — blend_windows_coded(codec="int8") on the card at the
               three dims (int8_quantize + dequant_blend) against its
               plain version.
  6. quality — PSNR of request 0's LP latent against generate_centralized
               on the same noise and weights (printed, no threshold).
  7. check   — a 2-layer full-width DiT, LP-denoised on the card
               (kernels) and on the CPU (plain versions) from the same
               weights and noise, must agree; once uncoded, once through
               the int8-residual wire on a latent with one usable dim
               (the residual state is threaded over its 3 steps).
Then one JSON line of every kernel, the card's name and power limit, and
the result line.  Detailed numbers go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12        # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_BYTES_S = 3.35e12          # HBM3
# stated tolerances, |kernel - plain| <= atol + rtol * |plain| elementwise;
# bf16 flash is held to the bound of its two roundings instead,
# 2^-8 * attention(q, k, |v|) + 2^-7 * |plain| (kernels/ref.py:
# flash_bf16_tolerance), about 3e-3 + 8e-3 |plain| for N(0, 1) inputs
FLASH_F32_TOL = (1e-4, 1e-4)    # f32 throughout: summation order only
BLEND_TOL = (1e-6, 0.0)         # same f32 operations in the same order: expect 0
CODECS = ("int8", "displaced:int8-residual")    # phase serve_codec
LATENT = (13, 30, 52)           # 480p/4s-class latent, cut from (13, 60, 104) for time
K, R, STEPS = 4, 0.5, 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the time of every kernel it
    launches, summed by ``torch.profiler`` over ``reps`` calls.  For work
    shorter than the host's launch cost, where events around a loop of
    calls time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler shows no device time")
    return us / 1e3 / reps


def max_err(a, b, limit):
    """Max |a-b|, its largest share of ``limit`` (a number or an
    elementwise tensor), and whether every element is within it."""
    d = (a.float() - b.float()).abs()
    return float(d.max()), float((d / limit).max()), bool((d <= limit).all())


def sources_sha256() -> str:
    """One digest of the files this script runs: itself, the port's
    Python files and its CUDA sources, in path order."""
    files = [ROOT / "chip_smoke.py"] + sorted(
        f for f in (ROOT / "src" / "repro_torch").rglob("*")
        if f.suffix in (".py", ".cu") and "__pycache__" not in f.parts)
    h = hashlib.sha256()
    for f in files:
        h.update(str(f.relative_to(ROOT)).encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()


def attended_pairs(q_pos, kv_pos, causal, window) -> int:
    from repro_torch.kernels.ref import attention_mask

    return int(attention_mask(q_pos, kv_pos, causal, window).sum())


def flash_case(name, B, Sq, Skv, H, KV, D, dtype, causal=False, window=0,
               pad_kv=0, kv_len=False, reps=5, library=False, seed=0):
    """One flash kernel check: kernel vs plain on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=g, device="cuda").to(dtype)
    if causal or window:
        # global positions of an LP window: offset queries, keys before them
        qp = (torch.arange(Sq, device="cuda", dtype=torch.int32) + (Skv - Sq))[None]
        qp = qp.expand(B, Sq).contiguous()
    else:
        qp = torch.arange(Sq, device="cuda", dtype=torch.int32)[None].expand(B, Sq)
    kp = torch.arange(Skv, device="cuda", dtype=torch.int32)[None].expand(B, Skv).contiguous()
    if pad_kv:
        kp[:, -pad_kv:] = ref.INT32_MAX
    lens = None
    if kv_len:
        lens = torch.tensor([Skv - 7 * (b + 1) for b in range(B)], device="cuda",
                            dtype=torch.int32)
    kp_eff = kp if lens is None else torch.where(kp < lens[:, None], kp, ref.INT32_MAX)

    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window, kv_len=lens)
    torch.cuda.synchronize()
    plain = ref.flash_attention_ref(q, k, v, qp, kp_eff, causal, window)
    if dtype == torch.bfloat16:
        tol = "2^-8 attention(q,k,|v|) + 2^-7 |plain|"
        limit = ref.flash_bf16_tolerance(q, k, v, qp, kp_eff, causal, window, plain)
    else:
        tol = FLASH_F32_TOL
        limit = FLASH_F32_TOL[0] + FLASH_F32_TOL[1] * plain.float().abs()
    torch.cuda.synchronize()
    err, share, ok = max_err(out, plain, limit)
    del limit
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite kernel output")
    check(ok, f"{name}: kernel disagrees with plain version (max abs err {err:.3e}, "
              f"{share:.2f} of the limit {tol})")
    kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v, qp, kp, causal=causal,
                                                    window=window, kv_len=lens), reps)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kp_eff, causal, window),
                       max(1, reps // 5))
    ops.flash_attention.launches = before     # comparison launches do not count
    library_ms = None
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
    pairs = (B * Sq * Skv if not (causal or window or pad_kv or kv_len)
             else attended_pairs(qp, kp_eff, causal, window))
    flops = 4.0 * pairs * H * D
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size() \
        + (qp.numel() + kp.numel()) * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_S * 1e3
    return {
        "case": name, "shape": [B, Sq, Skv, H, KV, D], "dtype": str(dtype),
        "causal": causal, "window": window, "max_abs_err": err, "tol": tol,
        "err_share_of_limit": share, "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flops / kernel_ms / 1e9,
    }


def blend_case(dim: int, batch: int, channels: int, reps=20):
    """latent_blend vs plain on the serving path's (K, W, F) for ``dim``."""
    import torch
    from repro_torch.core.spmd import BlendTables
    from repro_torch.core.uniform import plan_uniform
    from repro_torch.kernels import ops, ref

    patch = (1, 2, 2)
    plan = plan_uniform(LATENT[dim], patch[dim], K, R, dim)
    rest = [batch] + [LATENT[d] for d in range(3) if d != dim] + [channels]
    F_ = int(math.prod(rest))
    g = torch.Generator(device="cuda").manual_seed(dim)
    preds = torch.randn((K, plan.window, F_), generator=g, device="cuda")
    tables = BlendTables.build(plan, "cuda")
    before = ops.latent_blend.launches
    out = ops.latent_blend(preds, tables.weights, tables.normalizer, plan.starts,
                           plan.window, plan.extent)
    plain = ref.latent_blend_ref(preds, tables.weights, tables.normalizer, plan.starts,
                                 plan.window, plan.extent)
    torch.cuda.synchronize()
    err, share, ok = max_err(out, plain, BLEND_TOL[0] + BLEND_TOL[1] * plain.abs())
    check(ok, f"latent_blend dim {dim}: kernel disagrees with plain version "
              f"(max abs err {err:.3e})")
    # ~10 us of work: device time, not events (they would time the wrapper)
    kernel_ms = device_ms(lambda: ops.latent_blend(preds, tables.weights, tables.normalizer,
                                                   plan.starts, plan.window, plan.extent),
                          reps)
    plain_ms = device_ms(lambda: ref.latent_blend_ref(preds, tables.weights,
                                                      tables.normalizer, plan.starts,
                                                      plan.window, plan.extent), reps)
    ops.latent_blend.launches = before
    nbytes = (preds.numel() + tables.weights.numel() + tables.normalizer.numel()
              + out.numel()) * 4
    flops = 2.0 * preds.numel() + out.numel()
    t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_S * 1e3
    return {
        "case": f"blend_dim{dim}", "K": K, "W": plan.window, "E": plan.extent, "F": F_,
        "max_abs_err": err, "tol": BLEND_TOL, "err_share_of_limit": share, "ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def quant_case(name: str, N: int, R: int, F: int, qmax: int = 127, reps=20, seed=0):
    """int8_quantize vs plain on N slabs (N, R, F): codes and scales bit-equal;
    slab 1 is all zero (scale 1e-20 / qmax), slab 2 carries half-way values
    (``ref.plant_halfway_inputs``).  Then a NaN in slab 0 must make its
    scale NaN (and its decoded message non-finite), no other slab's."""
    import torch
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, R, F), generator=g, device="cuda")
    x[0] *= 40.0
    x[1] = 0.0
    # values where dividing by the scale and multiplying by its reciprocal
    # give other codes: a kernel that does the latter fails here
    n_halfway = ref.plant_halfway_inputs(x[2], qmax)
    before = ops.int8_quantize.launches
    wire, scales = ops.int8_quantize(x, qmax)
    pw, ps = ref.int8_quantize_ref(x, qmax)
    torch.cuda.synchronize()
    codes_equal = bool(torch.equal(wire, pw))
    scales_equal = bool(torch.equal(scales.view(torch.int32), ps.view(torch.int32)))
    err = float((wire.float() * scales[:, None, None] - pw.float() * ps[:, None, None])
                .abs().max())
    check(codes_equal and scales_equal,
          f"int8_quantize {name}: kernel differs from plain (codes equal {codes_equal}, "
          f"scales equal {scales_equal}, max decoded err {err:.3e})")
    xn = x.clone()
    xn[0, 0, 5] = float("nan")
    nw, ns = ops.int8_quantize(xn, qmax)
    torch.cuda.synchronize()
    decoded = nw.float() * ns[:, None, None]
    check(torch.isnan(ns).tolist() == [n == 0 for n in range(N)],
          f"int8_quantize {name}: NaN slab scales {ns.tolist()}")
    check(not bool(torch.isfinite(decoded[0]).any()) and bool(torch.isfinite(decoded[1:]).all()),
          f"int8_quantize {name}: the NaN slab's decoded message is not all non-finite")
    # ~10 us of work: device time, not events
    kernel_ms = device_ms(lambda: ops.int8_quantize(x, qmax), reps)
    plain_ms = device_ms(lambda: ref.int8_quantize_ref(x, qmax), reps)
    ops.int8_quantize.launches = before     # comparison launches do not count
    nbytes = x.numel() * 4 + wire.numel() + N * 4
    flops = 5.0 * x.numel()                 # |x|, max, divide, round, clip
    t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_S * 1e3
    return {
        "case": f"quant_{name}", "shape": [N, R, F], "qmax": qmax, "max_abs_err": err,
        "halfway_values": n_halfway,
        "tol": "bit-equal codes and scales", "err_share_of_limit": 0.0,
        "nan_slab_scale_nan": True, "ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def dequant_case(dim: int, batch: int, channels: int, reps=20):
    """dequant_blend vs plain on the serving path's (K, W, F) for ``dim``."""
    import torch
    from repro_torch.core.spmd import BlendTables
    from repro_torch.core.uniform import plan_uniform
    from repro_torch.kernels import ops, ref

    patch = (1, 2, 2)
    plan = plan_uniform(LATENT[dim], patch[dim], K, R, dim)
    rest = [batch] + [LATENT[d] for d in range(3) if d != dim] + [channels]
    F_ = int(math.prod(rest))
    g = torch.Generator(device="cuda").manual_seed(10 + dim)
    preds = torch.randn((K, plan.window, F_), generator=g, device="cuda")
    wire, scales = ref.int8_quantize_ref(preds, 127)
    tables = BlendTables.build(plan, "cuda")
    args = (wire, scales, tables.weights, tables.normalizer, plan.starts, plan.window,
            plan.extent)
    before = ops.dequant_blend.launches
    out = ops.dequant_blend(*args)
    plain = ref.dequant_blend_ref(*args)
    out16 = ops.dequant_blend(*args, out_dtype=torch.bfloat16)
    plain16 = ref.dequant_blend_ref(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    err, share, ok = max_err(out, plain, BLEND_TOL[0] + BLEND_TOL[1] * plain.abs())
    check(ok and bool(torch.equal(out16, plain16)),
          f"dequant_blend dim {dim}: kernel disagrees with plain version (max abs err "
          f"{err:.3e}, bf16 equal {bool(torch.equal(out16, plain16))})")
    kernel_ms = device_ms(lambda: ops.dequant_blend(*args), reps)
    plain_ms = device_ms(lambda: ref.dequant_blend_ref(*args), reps)
    ops.dequant_blend.launches = before
    nbytes = (wire.numel() + (scales.numel() + tables.weights.numel()
                              + tables.normalizer.numel() + out.numel()) * 4)
    flops = 3.0 * wire.numel() + out.numel()
    t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_S * 1e3
    return {
        "case": f"dequant_blend_dim{dim}", "K": K, "W": plan.window, "E": plan.extent,
        "F": F_, "max_abs_err": err, "tol": BLEND_TOL, "err_share_of_limit": share,
        "bf16_equal": True, "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def expected_quantize_launches(cfg) -> int:
    """int8_quantize launches of one coded denoise at the smoke's geometry:
    per step one for each halo transfer round (its K slabs in one call)
    and one for the K cores."""
    from repro_torch.core.schedule import rotation_dim, usable_dims
    from repro_torch.core.uniform import plan_uniform
    from repro_torch.distributed.collectives import halo_spec

    dims = usable_dims(LATENT, cfg.patch_sizes, K)
    n = 0
    for i in range(1, STEPS + 1):
        d = rotation_dim(i, dims)
        n += len(halo_spec(plan_uniform(LATENT[d], cfg.patch_sizes[d], K, R, d)).transfers) + 1
    return n


def psnr_db(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    mse = float(((a - b) ** 2).mean())
    peak = float(b.abs().max())
    return 10 * math.log10(peak ** 2 / max(mse, 1e-12))


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port is not next to this script ({ROOT}/src/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import LPStepCompiler, lp_denoise
    from repro_torch.core.spmd import BlendTables, blend_windows_coded
    from repro_torch.core.uniform import plan_uniform
    from repro_torch.device import generator
    from repro_torch.diffusion import FlowMatchEuler, generate_centralized, generate_lp
    from repro_torch.diffusion.pipeline import make_guided_denoiser, make_guided_step_denoiser
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import dit, frontends
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import LPServingEngine, VideoRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {}
    smi = nvidia_smi_line()

    # ------------------------------------------------------------ 1. device
    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    digest = sources_sha256()
    record["device"] = {
        "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "build_s": build_s, "ptxas": reports,
        "sources_sha256": digest,
    }
    print(f"phase=device card=[{smi}] torch={torch.__version__} cuda={torch.version.cuda} "
          f"kernels={len(reports)} build_s={build_s:.1f} sources_sha256={digest}", flush=True)
    check(sorted(reports) == sorted(build.KERNELS), f"built {sorted(reports)}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split('ptxas info    :')[-1].strip()}")

    # ----------------------------------------------------------- 2. kernels
    cfg = get_config("wan21-dit-1.3b")
    H, D = cfg.num_heads, cfg.head_dim
    batch2 = 2 * K * 2                        # CFG x K windows x 2 requests
    pt, ph, pw = cfg.patch_sizes
    t_window = (plan_uniform(LATENT[0], pt, K, R, 0).window // pt
                * (LATENT[1] // ph) * (LATENT[2] // pw))     # tokens of a T window
    flash = [
        flash_case("flash_self_Twindow_bf16", batch2, t_window, t_window, H, H, D,
                   torch.bfloat16, library=True),
        flash_case("flash_cross_bf16", batch2, t_window, cfg.context_len, H, H, D,
                   torch.bfloat16, library=True),
        flash_case("flash_masked_gqa_bf16", 2, 200, 333, 8, 2, 64, torch.bfloat16,
                   causal=True, window=96, pad_kv=5, kv_len=True, reps=3),
        # the serving head dim through the masked path and a 13-key last tile
        flash_case("flash_masked_gqa_bf16_d128", 2, 200, 333, 12, 4, 128, torch.bfloat16,
                   causal=True, window=96, pad_kv=5, kv_len=True, reps=3),
        flash_case("flash_masked_gqa_f32", 2, 200, 333, 8, 2, 64, torch.float32,
                   causal=True, window=96, pad_kv=5, kv_len=True, reps=3),
        flash_case("flash_self_f32_d128", 2, 300, 300, 4, 4, 128, torch.float32, reps=3),
    ]
    blend = [blend_case(d, 2, cfg.latent_channels) for d in range(3)]
    quant = [quant_case("T_transfer", 4, 3, 49920), quant_case("T_cores", 4, 4, 49920),
             quant_case("H_cores", 4, 8, 21632), quant_case("T_transfer_int4", 4, 3, 49920, 7)]
    dequant = [dequant_case(d, 2, cfg.latent_channels) for d in range(3)]
    record["kernels"] = flash + blend + quant + dequant
    for c in flash + blend + quant + dequant:
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        print(f"phase=kernels case={c['case']} max_abs_err={c['max_abs_err']:.3e} "
              f"share_of_limit={c['err_share_of_limit']:.3f} kernel_ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']})", flush=True)

    # ------------------------------------------------------------- 3. serve
    model = dit.init_params(cfg, generator(0, "cuda"), "cuda")
    eng = LPServingEngine(model, cfg, num_partitions=K, overlap_ratio=R,
                          num_steps=STEPS, max_batch=2, device="cuda")
    reqs = [VideoRequest(i, frontends.text_context(generator(100 + i, "cuda"), 1, cfg,
                                                   "cuda"),
                         LATENT, seed=i, guidance=g)
            for i, g in enumerate((5.0, 5.0, 6.0))]
    for r in reqs:
        eng.submit(r)
    results, batches = [], []
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    for b in range(2):
        before, misses0 = ops.launch_counts(), eng._compiler.compiles
        out = eng.run(max_batches=1)
        after = ops.launch_counts()
        launches = {n: after[n] - before[n] for n in after}
        misses = eng._compiler.compiles - misses0
        res0 = out[0]
        batches.append({"size": res0.batch_size, "wall_s": res0.batch_wall_s,
                        "step_s": res0.batch_wall_s / STEPS, "launches": launches,
                        "guidance": reqs[res0.request_id].guidance,
                        "step_cache_misses": misses})
        check(misses <= 3, f"batch {b}: {misses} step-cache misses in one denoise")
        check(launches["flash_attention"] == 2 * cfg.num_layers * STEPS,
              f"batch {b}: {launches['flash_attention']} flash launches, expected "
              f"{2 * cfg.num_layers * STEPS}")
        check(launches["latent_blend"] == STEPS,
              f"batch {b}: {launches['latent_blend']} blend launches, expected {STEPS}")
        results += out
    main_counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(sorted(r.request_id for r in results) == [0, 1, 2], "not every request answered")
    for r in results:
        check(tuple(r.latent.shape) == (1, *LATENT, cfg.latent_channels),
              f"request {r.request_id}: latent shape {tuple(r.latent.shape)}")
        check(bool(torch.isfinite(r.latent).all()), f"request {r.request_id}: non-finite")
    record["serve"] = {"latent": LATENT, "K": K, "r": R, "steps": STEPS,
                       "batches": batches, "peak_gb": peak_gb,
                       "launches": main_counts, "lp_impl": eng.lp_impl}
    for i, b in enumerate(batches):
        print(f"phase=serve batch={i} size={b['size']} guidance={b['guidance']} "
              f"wall_s={b['wall_s']:.3f} step_s={b['step_s']:.3f} "
              f"flash_launches={b['launches']['flash_attention']} "
              f"blend_launches={b['launches']['latent_blend']} "
              f"step_cache_misses={b['step_cache_misses']}", flush=True)
    print(f"phase=serve requests=3 peak_mem_gb={peak_gb:.2f} lp_impl={eng.lp_impl}",
          flush=True)

    # where a warm 2-request batch spends its time: once plain, once traced
    # (after the counted run, so these launches are not in its counts)
    warm = []
    for traced in (False, True):
        for i in (0, 1):
            eng.submit(dataclasses.replace(reqs[i], request_id=10 + i))
        if traced:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = eng.run(max_batches=1)
        else:
            out = eng.run(max_batches=1)
        warm.append(out[0].batch_wall_s)
    split = {"flash_attention": 0.0, "latent_blend": 0.0, "matmul": 0.0, "other": 0.0}
    other = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key
        if "flash_fwd" in name:
            split["flash_attention"] += us
        elif "latent_blend" in name:
            split["latent_blend"] += us
        elif any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass")):
            split["matmul"] += us
        else:
            split["other"] += us
            other[name[:80]] = other.get(name[:80], 0.0) + us
    device_s = sum(split.values()) / 1e6
    check(device_s > 0, "the traced batch shows no device time")
    record["profile"] = {"warm_wall_s": warm[0], "traced_wall_s": warm[1],
                         "device_s": device_s, "split_s": {k: v / 1e6 for k, v in split.items()},
                         "top_other_s": dict(sorted(((k, v / 1e6) for k, v in other.items()),
                                                    key=lambda kv: -kv[1])[:8])}
    shares = " ".join(f"{k}={v / 1e6 / device_s:.3f}" for k, v in split.items())
    print(f"phase=serve warm_batch2_wall_s={warm[0]:.3f} step_s={warm[0] / STEPS:.3f} "
          f"traced_wall_s={warm[1]:.3f} device_busy={device_s / warm[1]:.3f} "
          f"device_share: {shares}", flush=True)

    # ------------------------------------------------------- 4. serve_codec
    fp32_latent = {r.request_id: r.latent for r in results if r.request_id in (0, 1)}
    want_quant = expected_quantize_launches(cfg)
    coded, coded_counts = [], {}
    for codec in CODECS:
        ceng = LPServingEngine(model, cfg, num_partitions=K, overlap_ratio=R,
                               num_steps=STEPS, max_batch=2, device="cuda", wire_codec=codec)
        for i in (0, 1):
            ceng.submit(reqs[i])
        ops.reset_launch_counts()
        out = ceng.run(max_batches=1)
        counts = ops.launch_counts()
        coded_counts[codec] = counts
        check(counts["flash_attention"] == 2 * cfg.num_layers * STEPS,
              f"{codec}: {counts['flash_attention']} flash launches, expected "
              f"{2 * cfg.num_layers * STEPS}")
        check(counts["int8_quantize"] == want_quant,
              f"{codec}: {counts['int8_quantize']} int8_quantize launches, expected {want_quant}")
        check(counts["latent_blend"] == 0 and counts["dequant_blend"] == 0,
              f"{codec}: the wire mirror stitched through a blend kernel ({counts})")
        psnr = {}
        for r in out:
            check(tuple(r.latent.shape) == (1, *LATENT, cfg.latent_channels),
                  f"{codec} request {r.request_id}: latent shape {tuple(r.latent.shape)}")
            check(bool(torch.isfinite(r.latent).all()), f"{codec} request {r.request_id}: "
                                                         "non-finite")
            psnr[r.request_id] = psnr_db(r.latent, fp32_latent[r.request_id])
        # a warm batch of the same two requests, then one traced
        walls = []
        for traced in (False, True):
            for i in (0, 1):
                ceng.submit(dataclasses.replace(reqs[i], request_id=20 + i))
            if traced:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA]) as cprof:
                    res = ceng.run(max_batches=1)
            else:
                res = ceng.run(max_batches=1)
            walls.append(res[0].batch_wall_s)
        quant_us = sum(e.self_device_time_total for e in cprof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and ("amax_kernel" in e.key or "quantize_kernel" in e.key))
        dev_us = sum(e.self_device_time_total for e in cprof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        coded.append({"codec": codec, "cold_wall_s": out[0].batch_wall_s,
                      "warm_wall_s": walls[0], "step_s": walls[0] / STEPS,
                      "traced_wall_s": walls[1], "device_s": dev_us / 1e6,
                      "int8_quantize_device_s": quant_us / 1e6,
                      "step_vs_fp32": walls[0] / warm[0],
                      "launches": counts, "psnr_vs_fp32_db": psnr,
                      "state_inits": ceng._compiler.state_inits, "lp_impl": ceng.lp_impl})
        c = coded[-1]
        print(f"phase=serve_codec codec={codec} lp_impl={ceng.lp_impl} "
              f"cold_wall_s={c['cold_wall_s']:.3f} warm_wall_s={c['warm_wall_s']:.3f} "
              f"step_s={c['step_s']:.3f} step_vs_fp32={c['step_vs_fp32']:.3f} "
              f"flash_launches={counts['flash_attention']} "
              f"int8_quantize_launches={counts['int8_quantize']} (expected {want_quant}) "
              f"blend_launches={counts['latent_blend']} "
              f"quantize_device_share={quant_us / max(dev_us, 1e-9):.4f} "
              + " ".join(f"psnr_vs_fp32_req{k}_db={v:.2f}" for k, v in sorted(psnr.items())),
              flush=True)
        del ceng
    record["serve_codec"] = {"expected_int8_quantize": want_quant, "fp32_warm_wall_s": warm[0],
                             "runs": coded}

    # ------------------------------------------------------ 5. coded_stitch
    stitch = []
    ops.reset_launch_counts()
    stitch_inputs = []
    for d in range(3):
        plan = plan_uniform(LATENT[d], cfg.patch_sizes[d], K, R, d)
        shape = [2, *LATENT, cfg.latent_channels]
        shape[d + 1] = plan.window
        g = torch.Generator(device="cuda").manual_seed(20 + d)
        preds = torch.randn([K] + shape, generator=g, device="cuda")
        stitch_inputs.append((plan, preds, blend_windows_coded(preds, plan, d + 1, codec="int8")))
    stitch_counts = ops.launch_counts()
    check(stitch_counts["int8_quantize"] == 3 and stitch_counts["dequant_blend"] == 3,
          f"coded_stitch launches {stitch_counts}")
    for d, (plan, preds, out) in enumerate(stitch_inputs):
        p = torch.movedim(preds, d + 2, 1)                  # (K, W, rest...)
        rest = tuple(p.shape[2:])
        wire, scales = ref.int8_quantize_ref(p.reshape(K, plan.window, -1).contiguous(), 127)
        tables = BlendTables.build(plan, "cuda")
        plain = ref.dequant_blend_ref(wire, scales, tables.weights, tables.normalizer,
                                      plan.starts, plan.window, plan.extent)
        plain = torch.movedim(plain.reshape((plan.extent,) + rest), 0, d + 1)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        check(bool(torch.equal(out, plain)),
              f"coded_stitch dim {d}: kernels differ from the plain versions ({err:.3e})")
        before = ops.launch_counts()
        ms = device_ms(lambda: blend_windows_coded(preds, plan, d + 1, codec="int8"), 10)
        for n, v in before.items():
            getattr(ops, n).launches = v
        stitch.append({"dim": d, "max_abs_err": err, "ms": ms})
        print(f"phase=coded_stitch dim={d} max_abs_err={err:.3e} device_ms={ms:.4f} "
              f"int8_quantize_launches=1 dequant_blend_launches=1", flush=True)
    record["coded_stitch"] = {"cases": stitch, "launches": stitch_counts}

    # ----------------------------------------------------------- 6. quality
    r0 = next(r for r in results if r.request_id == 0)
    z_T = engine_mod.initial_noise((1, *LATENT, cfg.latent_channels), 0,
                                   torch.device("cuda"))
    den = make_guided_denoiser(model, reqs[0].context, torch.zeros_like(reqs[0].context),
                               guidance=5.0)
    t0 = time.perf_counter()
    z_c = generate_centralized(den, z_T, STEPS, FlowMatchEuler(STEPS))
    torch.cuda.synchronize()
    central_s = time.perf_counter() - t0
    check(bool(torch.isfinite(z_c).all()), "centralized output non-finite")
    psnr = psnr_db(r0.latent, z_c)
    record["quality"] = {"psnr_lp_vs_centralized_db": psnr, "centralized_s": central_s}
    print(f"phase=quality psnr_lp_vs_centralized_db={psnr:.2f} "
          f"centralized_s={central_s:.3f}", flush=True)
    del model, eng, results, z_c
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- 5. check
    small_cfg = dataclasses.replace(cfg, num_layers=2)
    small = dit.init_params(small_cfg, generator(1, "cuda"), "cuda")
    small_cpu = copy.deepcopy(small).to("cpu")
    g = torch.Generator().manual_seed(2)
    z_small = torch.randn((1, 4, 8, 12, cfg.latent_channels), generator=g)
    ctx = torch.randn((1, cfg.context_len, cfg.context_dim), generator=g) * 0.02
    outs = []
    for m, dev in ((small, "cuda"), (small_cpu, "cpu")):
        den = make_guided_denoiser(m, ctx.to(dev), torch.zeros_like(ctx).to(dev), 5.0)
        outs.append(generate_lp(den, z_small.to(dev), 2, 2, 0.5, cfg.patch_sizes,
                                uniform=True).cpu())
    rel = float((outs[0] - outs[1]).norm() / outs[1].norm())
    print(f"phase=check small_lp rel_l2_cuda_vs_cpu={rel:.3e} (limit 5e-2)", flush=True)
    check(rel < 5e-2, f"2-layer LP on the card disagrees with the CPU ({rel:.3e})")
    # the same through the int8-residual wire: int8_quantize on the card,
    # its plain version on the CPU; the limit is the uncoded one (a code
    # flipped by the bf16 DiTs' differences moves a value by one step).
    # Only T is usable on this latent, so the 3 steps are one run and the
    # residual state is threaded across them.
    z_coded = torch.randn((1, 8, 2, 2, cfg.latent_channels), generator=g)
    coded_outs, inits = [], []
    for m, dev in ((small, "cuda"), (small_cpu, "cpu")):
        sampler = FlowMatchEuler(3)
        comp = LPStepCompiler(make_guided_step_denoiser(m), sampler.update, 2, 0.5,
                              cfg.patch_sizes, uniform=True, codec="int8-residual",
                              nan_guard=True)
        q0 = ops.int8_quantize.launches
        coded_outs.append(lp_denoise(None, z_coded.to(dev), sampler, 3, 2, 0.5,
                                     cfg.patch_sizes, (1, 2, 3), uniform=True,
                                     extras=(ctx.to(dev), torch.zeros_like(ctx).to(dev), 5.0),
                                     compiler=comp).cpu())
        inits.append((comp.state_inits, ops.int8_quantize.launches - q0))
    rel_coded = float((coded_outs[0] - coded_outs[1]).norm() / coded_outs[1].norm())
    print(f"phase=check small_lp_int8_residual rel_l2_cuda_vs_cpu={rel_coded:.3e} "
          f"(limit 5e-2) card_quantize_launches={inits[0][1]} state_inits={inits[0][0]}",
          flush=True)
    check(inits[0][1] > 0 and inits[1][1] == 0 and inits[0][0] == inits[1][0] == 1,
          f"int8-residual check: (state_inits, launches) card {inits[0]}, CPU {inits[1]}")
    check(bool(torch.isfinite(coded_outs[0]).all()) and rel_coded < 5e-2,
          f"2-layer coded LP on the card disagrees with the CPU ({rel_coded:.3e})")
    record["check"] = {"rel_l2_cuda_vs_cpu": rel, "int8_residual_rel_l2_cuda_vs_cpu": rel_coded}

    # ------------------------------------------------------------- results
    def kernel_row(name, source, replaces, case, launches):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": case["max_abs_err"],
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    # launches: each kernel's count from the run of the path it serves, set to
    # 0 just before and read just after (serve; serve_codec; coded_stitch)
    line = {"kernels": [
        kernel_row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:101", flash[0],
                   main_counts["flash_attention"]),
        kernel_row("latent_blend", "src/repro_torch/kernels/csrc/latent_blend.cu",
                   "src/repro/kernels/latent_blend.py:63", blend[0],
                   main_counts["latent_blend"]),
        kernel_row("int8_quantize", "src/repro_torch/kernels/csrc/int8_quantize.cu",
                   "src/repro/kernels/wire_codec.py:64", quant[0],
                   sum(c["int8_quantize"] for c in coded_counts.values())),
        kernel_row("dequant_blend", "src/repro_torch/kernels/csrc/dequant_blend.cu",
                   "src/repro/kernels/wire_codec.py:131", dequant[0],
                   stitch_counts["dequant_blend"]),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
