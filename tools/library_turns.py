#!/usr/bin/env python3
"""The flash kernels against PyTorch's ``scaled_dot_product_attention``,
timed in alternating turns on one GPU.

    python3 tools/library_turns.py [--turns N] [--events] [--cases A,B] [--earlier DIR]

One reading of a kernel and one of its library call, taken once each in
the same run, can differ by more than the gap between the two (the
card's clocks drift between readings).  This times each case in turns,
kernel and library call back to back, the order swapped every turn, N
times (default 8).  A turn is one call's device time, summed by
``torch.profiler`` over 20 calls (``chip_smoke.device_ms``): CUDA events
around a loop of calls also time the host, which sets the pace of calls
shorter than ~0.1 ms and added 4-13% of spread to the longer ones in a
first run of this tool.  ``--events`` times by CUDA events instead (the
mean of 20 calls after 3).  Per case it reports each side's median and
spread ((max - min) / median), the gap (library median / kernel median -
1) and a verdict: ``kernel ahead`` or ``kernel behind`` where the gap is
larger than both spreads, ``unresolved`` otherwise.

Cases: granite-3-2b's training attention (a microbatch of 2 x 2048
tokens, 32 / 8 x 64 heads, causal): the forward (the wgmma kernel, which
writes the log-sum-exp) against SDPA, and the backward (the wgmma + TMA
backward, fed that log-sum-exp) against the backward of SDPA's autograd
graph; Zamba2-2.7B's training attention's backward (a microbatch of 2 x
2048 tokens, 32 x 80 heads, causal; the same wgmma + TMA backward at D
80, fed the D-80 forward's log-sum-exp) against SDPA's autograd backward;
Zamba2-2.7B's prefill (2 x 4096 tokens, 32 x 80 heads, causal);
the video DiT's self- and cross-attention at B 16 (3120 tokens, 12 x 128
heads; 512 context tokens); a hybrid rank's (B 2, 3510 tokens) and a
K-2 survivor's (B 2, 5070 tokens) self-attention, and the rank's
cross-attention; Zamba2's decode step on a full cache (4 x 1 query, 4096
keys); and in f32 the train CLI's attention layer at a training length (2
x 2048 tokens, 4 x 32 heads, causal): the forward writing the
log-sum-exp and the backward fed it, against SDPA and its autograd
backward in f32 with TF32 off.  Each kernel is first held to its plain
version (``chip_smoke.flash_agrees``, ``chip_smoke.flash_bwd_agrees``).

``--cases`` keeps the cases whose names contain one of the given words.
``--earlier DIR`` builds DIR's ``flash_attention.cu`` and
``flash_attention_bwd_f32.cu`` (with the headers beside them, e.g. a
parent commit's ``csrc`` unpacked under ``build/``; the C interfaces
must be this checkout's) and times them as a third side, ``earlier``, in
the same turns, on the f32 cases.

Prints one line per case and writes
``chiprun_out/library_turns_<timer>.json`` (``device_ms`` or ``events``)
with nvidia-smi's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BF16_CASES = (   # name, (B, Sq, Skv, H, KV, D), causal
    ("granite_fwd_d64_causal", (2, 2048, 2048, 32, 8, 64), True),
    ("granite_bwd_d64_causal", (2, 2048, 2048, 32, 8, 64), True),
    ("zamba_bwd_d80_causal", (2, 2048, 2048, 32, 32, 80), True),
    ("prefill_d80_causal", (2, 4096, 4096, 32, 32, 80), True),
    ("self_b16_d128", (16, 3120, 3120, 12, 12, 128), False),
    ("cross_b16_d128", (16, 3120, 512, 12, 12, 128), False),
    ("rank_self_b2_3510", (2, 3510, 3510, 12, 12, 128), False),
    ("rank_cross_b2_3510", (2, 3510, 512, 12, 12, 128), False),
    ("survivor_self_b2_5070", (2, 5070, 5070, 12, 12, 128), False),
    ("decode_fullcache_d80", (4, 1, 4096, 32, 32, 80), False),
)
F32_CASES = (    # the train CLI's layer (the reduced configs: f32, head dim 32)
    ("f32_fwd_d32_causal", (2, 2048, 2048, 4, 4, 32), True),
    ("f32_bwd_d32_causal", (2, 2048, 2048, 4, 4, 32), True),
)
EARLIER_SOURCES = ("flash_attention", "flash_attention_bwd_f32")


def earlier_libraries(src: Path, tmp: Path) -> dict:
    """``EARLIER_SOURCES`` of ``src`` built with the port's nvcc flags, in
    parallel; returns {kernel: loaded library}."""
    import shutil
    import subprocess

    from repro_torch.kernels import build

    for f in src.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp / f.name)
    procs = {n: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                                  str(tmp / f"lib{n}.so"), str(tmp / f"{n}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in EARLIER_SOURCES}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of {src / n}.cu failed:\n{log[-3000:]}")
        libs[n] = build.load(n, tmp / f"lib{n}.so")
    return libs


def spread(xs):
    return (max(xs) - min(xs)) / statistics.median(xs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--events", action="store_true", help="time by CUDA events")
    ap.add_argument("--cases", default="", help="comma-separated words; keep matching cases")
    ap.add_argument("--earlier", default=None, help="a csrc directory to time beside (f32)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("library_turns: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    import contextlib
    import tempfile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    words = [w for w in args.cases.split(",") if w]
    cases = [(n, s, c, dt) for cases, dt in ((BF16_CASES, torch.bfloat16),
                                             (F32_CASES, torch.float32))
             for n, s, c in cases if not words or any(w in n for w in words)]
    build.build(("flash_attention_sm90", "flash_decode", "flash_attention_bwd_sm90",
                 "flash_attention", "flash_attention_bwd_f32"))
    tmp = tempfile.TemporaryDirectory()
    earlier = earlier_libraries(Path(args.earlier), Path(tmp.name)) if args.earlier else {}
    timer = "events" if args.events else "device_ms"
    report = {"nvidia_smi": smi, "turns": args.turns, "timer": timer, "earlier": args.earlier,
              "cases": {}}
    for name, shape, causal, dtype in cases:
        (q, k, v, qp, kp, _), causal, window = cs.flash_inputs(*shape, dtype, causal=causal)
        kernel = ops.flash_kernel(q.dtype, shape[5], shape[1])
        gqa = shape[3] != shape[4]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if "_bwd_" in name:
            kernel = ops.bwd_kernel(q.dtype, shape[5])
            dout = torch.randn_like(q)
            out, lse, grads = cs.flash_fwd_bwd(q, k, v, dout, qp, kp, causal, window, kernel)
            err, share, ok = cs.flash_bwd_agrees(grads, (q, k, v, out, dout, qp, kp), causal,
                                                 window)
            qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=gqa)
            do_t = dout.transpose(1, 2)
            sides = {"kernel": lambda: ops.flash_attention_bwd(
                         q, k, v, out, dout, lse, qp, kp, causal=causal, kernel=kernel),
                     "library": lambda: torch.autograd.grad(o, (qg, kg, vg), do_t,
                                                            retain_graph=True)}
            lib_name = kernel
        else:
            # granite's and the f32 forward write the log-sum-exp, as the training
            # step runs them
            lse = name.startswith(("granite", "f32"))
            lib_name = kernel
            out = ops.flash_attention(q, k, v, qp, kp, causal=causal, kernel=kernel)
            err, share, ok = cs.flash_agrees(out, (q, k, v, qp, kp, None), causal, window)
            sides = {"kernel": lambda: ops.flash_attention(q, k, v, qp, kp, causal=causal,
                                                           kernel=kernel, return_lse=lse),
                     "library": lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       is_causal=causal,
                                                                       enable_gqa=gqa)}
        cs.check(ok, f"{name}: {kernel} disagrees with its plain version (max abs err "
                     f"{err:.3e}, {share:.2f} of the limit)")
        order = ["kernel", "library"]
        if lib_name in earlier:
            order.append("earlier")
            sides["earlier"] = sides["kernel"]
        ms = {s: [] for s in order}
        for turn in range(args.turns):
            for side in order[turn % len(order):] + order[:turn % len(order)]:
                fn = sides[side]
                with (build.substituted(lib_name, earlier[lib_name]) if side == "earlier"
                      else contextlib.nullcontext()):
                    t = cs.time_ms(fn, 20, 3) if args.events else cs.device_ms(fn, 20)
                if t is not None:          # a short profiler window keeps no time
                    ms[side].append(t)
        cs.check(all(len(v) >= 2 for v in ms.values()), f"{name}: too few readings {ms}")
        med = {s: statistics.median(v) for s, v in ms.items()}
        spr = {s: spread(v) for s, v in ms.items()}
        gap = med["library"] / med["kernel"] - 1
        verdict = ("unresolved" if abs(gap) <= max(spr.values())
                   else "kernel ahead" if gap > 0 else "kernel behind")
        report["cases"][name] = {"shape": list(shape), "causal": causal, "kernel": kernel,
                                 "ms": ms, "median_ms": med, "spread": spr, "gap": gap,
                                 "verdict": verdict, "max_abs_err": err}
        print(f"case={name} kernel={kernel} kernel_ms={med['kernel']:.4f} "
              f"(spread {spr['kernel']:.3f}) sdpa_ms={med['library']:.4f} "
              f"(spread {spr['library']:.3f}) gap={gap:+.3f} verdict={verdict}"
              + (f" earlier_ms={med['earlier']:.4f} (spread {spr['earlier']:.3f})"
                 if "earlier" in med else ""), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"library_turns_{timer}.json").write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
