#!/usr/bin/env python3
"""Where mamba_ssd_wide_bwd's time goes, on one GPU, and the kernel against
an earlier source of it.

    python3 tools/mamba_ssd_wide_bwd_parts.py [--earlier FILE] [--no-variants]
        [--shapes value,steep_g2] [--variants-at value]

Builds copies of ``csrc/mamba_ssd_wide_bwd.cu`` with one part taken out
(wrong results: for timing only), serves each in place of the kernel and
times it with CUDA events (a shape's calls after one) in turns (as is, each
copy, each copy in reverse order, as is) at one shape (``--variants-at``,
by default xlstm-1.3b's training value scan, x (2, 2048, 4, 1024), g 4, n
1024, chunk 128, f32):

  no_prep              the first launch (the Gram and the decay scalars)
  no_qq                the second (M, dG, the scalars' sums, A2^T dy)
  no_qq_a2             qq's build of A2^T (split) in shared memory
  no_qq_intra          qq's products of A2^T dy
  no_sweep             the sweep (dS in reverse, B dS into dx)
  no_dbc               dB and dC
  no_sweep_copies      the sweep's cp.async copies of its raw tiles
  no_sweep_split       the sweep's split of the raw tiles into hi / lo
  no_unit_products     the sweep's wgmma of B dS (the partials)
  no_update_products   the sweep's wgmma of the update dy^T (ec C)
  no_ds_io             the sweep's write of dS and its read of the states
  no_ds_store          ... its write of dS only
  no_ds_load           ... its read of the states only
  no_remote_reads      the sweep's reads of the cluster's partials (DSMEM)
  no_dbc_copies        dbc's cp.async copies
  no_dbc_split         dbc's split
  no_dbc_products      dbc's wgmma

(The cluster barriers stay in every copy: without them a block could
leave while another reads its shared memory.)  ``--no-variants`` skips them.

The kernel as it is (and the earlier one, below) is timed in turns (as
is, earlier, earlier, as is) at the shapes of chip_smoke.py's
``mamba_ssd_wide_bwd_*`` cases: the value scan, the normaliser (p = 1: the
narrow launch) with dx and without it (as the normaliser's gradient runs,
its x being a constant), a steep ragged g < h case and the reduced
xlstm-1.3b that the train CLI trains (2 x 16 tokens, 2 heads, p = n = 128).

``--earlier FILE`` builds another source of the kernel with the earlier C
interface (``mamba_ssd_wide_bwd`` without the need_dx flag, which always
writes dx), e.g. the parent's, unpacked under ``build/``, with the headers
beside it.  Prints one line per timing and writes
chiprun_out/mamba_ssd_wide_bwd_parts.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "mamba_ssd_wide_bwd.cu"
HEADERS = ("ssd_common.cuh", "ssd_wgmma.cuh")
VARIANTS = {
    "no_prep": (SRC, "  mamba_ssd_wide_bwd_prep<<<dim3(nch, b * g), 32 * warps, prep_smem(Q), "
                     "st>>>(prm);\n", ""),
    "no_qq": (SRC, "  mamba_ssd_wide_bwd_qq<<<dim3(nch * (want_dx ? 2 : 1), h, b), 32 * warps,\n"
                   "                          qq_smem_floats(Q, want_dx) * 4, st>>>(prm);\n", ""),
    "no_qq_a2": (SRC, "for (int idx = tid; idx < Q * Q; idx += nthr) {  // (8 loads",
                 "for (int idx = tid; idx < 0; idx += nthr) {  // (8 loads"),
    "no_qq_intra": (SRC, "      for (int k0 = r0; k0 < Q; k0 += 8) {\n        const int ra",
                    "      for (int k0 = Q; k0 < Q; k0 += 8) {\n        const int ra"),
    "no_sweep": (SRC, "    e = launch_clusters(mamba_ssd_wide_bwd_sweep,",
                 "    if (false) e = launch_clusters(mamba_ssd_wide_bwd_sweep,"),
    "no_dbc": (SRC, "  dbc<<<dim3(2 * G.ntn, g, b * nch), kThreads, dbc_smem, st>>>(prm);\n", ""),
    "no_sweep_copies": (SRC, "  if (step >= p.nch * k.spc) return;\n  const int tid = threadIdx.x, "
                             "Q = p.Q, ch = chunk_of(p, k, step), j = step % k.spc;",
                        "  return;\n  const int tid = threadIdx.x, "
                        "Q = p.Q, ch = chunk_of(p, k, step), j = step % k.spc;"),
    "no_sweep_split": (SRC, "    if (j < k.U1) {\n      if (k.nv > 0 && live) split_b(",
                       "    if (false) {\n      if (k.nv > 0 && live) split_b("),
    "no_unit_products": (SRC, "      float acc[16];\n      if (prod && live) {",
                         "      float acc[16] = {};\n      if (false) {"),
    "no_update_products": (SRC, "          if (upd) {\n            wgmma_ss64",
                           "          if (false) {\n            wgmma_ss64"),
    "no_ds_io": (SRC, "const bool io = j < nio && live, overlap", "const bool io = false, overlap"),
    "no_ds_store": (SRC, "        *reinterpret_cast<float4*>(p.dS + o) = d;\n", ""),
    "no_ds_load": (SRC, "stv[q] = __ldg(reinterpret_cast<const float4*>(p.states + o));",
                   "stv[q] = make_float4(0.f, 0.f, 0.f, 0.f);"),
    "no_remote_reads": (SRC, "live && it < items && r < k.nranks ? ld_cluster4(la, r)",
                        "false ? ld_cluster4(la, r)"),
    "no_dbc_copies": (SRC, "  if (step >= k.nsteps) return;\n", "  return;\n"),
    "no_dbc_split": (SRC, "    dbc_split<NT>(e >= k.nE && k.kind == 1,",
                     "    if (false) dbc_split<NT>(e >= k.nE && k.kind == 1,"),
    "no_dbc_products": (SRC, "      if (on) {\n        wgmma_ss<NT>",
                        "      if (false) {\n        wgmma_ss<NT>"),
}
# name: (b, s, h, g, p, n), chunk, steep, need_dx, calls a reading (more where a
# call is short: a few calls of ~0.1 ms time the host's launches more than the card)
SHAPES = {"value": ((2, 2048, 4, 4, 1024, 1024), 128, False, True, 5),
          "normaliser": ((2, 2048, 4, 4, 1, 1024), 128, False, True, 5),
          "normaliser_no_dx": ((2, 2048, 4, 4, 1, 1024), 128, False, False, 5),
          "steep_g2": ((1, 1000, 4, 2, 256, 256), 128, True, True, 20),
          "train_cli_reduced": ((2, 16, 2, 2, 128, 128), 128, False, True, 20)}
# the launches of the six-launch kernel with the earlier C interface
EARLIER_PARTS = ("prep", "sweep", "qq", "dx", "dbc", "chain")


def earlier_library(path: Path, tmp: Path):
    """``path`` built with the port's nvcc flags; returns a call with the
    wrapper's arguments (the earlier C interface: no need_dx flag)."""
    import torch
    from repro_torch.kernels import build

    src = tmp / "earlier" / SRC
    src.parent.mkdir()
    shutil.copy(path, src)
    for header in path.parent.glob("*.cuh"):
        shutil.copy(header, src.parent / header.name)
    so = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {path} failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mamba_ssd_wide_bwd.argtypes, lib.mamba_ssd_wide_bwd.restype = [P] * 13 + [I] * 7 + [P], I
    lib.mamba_ssd_wide_bwd_scratch_bytes.argtypes = [I] * 7
    lib.mamba_ssd_wide_bwd_scratch_bytes.restype = ctypes.c_longlong

    def call(chunk, x, a, dt, B, C, dy, states):
        b, s, h, p = x.shape
        g, n = B.shape[2:]
        outs = [torch.empty_like(t) for t in (x, a, dt, B, C)]
        scratch = torch.empty(lib.mamba_ssd_wide_bwd_scratch_bytes(b, s, h, g, p, n, chunk) // 4,
                              device=x.device)
        rc = lib.mamba_ssd_wide_bwd(*(t.data_ptr() for t in (x, a, dt, B, C, dy, states)),
                                    *(o.data_ptr() for o in outs), scratch.data_ptr(), b, s, h,
                                    g, p, n, chunk, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier kernel failed ({rc})")
        return outs
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", type=Path, default=None)
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated names of SHAPES to time (default: all)")
    ap.add_argument("--variants-at", default="value",
                    help="the shape at which the copies with a part out are timed")
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("mamba_ssd_wide_bwd_parts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    build.build(("mamba_ssd_wide", "mamba_ssd_wide_bwd"))
    variants = {} if opts.no_variants else VARIANTS
    tmp, built = cs.build_mutants("mamba_ssd_wide_bwd_parts_", variants, (SRC, *HEADERS),
                                  {m: ("mamba_ssd_wide_bwd",) for m in variants})
    result = {"nvidia_smi": smi, "shapes": SHAPES, "ms": {}}
    try:
        libs = {"as_is": build.library("mamba_ssd_wide_bwd")}
        libs.update({m: build.load("mamba_ssd_wide_bwd", sos["mamba_ssd_wide_bwd"])
                     for m, sos in built.items()})
        calls = {}
        for v, lib in libs.items():
            def run(chunk, args, need_dx, lib=lib):
                with build.substituted("mamba_ssd_wide_bwd", lib):
                    return ops.mamba_ssd_wide_bwd(*args, chunk=chunk, need_dx=need_dx)
            calls[v] = run
        with tempfile.TemporaryDirectory(prefix="wide_bwd_earlier_") as etmp:
            if opts.earlier is not None:
                f = earlier_library(opts.earlier.resolve(), Path(etmp))
                calls["earlier"] = lambda chunk, args, need_dx: f(chunk, *args)
            _time(result, calls, cs, opts.shapes.split(","), opts.variants_at)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mamba_ssd_wide_bwd_parts.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


def _time(result, calls, cs, shapes, variants_at):
    """At each shape in turns: as is, the others, the others in reverse, as
    is (the copies with a part out at ``variants_at`` only; elsewhere the
    kernel as is and the earlier one)."""
    import torch
    from repro_torch.kernels import ops

    for shape in shapes:
        dims, chunk, steep, need_dx, reps = SHAPES[shape]
        b, s, h, g, p, n = dims
        x, a, dt, B, C = cs.wide_inputs(*dims, seed=21, steep=steep)
        dy = torch.randn((b, s, h, p), generator=torch.Generator(device="cuda").manual_seed(22),
                         device="cuda")
        _, states = ops.mamba_ssd_wide(x, a, dt, B, C, chunk=chunk, return_states=True)
        args = (x, a, dt, B, C, dy, states)
        others = [v for v in calls if v != "as_is" and (shape == variants_at or v == "earlier")]
        for v in ["as_is", *others, *reversed(others), "as_is"]:
            t = cs.time_ms(lambda: calls[v](chunk, args, need_dx), reps)
            result["ms"].setdefault(shape, {}).setdefault(v, []).append(t)
            print(f"shape={shape} variant={v} ms={t:.4f}", flush=True)
        # the launches' device times, by the profiler
        for v, names in (("as_is", cs.wide_bwd_parts(p, n)), ("earlier", EARLIER_PARTS)):
            if v in calls:
                parts = cs.profiled_parts(lambda: calls[v](chunk, args, need_dx),
                                          [f"mamba_ssd_wide_bwd_{x}" for x in names])
                parts = {x[len("mamba_ssd_wide_bwd_"):]: ms for x, ms in parts.items()}
                result.setdefault("parts_ms", {}).setdefault(shape, {})[v] = parts
                print(f"shape={shape} variant={v} parts_ms=" + ",".join(
                    f"{x}:{cs.num(ms)}" for x, ms in parts.items()), flush=True)
        del args, x, a, dt, B, C, dy, states


if __name__ == "__main__":
    sys.exit(main())
