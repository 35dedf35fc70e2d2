#!/usr/bin/env python3
"""Where mamba_ssd_wide's time goes, on one GPU.

    python3 tools/mamba_ssd_wide_parts.py [--earlier FILE]

Builds copies of ``csrc/mamba_ssd_wide.cu`` with one part of the scan (the
launch for p > 4) taken out (wrong results: for timing only), serves each
in place of the kernel and times it with CUDA events (REPS calls after
one) in turns (as is, each copy, each copy in reverse order, as is)
at xlstm-1.3b's prefill value scan, x (2, 4096, 4, 1024), g 4, n 1024,
chunk 128, f32.  The kernel as it is (and the earlier one, below) is also
timed at the other shapes of chip_smoke.py's ``mamba_ssd_wide_*`` cases:
the normaliser (p = 1, the narrow launch), a steep ragged g < h case, odd
tiles, p 30 at chunk 16, and the reduced xlstm-1.3b that the train CLI
trains (2 x 16 tokens, 2 heads, p = n = 128; with ``return_states``, as
under grad).

  no_prep             the first launch (the Gram and the decay scalars)
  no_copies           the cp.async copies of the raw tiles
  no_split            the split of the raw tiles into the hi / lo operands
  no_cs_products      the wgmma of C.S_in (the partials)
  no_update_products  the wgmma of the state update
  no_intra            the wgmma of the in-chunk term
  no_remote_reads     the reads of the cluster's partials (DSMEM)

(The cluster barriers stay in every copy: without them a block could
leave while another reads its shared memory.)

``--earlier FILE`` also times another source of the kernel built with
the earlier C interface (``mamba_ssd_wide_fwd`` without the states flag), e.g.
the parent's, unpacked under ``build/``, in the same turns at every shape.  Prints one
line per timing and writes chiprun_out/mamba_ssd_wide_parts.json.
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
SRC = "mamba_ssd_wide.cu"
VARIANTS = {
    "no_prep": (SRC, "  wide_prep<<<dim3(nch, b * g), 32 * (Q / 16), prep_smem(Q), st>>>(prm);\n",
                ""),
    "no_copies": (SRC, "  if (step >= p.nch * k.spc) return;\n"
                       "  const int tid = threadIdx.x, Q = p.Q, ch = step / k.spc, j =",
                  "  return;\n  const int tid = threadIdx.x, Q = p.Q, ch = step / k.spc, j ="),
    "no_split": (SRC, "    if (j < k.U1) {\n      if (k.nv > 0) split_c(",
                 "    if (false) {\n      if (k.nv > 0) split_c("),
    "no_cs_products": (SRC, "      float acc[16];\n      if (prod) {",
                       "      float acc[16] = {};\n      if (false) {"),
    "no_update_products": (SRC, "        if (prod) {\n          wgmma_ss128",
                           "        if (false) {\n          wgmma_ss128"),
    "no_intra": (SRC, "const bool intra = mine && k.cgrp == 0 && sl * kTS < k.i0 + k.qs;",
                 "const bool intra = false;"),
    "no_remote_reads": (SRC, "v[r] = r < nranks ? ld_cluster2(la, r) : make_float2(0.f, 0.f);",
                        "v[r] = make_float2(0.f, 0.f);"),
}
# name: (b, s, h, g, p, n), chunk, steep; the variants run at the first
SHAPES = {"value": ((2, 4096, 4, 4, 1024, 1024), 128, False),
          "normaliser": ((2, 4096, 4, 4, 1, 1024), 128, False),
          "ragged_steep_g2": ((1, 1000, 4, 2, 256, 256), 128, True),
          "odd_tiles": ((2, 300, 6, 3, 100, 48), 48, False),
          "p30_g1": ((1, 130, 2, 1, 30, 16), 16, True),
          "train_cli_reduced": ((2, 16, 2, 2, 128, 128), 128, False)}
# the shapes timed with return_states (the earlier kernel always wrote them)
STATES = {"train_cli_reduced"}
REPS = 5


def earlier_library(path: Path, tmp: Path):
    """``path`` built with the port's nvcc flags; returns a call with the
    wrapper's arguments (the earlier C interface: no states flag)."""
    import torch
    from repro_torch.kernels import build

    src = tmp / "earlier" / SRC
    src.parent.mkdir()
    shutil.copy(path, src)
    shutil.copy(path.with_name("ssd_common.cuh"), src.parent / "ssd_common.cuh")
    so = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {path} failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mamba_ssd_wide_fwd.argtypes, lib.mamba_ssd_wide_fwd.restype = [P] * 7 + [I] * 7 + [P], I
    lib.mamba_ssd_wide_scratch_bytes.argtypes = [I] * 7
    lib.mamba_ssd_wide_scratch_bytes.restype = ctypes.c_longlong

    def call(chunk, x, a, dt, B, C):
        b, s, h, p = x.shape
        g, n = B.shape[2:]
        y = torch.empty_like(x)
        scratch = torch.empty(lib.mamba_ssd_wide_scratch_bytes(b, s, h, g, p, n, chunk) // 4,
                              device=x.device)
        rc = lib.mamba_ssd_wide_fwd(*(t.data_ptr() for t in (x, a, dt, B, C, y, scratch)), b,
                                    s, h, g, p, n, chunk,
                                    torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier kernel failed ({rc})")
        return y
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", type=Path, default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("mamba_ssd_wide_parts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    smi = cs.nvidia_smi_line()
    print(build.build(("mamba_ssd_wide",))["mamba_ssd_wide"], flush=True)
    tmp, built = cs.build_mutants("mamba_ssd_wide_parts_", VARIANTS, (SRC, "ssd_common.cuh"),
                                  {m: ("mamba_ssd_wide",) for m in VARIANTS})
    result = {"nvidia_smi": smi, "shapes": SHAPES, "ms": {}}
    try:
        libs = {"as_is": build.library("mamba_ssd_wide")}
        libs.update({m: build.load("mamba_ssd_wide", sos["mamba_ssd_wide"])
                     for m, sos in built.items()})
        calls = {}
        for v, lib in libs.items():
            def run(chunk, args, states=False, lib=lib):
                with build.substituted("mamba_ssd_wide", lib):
                    return ops.mamba_ssd_wide(*args, chunk=chunk, return_states=states)
            calls[v] = run
        if opts.earlier is not None:
            with tempfile.TemporaryDirectory(prefix="wide_earlier_") as etmp:
                f = earlier_library(opts.earlier.resolve(), Path(etmp))
                calls["earlier"] = lambda chunk, args, states=False: f(chunk, *args)
                _time(result, calls, list(calls), cs)
        else:
            _time(result, calls, list(calls), cs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "mamba_ssd_wide_parts.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


def _time(result, calls, order, cs):
    """At each shape in turns: as is, the others, the others in reverse, as
    is (past the first shape only the kernel as is and the earlier one)."""
    for i, (shape, (dims, chunk, steep)) in enumerate(SHAPES.items()):
        args = cs.wide_inputs(*dims, seed=21, steep=steep)
        others = [v for v in order if v != "as_is" and (i == 0 or v == "earlier")]
        for v in ["as_is", *others, *reversed(others), "as_is"]:
            t = cs.time_ms(lambda: calls[v](chunk, args, shape in STATES), REPS)
            result["ms"].setdefault(shape, {}).setdefault(v, []).append(t)
            print(f"shape={shape} variant={v} ms={t:.4f}", flush=True)
        del args


if __name__ == "__main__":
    sys.exit(main())
