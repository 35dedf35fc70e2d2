"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/kernels/`` at
the root of the checkout.  The file name carries a hash of the source,
of the shared headers (``csrc/*.cuh``) and of the flags, so an edited
source is never served a stale library.
Several sources build in parallel: one ``nvcc`` process each, all
started together.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "flash_attention_sm90", "flash_decode", "flash_attention_bwd",
           "flash_attention_bwd_sm90", "latent_blend", "int8_quantize", "dequant_blend",
           "mamba_ssd", "mamba_ssd_bwd", "guidance_update")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention": {
        # q, k, v, q_pos, kv_pos, out, lse (or null), B, Sq, Skv, H, KV, D,
        # q_pos batch stride, kv_pos batch stride, causal, window, dtype, stream
        "flash_attention_fwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _L, _L, _I, _I, _I, _P], _I),
        "flash_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention_sm90": {
        # q, k, v, q_pos, kv_pos, live-tile lists, out, lse (or null), B, Sq, Skv,
        # H, KV, D, q_pos batch stride, kv_pos batch stride, causal, window,
        # stream (bf16, D 64, 80 or 128)
        "flash_attention_sm90_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _L, _L, _I, _I, _P], _I),
        # q_pos, kv_pos, lists, B, Sq, Skv, batch strides, causal, window, stream
        "flash_attention_sm90_live_tiles": ([_P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _P],
                                            _I),
        "flash_attention_sm90_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_decode": {
        # q, k, v, q_pos, kv_pos, kv_len (or null), out, partial (m, l), partial
        # acc, tickets, B, Sq, Skv, H, KV, D, q_pos batch stride, kv_pos batch
        # stride, causal, window, splits, split length, stream (bf16, D 64, 80, 128)
        "flash_decode_fwd": ([_P] * 10 + [_I] * 6 + [_L, _L] + [_I] * 4 + [_P], _I),
        # D -> resident blocks an SM
        "flash_decode_blocks_per_sm": ([_I], _I),
        "flash_decode_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention_bwd": {
        # q, k, v, out, dout, q_pos, kv_pos, the forward's lse, delta workspace,
        # dq, dk, dv, B, Sq, Skv, H, KV, D, q_pos batch stride, kv_pos batch
        # stride, causal, window, dtype (1 bf16), stream
        "flash_attention_bwd": ([_P] * 12 + [_I] * 6 + [_L, _L] + [_I] * 3 + [_P], _I),
        "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention_bwd_sm90": {
        # the arguments of flash_attention_bwd without the dtype (bf16, D 64 or 80)
        "flash_attention_bwd_sm90": ([_P] * 12 + [_I] * 6 + [_L, _L] + [_I] * 2 + [_P], _I),
        "flash_attention_bwd_sm90_error_string": ([_I], ctypes.c_char_p),
    },
    "latent_blend": {
        # preds, weights, normalizer, out, starts (host int[K]), K, W, E, F,
        # stream
        "latent_blend_fwd": ([_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I,
                              _L, _P], _I),
        "latent_blend_error_string": ([_I], ctypes.c_char_p),
    },
    "int8_quantize": {
        # x, wire, scales, scratch (one word an SM), its words, N, M (elements
        # per slab), qmax, stream
        "int8_quantize_fwd": ([_P, _P, _P, _P, _I, _I, _L, _I, _P], _I),
        "int8_quantize_error_string": ([_I], ctypes.c_char_p),
    },
    "dequant_blend": {
        # wire, scales, weights, normalizer, out, starts (host int[K]), K, W,
        # E, F, out dtype (0 f32, 1 bf16), stream
        "dequant_blend_fwd": ([_P, _P, _P, _P, _P, ctypes.POINTER(_I), _I, _I,
                               _I, _L, _I, _P], _I),
        "dequant_blend_error_string": ([_I], ctypes.c_char_p),
    },
    "mamba_ssd": {
        # x, log_decay, scale, B, C, y, scratch, b, s, h, p, n, chunk, stream
        "mamba_ssd_fwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        # the same with the states entering each chunk (b, chunks, h, n, p)
        # after scratch: x, log_decay, scale, B, C, y, scratch, states, ...
        "mamba_ssd_fwd_states": ([_P] * 8 + [_I] * 6 + [_P], _I),
        # b, s, h, n, chunk -> bytes of scratch (each chunk's Gram, B^T, scalars)
        "mamba_ssd_scratch_bytes": ([_I, _I, _I, _I, _I], _L),
        "mamba_ssd_error_string": ([_I], ctypes.c_char_p),
    },
    "mamba_ssd_bwd": {
        # x, log_decay, scale, B, C, dy, states, dx, dlog_decay, dscale, dB, dC,
        # scratch, b, s, h, p, n, chunk, stream
        "mamba_ssd_bwd": ([_P] * 13 + [_I] * 6 + [_P], _I),
        # b, s, h, p, n, chunk -> bytes of scratch (L / dS, exp(total), each
        # head group's share of dB and dC)
        "mamba_ssd_bwd_scratch_bytes": ([_I] * 6, _L),
        # n, p, chunk -> bytes of shared memory the widest block takes (one stage)
        "mamba_ssd_bwd_smem_bytes": ([_I, _I, _I], _L),
        "mamba_ssd_bwd_error_string": ([_I], ctypes.c_char_p),
    },
    "guidance_update": {
        # z, cond, uncond, out, elements, w, dt, dtype (0 f32, 1 bf16), stream
        "guidance_update_fwd": ([_P, _P, _P, _P, _L, ctypes.c_float, ctypes.c_float, _I,
                                 _P], _I),
        "guidance_update_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built with it at first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet; returns each
    kernel's ``ptxas`` report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in running:
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: report(n) for n in names}


def report(name: str) -> str:
    """The ``ptxas -v`` lines of the last build of ``name``, with each
    function's stack-frame and spill line (which carries no prefix)."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(l for l in log.read_text().splitlines() if "ptxas" in l or "spill" in l)


def load(name: str, path: Path) -> ctypes.CDLL:
    """Load the shared library at ``path`` as kernel ``name``, with the C
    signatures of that kernel declared."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = load(name, library_path(name))
    return lib


@contextlib.contextmanager
def substituted(name: str, lib: ctypes.CDLL):
    """Serve ``lib`` as kernel ``name`` inside the block (a deliberately
    broken copy, to show that a check catches it)."""
    saved = _LIBS.get(name)
    _LIBS[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _LIBS.pop(name, None)
        else:
            _LIBS[name] = saved


def check(name: str, code: int) -> None:
    """Raise if a launcher returned an error (``cudaGetLastError`` after
    the launch, or a negative code for arguments it refused)."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed ({code}): {msg}")
