#!/usr/bin/env python3
"""Whether two builds of a CUDA source compile a kernel to the same code.

    python3 tools/sass_same.py OLD.cu NEW.cu OLD_NAME=NEW_NAME [...]

Compiles each source to a cubin with the port's nvcc flags (sm_90a, -O3),
disassembles both with ``cuobjdump -sass``, and compares, for each pair,
the instruction lists of the first function whose mangled name contains
OLD_NAME in the old build and NEW_NAME in the new one (addresses,
encodings and comments stripped).  Prints one line per pair, ``same`` or
the first differing instruction, and exits 1 if any pair differs or is
missing.  Needs the CUDA toolkit (run it on the machine with the card);
e.g. for the SSD scan's serving instantiations against a parent commit's
source unpacked under ``build/``:

    python3 tools/sass_same.py build/parent/mamba_ssd.cu \\
        src/repro_torch/kernels/csrc/mamba_ssd.cu \\
        mamba_ssd_kernelILi64EE=mamba_ssd_kernelILi64ELb0EE \\
        mamba_ssd_kernelILi0EE=mamba_ssd_kernelILi0ELb0EE
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")


def functions(src: Path, tmp: Path) -> dict:
    """Mangled name -> list of instructions of each function in ``src``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    cubin = tmp / (src.stem + f"_{abs(hash(str(src)))}.cubin")
    subprocess.run([nvcc, *ARCH, "-cubin", "-o", str(cubin), str(src)], check=True)
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if m:
                out[name].append(m.group(1))
    return out


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old_src, new_src, pairs = Path(argv[0]), Path(argv[1]), argv[2:]
    with tempfile.TemporaryDirectory() as d:
        old, new = functions(old_src, Path(d)), functions(new_src, Path(d))
    bad = 0
    for pair in pairs:
        o_key, n_key = pair.split("=")
        o = next((v for k, v in old.items() if o_key in k), None)
        n = next((v for k, v in new.items() if n_key in k), None)
        if o is None or n is None:
            print(f"{pair}: missing ({'old' if o is None else 'new'})")
            bad += 1
            continue
        diff = next((i for i, (a, b) in enumerate(zip(o, n)) if a != b), None)
        if diff is None and len(o) == len(n):
            print(f"{pair}: same ({len(o)} instructions)")
        else:
            at = min(len(o), len(n)) if diff is None else diff
            print(f"{pair}: differ at instruction {at} of {len(o)} / {len(n)}: "
                  f"{o[at] if at < len(o) else None!r} / {n[at] if at < len(n) else None!r}")
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
