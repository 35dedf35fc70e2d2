#!/usr/bin/env python3
"""TF32 tensor-core rates on one GPU: mma.sync against wgmma.

    python3 tools/tf32_mma_rate.py

Builds a small CUDA source (written to a temporary directory) and times,
with CUDA events after a warm-up:

  mma_sync   mma.sync.m16n8k8 TF32, 8 independent accumulators a warp,
             operands in registers, 8 warps a block, 4 blocks an SM
  wgmma_ss   wgmma.m64n64k8 TF32, both operands K-major in shared memory
             (no swizzle), 8 products a commit, 2 warpgroups a block, 2
             blocks an SM
  wgmma_rs   the same with A in registers

The operands are zeros (for timing only).  Prints TFLOP/s against 495
TFLOP/s, the dense TF32 peak, and writes chiprun_out/tf32_mma_rate.json.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
ITERS = 4096
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
#define D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define D32_OPS "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

__device__ __forceinline__ void wg_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32 ", %32, %33, p, 1, 1;\n}\n"
               : D32_OPS : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : D32_OPS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

extern "C" __global__ void mma_rate(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
                   "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 1.2345f) out[0] = s;
}

extern "C" __global__ void wgmma_rate(float* out, int iters, int regs_a) {
  __shared__ __align__(128) float sa[64 * 64], sb[64 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) sa[i] = sb[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a0 = (uint32_t)__cvta_generic_to_shared(sa), b0 = (uint32_t)__cvta_generic_to_shared(sb);
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint32_t a[4] = {0u, 0u, 0u, 0u};
  for (int it = 0; it < iters; ++it) {
    fence();
    if (regs_a) {
#pragma unroll
      for (int k = 0; k < 8; ++k) wg_rs(d, a, desc(b0 + 256 * k, 128, 2048));
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) wg_ss(d, desc(a0 + 256 * k, 128, 2048), desc(b0 + 256 * k, 128, 2048), 1);
    }
    commit();
    wait0();
  }
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += d[i];
  if (s == 1.2345f) out[0] = s;
}

extern "C" int run(int which, float* out, int iters, int* grid_block) {
  int blocks = 0, threads = 0, sms = 132, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (which == 0) { blocks = 4 * sms; threads = 256; mma_rate<<<blocks, threads>>>(out, iters); }
  else { blocks = 2 * sms; threads = 256; wgmma_rate<<<blocks, threads>>>(out, iters, which == 2); }
  grid_block[0] = blocks;
  grid_block[1] = threads;
  return (int)cudaGetLastError();
}

"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("tf32_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    smi = cs.nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="tf32_mma_rate_") as tmp:
        src, so = Path(tmp) / "rate.cu", Path(tmp) / "librate.so"
        src.write_text(SOURCE)
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                              capture_output=True, text=True)
        cs.check(proc.returncode == 0, f"build failed:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run.argtypes, lib.run.restype = [I, P, I, ctypes.POINTER(I)], I
    result = {"nvidia_smi": smi, "tflops": {}}
    out = torch.zeros(1, device="cuda")
    gb = (I * 2)()
    flop_per = {0: 2 * 16 * 8 * 8 * 8, 1: 2 * 64 * 64 * 8 * 8, 2: 2 * 64 * 64 * 8 * 8}
    for rep in range(2):
        for which, name in ((0, "mma_sync"), (1, "wgmma_ss"), (2, "wgmma_rs")):
            lib.run(which, out.data_ptr(), 16, gb)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            rc = lib.run(which, out.data_ptr(), ITERS, gb)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            units = gb[0] * gb[1] // (32 if which == 0 else 128)
            tflops = flop_per[which] * ITERS * units / ms / 1e9
            result["tflops"].setdefault(name, []).append(tflops)
            print(f"rate {name} rc={rc} ms={ms:.3f} tflops={tflops:.1f} "
                  f"(peak 495; {tflops / 495:.2f})", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tf32_mma_rate.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
