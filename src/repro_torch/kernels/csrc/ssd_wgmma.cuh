// What the grouped scan's forward (mamba_ssd_wide.cu) and its backward
// (mamba_ssd_wide_bwd.cu) share for their 3xTF32 products on wgmma: the
// K-major operand layout without swizzle and its descriptor, the split of
// four values into a 16-byte row of a hi and a lo core matrix, the wgmma
// TF32 shapes they issue, the fences and waits around them, and the
// cluster barriers and distributed shared memory reads of the partials.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace ssd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// wgmma descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, the two K cores of a k-step 128 bytes apart (leading
// byte offset), 8-row groups 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t kdesc(const float* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// two floats at shared address `local` in the block of cluster rank `rank`
__device__ __forceinline__ float2 ld_cluster2(uint32_t local, unsigned rank) {
  uint32_t remote;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote)
               : "memory");
  return v;
}
// four floats at shared address `local` in the block of cluster rank `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t local, unsigned rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}
// one float at shared address `local` in the block of cluster rank `rank`
__device__ __forceinline__ float ld_cluster1(uint32_t local, unsigned rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that guards them
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WIDE_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WIDE_F16(i) WIDE_F4(i), WIDE_F4(i + 4), WIDE_F4(i + 8), WIDE_F4(i + 12)

// d (+)= A B, 64 x 32 x 8 TF32: A in registers (rows 16 w + g, g + 8 of
// warp w, columns t, t + 4), B K-major in shared memory; acc 0 overwrites d
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WIDE_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (+)= A B, 64 x 128 x 8 TF32, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : WIDE_F16(0), WIDE_F16(16), WIDE_F16(32), WIDE_F16(48)
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A B, 64 x 64 x 8 TF32, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : WIDE_F16(0), WIDE_F16(16)
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A B, 64 x 16 x 8 TF32, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : WIDE_F4(0), WIDE_F4(4)
      : "l"(da), "l"(db), "r"(acc));
}

// hi and lo of four values into a 16-byte row of a core matrix of each
__device__ __forceinline__ void put4(float* hi, float* lo, float v0, float v1, float v2, float v3) {
  uint4 h, l;
  split(v0, h.x, l.x);
  split(v1, h.y, l.y);
  split(v2, h.z, l.z);
  split(v3, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// the float offset of row r, K core kc (4 values) in a K-major tile of
// `rows` rows: k-steps of rows x 8 floats, row groups of 64, K cores of 32
__device__ __forceinline__ int kofs(int r, int kc, int rows) {
  return (kc >> 1) * rows * 8 + (r >> 3) * 64 + (kc & 1) * 32 + (r & 7) * 4;
}

}  // namespace ssd
