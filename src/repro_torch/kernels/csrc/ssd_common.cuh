// What the SSD scan's forward (mamba_ssd.cu) and backward (mamba_ssd_bwd.cu)
// share: the +-60 clip of the factorized exponents, cp.async copies of f32
// rows, and the 3xTF32 tensor-core products (the hi / lo split of an f32
// operand, mma.sync m16n8k8 TF32 and its fragment loads from shared memory);
// the split and the product serve the f32 flash pair too (flash_tf32.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr float kClip = 60.0f;

__device__ __forceinline__ float clip60(float v) { return fminf(fmaxf(v, -kClip), kClip); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v = hi + lo with hi = tf32(v) and lo = tf32(v - hi), each rounded to
// nearest with ties away from zero (kernels/ref.py:split_tf32): what
// cvt.rna.tf32.f32 gives for a finite v.  ptxas expands cvt.rna into four
// instructions (an isfinite test, the add, a select, the mask); every
// operand here is finite, so adding half a TF32 ulp does it, with the mask
// for hi (v - hi must see the TF32 value) and none for lo (mma reads only
// the top 19 bits of a TF32 operand).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a.b in 3xTF32: big += hi.hi, small += lo.hi + hi.lo (two accumulators, so
// each chain of dependent products is shorter; the caller adds them)
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma(small, alo, bhi);
  mma(small, ahi, blo);
  mma(big, ahi, bhi);
}

// Fragments of m16n8k8 (lane = 4 g + t): A (16 x 8, row) holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, col) holds (t, g) and
// (t + 4, g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
// A from a row-major [rows][k] array: rows r0.., columns k0.. (for the
// mma.sync products of the pre-pass)
__device__ __forceinline__ void load_a(const float* m, int ld, int r0, int k0, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = m + (r0 + g) * ld + k0 + t;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// The f32 A fragment (rows r0.., columns k0..) of a row-major [rows][k]
// array with a 16-byte aligned pitch, in one ldmatrix: its four 8 x 8 b16
// matrices are 8 x 4 f32 blocks, lane 8 m + r giving row r of block m
// (rows + 8 for m odd, columns + 4 for m >= 2)
__device__ __forceinline__ void ldsm_a(const float* m, int ld, int r0, int k0, int lane,
                                       float (&v)[4]) {
  const float* p = m + (r0 + (lane & 7) + (lane & 8)) * ld + k0 + (lane >> 4) * 4;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(r[e]);
}

// B from a row-major [k][cols] array: rows k0.., columns c0..
__device__ __forceinline__ void load_b(const float* m, int ld, int k0, int c0, int g, int t,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = m + (k0 + t) * ld + c0 + g;
  split(p[0], hi[0], lo[0]);
  split(p[4 * ld], hi[1], lo[1]);
}

}  // namespace ssd
