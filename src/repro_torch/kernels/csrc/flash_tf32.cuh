// What the f32 flash kernels (flash_attention.cu's f32 section and
// flash_attention_bwd_f32.cu) share: products in 3xTF32 on mma.sync
// m16n8k8 (ssd_common.cuh's split and mma: lo.hi + hi.lo + hi.hi, only
// lo.lo left out, <= 2^-22 of |a||b|), each operand split once; rows of
// D f32 staged through a raw cp.async stage and split by the thread that
// copied them; the products' fragments read from [rows][D + 4] arrays (a
// pitch at which ldmatrix and the scalar reads of rows 2c, 2c + 1 are
// conflict-free).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "ssd_common.cuh"

namespace flash_tf32 {

// d += a.b in 3xTF32 (operands split by ssd::split)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  ssd::mma(d, al, bh);
  ssd::mma(d, ah, bl);
  ssd::mma(d, ah, bh);
}

// Thread ``tid`` of NT: its 16-byte chunks of R rows x D f32 (rows r0.. of
// a global array with row stride ``rs``, zero past row n) into ``dst``
// [R][D + 4]
template <int D, int R, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, long long rs, int r0, int n,
                                      int tid) {
  constexpr int LD = D + 4, CH = D / 4;
  for (int i = tid; i < R * CH; i += NT) {
    const int row = i / CH, cc = (i % CH) * 4, r = r0 + row;
    flash::cp_async16(dst + row * LD + cc, src + (long long)(r < n ? r : 0) * rs + cc, r < n);
  }
}

// Split the chunks this thread staged (stage<D, R, NT>'s) into hi and lo:
// once the thread's own copies have landed, no barrier is needed before
// it, and the thread may start the next copy into the same chunks after it
template <int D, int R, int NT>
__device__ __forceinline__ void split_staged(const float* raw, uint32_t* hi, uint32_t* lo,
                                             int tid) {
  constexpr int LD = D + 4, CH = D / 4;
  for (int i = tid; i < R * CH; i += NT) {
    const int at = (i / CH) * LD + (i % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    uint4 h, l;
    ssd::split(x.x, h.x, l.x);
    ssd::split(x.y, h.y, l.y);
    ssd::split(x.z, h.z, l.z);
    ssd::split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// d[nb] = A B^T (16 rows x 8 NB columns, zeroed first) over D: A the warp's
// 16 rows of a [rows][D + 4] TF32 array from row r0, B^T the first 8 NB rows
// of one.  ldmatrix reads an 8 x 4 f32 block as an 8 x 8 b16 matrix: one x4
// gives A's fragment of a k-step, one x4 B's of two
template <int D, int NB>
__device__ __forceinline__ void rows_dot(float (&d)[NB][4], const uint32_t* ah_m,
                                         const uint32_t* al_m, int r0, const uint32_t* bh,
                                         const uint32_t* bl, int lane) {
  constexpr int LD = D + 4;
  static_assert(D % 16 == 0, "k-steps in pairs");
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) d[nb][0] = d[nb][1] = d[nb][2] = d[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; kk += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int at = (r0 + (lane & 7) + (lane & 8)) * LD + (kk + j) * 8 + (lane >> 4) * 4;
      flash::ldsm_x4(ah[j], ah_m + at);
      flash::ldsm_x4(al[j], al_m + at);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int at = (nb * 8 + (lane & 7)) * LD + kk * 8 + (lane >> 3) * 4;
      uint32_t h[4], l[4];
      flash::ldsm_x4(h, bh + at);
      flash::ldsm_x4(l, bl + at);
      mma3(d[nb], ah[0], al[0], {h[0], h[1]}, {l[0], l[1]});
      mma3(d[nb], ah[1], al[1], {h[2], h[3]}, {l[2], l[3]});
    }
  }
}

// run = run corr + A B over a tile (corr per row: r and r + 8 of the
// warp's 16).  A: the accumulator-layout f32 a[NB][4] (16 rows x 8 NB),
// split here, its k = c holding column 2c and k = c + 4 column 2c + 1 of
// each 8-block, so B's fragment is rows 2c and 2c + 1 of B, an [8 NB][D +
// 4] TF32 array (D columns).  The tensor core's additions do not round to
// nearest: 8 CW columns at a time go into a zeroed accumulator, added to
// ``run`` with one FFMA
template <int D, int NB, int CW = 4>
__device__ __forceinline__ void tile_product(float (&run)[D / 8][4], const float (&a)[NB][4],
                                             const uint32_t* bh, const uint32_t* bl, int g,
                                             int c, const float (&corr)[2]) {
  constexpr int LD = D + 4, DB = D / 8;
#pragma unroll
  for (int d0 = 0; d0 < DB; d0 += CW) {
    float acc[CW][4];
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NB; ++ks) {
      uint32_t ah[4], al[4];
      ssd::split(a[ks][0], ah[0], al[0]);
      ssd::split(a[ks][2], ah[1], al[1]);
      ssd::split(a[ks][1], ah[2], al[2]);
      ssd::split(a[ks][3], ah[3], al[3]);
      const int at = (ks * 8 + 2 * c) * LD + g;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        if (d0 + j < DB) {
          const int col = at + (d0 + j) * 8;
          mma3(acc[j], ah, al, {bh[col], bh[col + LD]}, {bl[col], bl[col + LD]});
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      if (d0 + j < DB) {
#pragma unroll
        for (int e = 0; e < 4; ++e) run[d0 + j][e] = fmaf(run[d0 + j][e], corr[e >> 1], acc[j][e]);
      }
    }
  }
}

// rows r and r + 8 of the warp's 16 (row[i], i = 0, 1) of an [n][rs] f32
// array: this thread's columns 2c, 2c + 1 of each 8-block of r, times ``f``
template <int D>
__device__ __forceinline__ void store_rows(float* base, long long rs, const int (&row)[2], int n,
                                           const float (&r)[D / 8][4], const float (&f)[2],
                                           int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= n) continue;
#pragma unroll
    for (int db = 0; db < D / 8; ++db)
      *reinterpret_cast<float2*>(base + row[i] * rs + db * 8 + 2 * c) =
          make_float2(r[db][2 * i] * f[i], r[db][2 * i + 1] * f[i]);
  }
}

}  // namespace flash_tf32
