// Flash attention backward (the gradient of flash_attention.cu's function)
// for Hopper, sm_90a, on mma.sync: bf16 at head dims 64 and 80.  ops.py
// routes D 80 here (Zamba2's head dim; no training path runs it yet) and D
// 64 to flash_attention_bwd_sm90.cu (wgmma + TMA); D 64 stays built so the
// two can be timed on the same inputs.
//
// Replaces: no Pallas kernel.  The reference has no backward kernel: it
// trains through XLA's gradient of the jnp attention_chunked
// (src/repro/models/attention.py:81).  The port runs the forward of a
// training step on its hand-written flash kernels, whose outputs autograd
// cannot see through, so this file is their gradient
// (kernels/ops.py: FlashAttention).
//
// Same function as kernels/ref.py: flash_attention_bwd_ref.  With scores
// s = q.k / sqrt(D) under the forward's masks (flash_common.cuh: attend;
// int32-max marks a padded key), P = softmax(s) (zero on a row that attends
// no key), Delta_i = sum_d dO_id O_id from the forward's output O,
// dP = dO V^T and dS = P o (dP - Delta):
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),  dV = P^T dO,
// dK and dV summed over the G query heads of a kv head's group (GQA).
// bf16 in and out, f32 sums; P and dS go to bf16 for the products that take
// them (kernels/ref.py: flash_bwd_bf16_tolerance).  P is exp2(s log2(e) /
// sqrt(D) - lse) with the forward's log-sum-exp (kernels/ref.py:
// flash_attention_lse_ref), which flash_attention_sm90.cu or
// flash_attention.cu wrote: no launch here computes it again.
//
// Design.  Deterministic, with no atomics on a result: every output element
// is summed by one thread in a fixed order.  Three launches on the stream:
//   1. bwd_prep, one block per (batch, head, 64 queries): each row's Delta,
//      f32 into a workspace.
//   2. bwd_dkdv, one block per (batch, kv head, 64 keys), 16 keys a warp:
//      dK and dV of its keys stay in registers while the block walks the G
//      heads of the group and, for each, the query tiles that hold an
//      attendable pair with its keys (flash_common.cuh: live_q_tiles),
//      recomputing S^T = K Q^T and P^T from the log-sum-exp.
//   3. bwd_dq, one block per (batch, head, 64 queries), 16 rows a warp: dQ
//      in registers over the live key tiles (flash_common.cuh: live_tiles).
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with the
// forward's fragment tricks: a C fragment of S or dS is the A fragment of
// the next product, K / Q / dO tiles are read with ldmatrix (.trans where
// the product wants them transposed), and the next tile is loaded by
// cp.async into a second stage while the current one is multiplied.  A tile
// whose every pair is attendable skips the per-element mask.
//
// What bounds it.  Tensor-core operations: 2.5 times the forward's
// products over the attended pairs (S recomputed twice, dP twice, and dV,
// dK and dQ), far above the card's ~295 operations per byte at a training
// length.  mma.sync reaches about two thirds of the wgmma rate at best;
// flash_attention_bwd_sm90.cu is the wgmma + TMA design (D 64).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "flash_common.cuh"

namespace {

using flash::attend;
using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait_one;
using flash::exp2_approx;
using flash::kLog2e;
using flash::kPadPos;
using flash::ldsm_x2;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // queries of a prep / dq block, keys of a dkdv block
constexpr int kBN = 32;             // keys of a tile in dq

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const int* qpos;
  const int* kvpos;
  const float* lse;  // [B][H][Sq] from the forward (kernels/ref.py: flash_attention_lse_ref)
  float* delta;      // [B][H][Sq]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, Sq, Skv, H, KV;
  long long qpos_bs, kvpos_bs;  // batch strides of the position arrays
  int causal, window;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 ld_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Fragment layouts of mma m16n8k16: flash_common.cuh.  Tiles in shared
// memory are [row][dim] with rows of LD = D + 8 bf16.

// A fragments of 16 rows (r0 = row g, r1 = row g + 8) x D from device memory
// (rows past the end are zero).
template <int KSTEPS>
__device__ __forceinline__ void load_a(uint32_t (&f)[KSTEPS][4], const bf16* base,
                                       long long rs, int r0, bool ok0, bool ok1, int c) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * c;
    f[kk][0] = ok0 ? ld32(base + r0 * rs + col) : 0u;
    f[kk][1] = ok1 ? ld32(base + (r0 + 8) * rs + col) : 0u;
    f[kk][2] = ok0 ? ld32(base + r0 * rs + col + 8) : 0u;
    f[kk][3] = ok1 ? ld32(base + (r0 + 8) * rs + col + 8) : 0u;
  }
}

// acc[nb] (16 x 8 block nb) += A (16 x D, fragments f) . T^T, T a tile
// [8 NB rows][D] in shared memory: the product over D with T's rows as the
// output columns (plain ldmatrix; an odd last k-step, D = 80, takes .x2).
template <int NB, int KSTEPS, int LD>
__device__ __forceinline__ void mul_rows_t(float (&acc)[NB][4], const uint32_t (&f)[KSTEPS][4],
                                           const bf16* t, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, t + (nb * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
      mma_bf16(acc[nb], f[kk], b[0], b[1]);
      mma_bf16(acc[nb], f[kk + 1], b[2], b[3]);
    }
    if constexpr (KSTEPS % 2 == 1) {
      uint32_t b[2];
      ldsm_x2(b, t + (nb * 8 + (lane & 7)) * LD + (KSTEPS - 1) * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[nb], f[KSTEPS - 1], b[0], b[1]);
    }
  }
}

// out (16 x D, DB blocks of 8) += X . T, X the 16 x (8 NB) values in x
// (C fragments, rounded to bf16 as A fragments), T a tile [8 NB rows][D] in
// shared memory (ldmatrix.trans).
template <int NB, int DB, int LD>
__device__ __forceinline__ void mul_acc_t(float (&out)[DB][4], const float (&x)[NB][4],
                                          const bf16* t, int lane) {
#pragma unroll
  for (int k2 = 0; k2 < NB / 2; ++k2) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * k2][0], x[2 * k2][1]);
    a[1] = pack_bf16(x[2 * k2][2], x[2 * k2][3]);
    a[2] = pack_bf16(x[2 * k2 + 1][0], x[2 * k2 + 1][1]);
    a[3] = pack_bf16(x[2 * k2 + 1][2], x[2 * k2 + 1][3]);
    // matrices: (rows +0, dims db), (rows +8, db), (+0, db+1), (+8, db+1)
    const bf16* row = t + (k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int db = 0; db < DB; db += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, row + db * 8);
      mma_bf16(out[db], a, b[0], b[1]);
      mma_bf16(out[db + 1], a, b[2], b[3]);
    }
  }
}

inline int list_bytes(int n, int tile) { return ((n + tile - 1) / tile + 3) * 4; }

// --------------------------------------------------------------- 1. prep
// Delta = rowsum(dO o O) of 64 rows, 16 a warp, a row's dims spread over
// the 4 lanes of a quad.
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_prep(Params p) {
  constexpr int KSTEPS = D / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qrs = (long long)p.H * D;
  const long long qoff = (long long)b * p.Sq * qrs + (long long)h * D;
  const int r0 = blockIdx.x * kRows + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok_r0 = r0 < p.Sq, ok_r1 = r1 < p.Sq;
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int half = 0; half < 16; half += 8) {
      const long long col = kk * 16 + 2 * c + half;
      if (ok_r0) {
        const float2 o = ld_f2(p.o + qoff + r0 * qrs + col);
        const float2 d = ld_f2(p.dout + qoff + r0 * qrs + col);
        dl0 = fmaf(o.x, d.x, fmaf(o.y, d.y, dl0));
      }
      if (ok_r1) {
        const float2 o = ld_f2(p.o + qoff + r1 * qrs + col);
        const float2 d = ld_f2(p.dout + qoff + r1 * qrs + col);
        dl1 = fmaf(o.x, d.x, fmaf(o.y, d.y, dl1));
      }
    }
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long row = ((long long)b * p.H + h) * p.Sq;
  if (c == 0) {
    if (ok_r0) p.delta[row + r0] = dl0;
    if (ok_r1) p.delta[row + r1] = dl1;
  }
}

// ------------------------------------------------------------ 2. dK, dV
// Query tile of the dkdv walk: 64 rows at D 64, 32 at D 80 (registers).
template <int D>
struct DkdvTile {
  static constexpr int BQ = D <= 64 ? 64 : 32;
};

template <int D>
constexpr int dkdv_smem_bytes() {
  // 2 stages x (Q, dO) tiles + per stage query positions, lse, Delta
  return 2 * 2 * DkdvTile<D>::BQ * (D + 8) * 2 + 2 * 3 * DkdvTile<D>::BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(Params p) {
  constexpr int BQ = DkdvTile<D>::BQ, LD = D + 8, KSTEPS = D / 16, DB = D / 8, NQ = BQ / 8;
  constexpr int TILE = BQ * LD;
  static_assert(D % 16 == 0 && DB % 2 == 0, "k-steps of 16 dims, dim blocks in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);           // [2][BQ][LD]
  bf16* dOs = Qs + 2 * TILE;                          // [2][BQ][LD]
  int* qp_s = reinterpret_cast<int*>(dOs + 2 * TILE); // [2][BQ]
  float* lse_s = reinterpret_cast<float*>(qp_s + 2 * BQ);
  float* dl_s = lse_s + 2 * BQ;
  int* live = reinterpret_cast<int*>(dl_s + 2 * BQ);  // [q tiles + 3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z, G = p.H / p.KV;
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const long long kvoff = (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int k0 = blockIdx.x * kRows;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const bool ok_k0 = kr0 < p.Skv, ok_k1 = kr1 < p.Skv;
  const int kp0 = ok_k0 ? p.kvpos[b * p.kvpos_bs + kr0] : kPadPos;
  const int kp1 = ok_k1 ? p.kvpos[b * p.kvpos_bs + kr1] : kPadPos;
  const int* qpos = p.qpos + b * p.qpos_bs;

  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  load_a<KSTEPS>(kf, p.k + kvoff, kvrs, kr0, ok_k0, ok_k1, c);
  load_a<KSTEPS>(vf, p.v + kvoff, kvrs, kr0, ok_k0, ok_k1, c);
  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    dk[db][0] = dk[db][1] = dk[db][2] = dk[db][3] = 0.f;
    dv[db][0] = dv[db][1] = dv[db][2] = dv[db][3] = 0.f;
  }
  const float sl2 = p.scale * kLog2e;

  const int nlive = flash::live_q_tiles<BQ, kRows, kThreads>(
      qpos, p.Sq, p.kvpos + b * p.kvpos_bs, k0, p.Skv, p.causal, p.window, live,
      live + (p.Sq + BQ - 1) / BQ);
  const int steps = G * nlive;  // every head of the group, every live query tile
  auto load_tile = [&](int i, int st) {
    const int h = hk * G + i / nlive, q0 = (live[i % nlive] >> 1) * BQ;
    const long long off = (long long)b * p.Sq * qrs + (long long)h * D;
    bf16* qs = Qs + st * TILE;
    bf16* ds = dOs + st * TILE;
    for (int e = tid; e < BQ * D / 8; e += kThreads) {
      const int row = e / (D / 8), cc = (e % (D / 8)) * 8;
      const int r = q0 + row;
      const long long src = off + (r < p.Sq ? r * qrs + cc : 0);
      cp_async16(qs + row * LD + cc, p.q + src, r < p.Sq);
      cp_async16(ds + row * LD + cc, p.dout + src, r < p.Sq);
    }
    if (tid < BQ) {
      const int r = q0 + tid;
      const long long row = ((long long)b * p.H + h) * p.Sq + r;
      qp_s[st * BQ + tid] = r < p.Sq ? qpos[r] : 0;
      lse_s[st * BQ + tid] = r < p.Sq ? p.lse[row] : INFINITY;  // P = 0 on a missing row
      dl_s[st * BQ + tid] = r < p.Sq ? p.delta[row] : 0.f;
    }
  };

  if (steps > 0) load_tile(0, 0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    const int st = i & 1;
    if (i + 1 < steps) load_tile(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bool full = !(live[i % nlive] & 1);
    const bf16* qs = Qs + st * TILE;
    const bf16* ds = dOs + st * TILE;
    const int* qp = qp_s + st * BQ;
    const float* lse = lse_s + st * BQ;
    const float* dl = dl_s + st * BQ;

    // P^T (this warp's 16 keys x BQ queries) from S^T = K Q^T
    float pt[NQ][4];
    mul_rows_t<NQ, KSTEPS, LD>(pt, kf, qs, lane);
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nb * 8 + 2 * c + j;
        const bool ok0 = full || attend(qp[col], kp0, p.causal, p.window);
        const bool ok1 = full || attend(qp[col], kp1, p.causal, p.window);
        pt[nb][j] = ok0 ? exp2_approx(fmaf(pt[nb][j], sl2, -lse[col])) : 0.f;
        pt[nb][2 + j] = ok1 ? exp2_approx(fmaf(pt[nb][2 + j], sl2, -lse[col])) : 0.f;
      }
    }
    mul_acc_t<NQ, DB, LD>(dv, pt, ds, lane);  // dV += P^T dO

    // dS^T = P^T o (dP^T - Delta), dP^T = V dO^T
    float dpt[NQ][4];
    mul_rows_t<NQ, KSTEPS, LD>(dpt, vf, ds, lane);
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float d = dl[nb * 8 + 2 * c + j];
        pt[nb][j] *= dpt[nb][j] - d;
        pt[nb][2 + j] *= dpt[nb][2 + j] - d;
      }
    }
    mul_acc_t<NQ, DB, LD>(dk, pt, qs, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  bf16* DK = p.dk + kvoff;
  bf16* DV = p.dv + kvoff;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * c;
    if (ok_k0) {
      *reinterpret_cast<__nv_bfloat162*>(DK + kr0 * kvrs + col) =
          __floats2bfloat162_rn(dk[db][0] * p.scale, dk[db][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(DV + kr0 * kvrs + col) =
          __floats2bfloat162_rn(dv[db][0], dv[db][1]);
    }
    if (ok_k1) {
      *reinterpret_cast<__nv_bfloat162*>(DK + kr1 * kvrs + col) =
          __floats2bfloat162_rn(dk[db][2] * p.scale, dk[db][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(DV + kr1 * kvrs + col) =
          __floats2bfloat162_rn(dv[db][2], dv[db][3]);
    }
  }
}

// ------------------------------------------------------------------ 3. dQ
template <int D>
constexpr int dq_smem_bytes() {
  return 2 * 2 * kBN * (D + 8) * 2 + 2 * kBN * 4;  // 2 stages x (K, V) + kv positions
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq(Params p) {
  constexpr int BN = kBN, LD = D + 8, KSTEPS = D / 16, DB = D / 8, NB = BN / 8, TILE = BN * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);            // [2][BN][LD]
  bf16* Vs = Ks + 2 * TILE;                            // [2][BN][LD]
  int* kvp_s = reinterpret_cast<int*>(Vs + 2 * TILE);  // [2][BN]
  int* live = kvp_s + 2 * BN;                          // [ntiles + 3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.KV);
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const long long qoff = (long long)b * p.Sq * qrs + (long long)h * D;
  const bf16* Kg = p.k + (long long)b * p.Skv * kvrs + (long long)hk * D;
  const bf16* Vg = p.v + (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int r0 = blockIdx.x * kRows + warp * 16 + g, r1 = r0 + 8;
  const bool ok_r0 = r0 < p.Sq, ok_r1 = r1 < p.Sq;
  const int qp0 = ok_r0 ? p.qpos[b * p.qpos_bs + r0] : 0;
  const int qp1 = ok_r1 ? p.qpos[b * p.qpos_bs + r1] : 0;
  const long long row = ((long long)b * p.H + h) * p.Sq;
  const float lse0 = ok_r0 ? p.lse[row + r0] : INFINITY, lse1 = ok_r1 ? p.lse[row + r1] : INFINITY;
  const float dl0 = ok_r0 ? p.delta[row + r0] : 0.f, dl1 = ok_r1 ? p.delta[row + r1] : 0.f;

  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  load_a<KSTEPS>(qf, p.q + qoff, qrs, r0, ok_r0, ok_r1, c);
  load_a<KSTEPS>(dof, p.dout + qoff, qrs, r0, ok_r0, ok_r1, c);
  float dq[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) dq[db][0] = dq[db][1] = dq[db][2] = dq[db][3] = 0.f;
  const float sl2 = p.scale * kLog2e;

  auto load_tile = [&](int n0, int st) {
    bf16* ks = Ks + st * TILE;
    bf16* vs = Vs + st * TILE;
    for (int i = tid; i < BN * D / 8; i += kThreads) {
      const int rr = i / (D / 8), cc = (i % (D / 8)) * 8;
      const int n = n0 + rr;
      const long long off = n < p.Skv ? n * kvrs + cc : 0;
      cp_async16(ks + rr * LD + cc, Kg + off, n < p.Skv);
      cp_async16(vs + rr * LD + cc, Vg + off, n < p.Skv);
    }
    if (tid < BN) {
      const int n = n0 + tid;
      kvp_s[st * BN + tid] = n < p.Skv ? p.kvpos[b * p.kvpos_bs + n] : kPadPos;
    }
  };

  const int ntiles = flash::live_tiles<kRows, BN, kThreads>(
      p.qpos + b * p.qpos_bs, blockIdx.x * kRows, p.Sq, p.kvpos + b * p.kvpos_bs, p.Skv,
      p.causal, p.window, live, live + (p.Skv + BN - 1) / BN);
  if (ntiles > 0) load_tile((live[0] >> 1) * BN, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) load_tile((live[t + 1] >> 1) * BN, st ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bool full = !(live[t] & 1);
    const bf16* ks = Ks + st * TILE;
    const bf16* vs = Vs + st * TILE;
    const int* kvp = kvp_s + st * BN;

    float s[NB][4], dp[NB][4];
    mul_rows_t<NB, KSTEPS, LD>(s, qf, ks, lane);   // S = Q K^T
    mul_rows_t<NB, KSTEPS, LD>(dp, dof, vs, lane); // dP = dO V^T
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = kvp[nb * 8 + 2 * c + j];
        const bool ok0 = full || attend(qp0, kp, p.causal, p.window);
        const bool ok1 = full || attend(qp1, kp, p.causal, p.window);
        // dS = P o (dP - Delta)
        s[nb][j] = ok0 ? exp2_approx(fmaf(s[nb][j], sl2, -lse0)) * (dp[nb][j] - dl0) : 0.f;
        s[nb][2 + j] =
            ok1 ? exp2_approx(fmaf(s[nb][2 + j], sl2, -lse1)) * (dp[nb][2 + j] - dl1) : 0.f;
      }
    }
    mul_acc_t<NB, DB, LD>(dq, s, ks, lane);  // dQ += dS K
    __syncthreads();
  }

  bf16* DQ = p.dq + qoff;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * c;
    if (ok_r0)
      *reinterpret_cast<__nv_bfloat162*>(DQ + r0 * qrs + col) =
          __floats2bfloat162_rn(dq[db][0] * p.scale, dq[db][1] * p.scale);
    if (ok_r1)
      *reinterpret_cast<__nv_bfloat162*>(DQ + r1 * qrs + col) =
          __floats2bfloat162_rn(dq[db][2] * p.scale, dq[db][3] * p.scale);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p, cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_all(const Params& p, cudaStream_t st) {
  const dim3 qgrid((p.Sq + kRows - 1) / kRows, p.H, p.B);
  cudaError_t e = launch(bwd_prep<D>, qgrid, 0, p, st);
  if (e != cudaSuccess) return e;
  e = launch(bwd_dkdv<D>, dim3((p.Skv + kRows - 1) / kRows, p.KV, p.B),
             dkdv_smem_bytes<D>() + list_bytes(p.Sq, DkdvTile<D>::BQ), p, st);
  if (e != cudaSuccess) return e;
  return launch(bwd_dq<D>, qgrid, dq_smem_bytes<D>() + list_bytes(p.Skv, kBN), p, st);
}

}  // namespace

// q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, KV, D); all bf16 and
// contiguous.  lse: the forward's f32 (B, H, Sq) log-sum-exp; delta: an f32
// workspace of B * H * Sq.  dtype: 1 = bfloat16.  Returns cudaGetLastError()
// after the launches, or -1 for a dtype / head dim this file has no kernel
// for.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* qpos, const void* kvpos,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int B,
                                   int Sq, int Skv, int H, int KV, int D, long long qpos_bs,
                                   long long kvpos_bs, int causal, int window, int dtype,
                                   void* stream) {
  if (dtype != 1) return -1;
  Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<const bf16*>(out),
           static_cast<const bf16*>(dout), static_cast<const int*>(qpos),
           static_cast<const int*>(kvpos), static_cast<const float*>(lse),
           static_cast<float*>(delta),
           static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
           B, Sq, Skv, H, KV, qpos_bs, kvpos_bs, causal, window, 1.0f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 64) e = launch_all<64>(p, st);
  else if (D == 80) e = launch_all<80>(p, st);
  else return -1;
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  if (code < 0) return "unsupported dtype or head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
