// Flash attention backward for Hopper with wgmma and TMA: bf16, head dim
// 64 or 80, sm_90a.  The gradient of the flash function at the LMs'
// training shapes (granite: 32 / 8 x 64 heads; Zamba2: 32 x 80; causal).
//
// Replaces: no Pallas kernel.  The reference has no backward kernel: it
// trains through XLA's gradient of the jnp attention_chunked
// (src/repro/models/attention.py:81).  The port's training forward runs on
// its hand-written flash kernels, whose outputs autograd cannot see
// through, so this file is their gradient (kernels/ops.py: FlashAttention;
// flash_attention_bwd.cu, mma.sync, is kept as a timing twin reached only
// through ops.flash_attention_bwd's kernel=).
//
// Same function as kernels/ref.py: flash_attention_bwd_ref.  With scores
// s = q.k / sqrt(D) under the forward's masks (flash_common.cuh: attend;
// int32-max marks a padded key), P = softmax(s) (zero on a row that attends
// no key), Delta_i = sum_d dO_id O_id from the forward's output O,
// dP = dO V^T and dS = P o (dP - Delta):
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),  dV = P^T dO,
// dK and dV summed over the G query heads of a kv head's group (GQA).  P is
// exp2(s log2(e) / sqrt(D) - lse) with the log-sum-exp the forward wrote
// (flash_attention_sm90.cu or flash_attention.cu; kernels/ref.py:
// flash_attention_lse_ref): no launch here computes it again.  bf16 in and
// out, f32 sums; P and dS go to bf16 for the products that take them
// (kernels/ref.py: flash_bwd_bf16_tolerance).
//
// What bounds it.  Tensor-core operations: 10 x pairs x H x D for the five
// products over the attended pairs (S and dP are computed twice, once for
// dK/dV and once for dQ: 14 x pairs x H x D issued), against 2 x (4 Sq H +
// 4 Skv KV) x D bytes (q, O, dO, dQ; k, v, dK, dV) and 8 Sq H of lse and
// Delta; at granite's and Zamba2's causal layers (2048 tokens) about 1,000
// operations a byte, far above the card's ~295.  mma.sync reaches a
// fraction of the tensor cores' rate (flash_attention_bwd.cu: 7% of the
// bound at granite's layer, 9.7% at Zamba2's); wgmma, a 64-row product
// issued by a warpgroup with its operands in shared memory, is the way to
// the rest.
//
// Design.  Deterministic, with no atomics on a result: every output element
// is summed by one thread in a fixed order, so two calls are bit-equal (the
// restart drill of a training run depends on it).  dK/dV and dQ therefore
// have separate owners.  Three launches, each templated on the head dim:
//  1. bwd_delta: Delta = rowsum(dO o O), 8 threads a row (one 16-byte load
//     of each operand a thread, two for the first two threads at D 80),
//     f32 (B, H, Sq).
//  2. bwd_dkdv, one block per (kv head, batch, 128 keys): two consumer
//     warpgroups of 64 keys hold their keys' dK and dV in registers (32 f32
//     each at D 64, 40 at D 80) while the block walks the G heads of the
//     group and, for each, the 64-query tiles that hold an attendable pair
//     with its keys (flash_common.cuh: live_q_tiles, the transpose of
//     live_tiles).  K and V are loaded once by TMA.  A step runs S^T = K Q^T
//     and dP^T = V dO^T (both operands K-major in shared memory),
//     P^T = exp2(S^T sl2 - lse) with the tile's log-sum-exp staged in
//     shared memory, dV += P^T dO (P^T from registers, dO through the
//     transpose bit), dS^T = P^T o (dP^T - Delta), dK += dS^T Q (Q through
//     the transpose bit).  Key blocks go out in key order, the slowest grid
//     dimension: under a causal mask on ascending positions the first key
//     blocks have the most live query tiles, so the longest blocks start
//     first.
//  3. bwd_dq, one block per (head, batch, 128 queries): two consumer
//     warpgroups of 64 queries hold dQ in registers; Q and dO are loaded
//     once; each live 64-key tile (flash_common.cuh: live_tiles) runs S =
//     Q K^T and dP = dO V^T, dS = P o (dP - Delta) and dQ += dS K (K
//     through the transpose bit).  Query blocks go out from the last, which
//     under a causal mask have the most key tiles.
//  Both: one producer warpgroup gives its registers up (setmaxnreg 40, the
//  consumers take 232); one thread keeps a ring of 5 stages full by TMA
//  (Q and dO tiles, or K and V tiles), each stage on a "full" mbarrier and
//  refilled once both consumer warpgroups have arrived on its "empty" one.
//  In bwd_dkdv a second producer warp stages the step's log-sum-exp, Delta
//  and query positions beside the tiles and arrives on the same "full"
//  barrier.  A consumer issues a step's first two products together and
//  runs the elementwise work of one while the next product runs (P^T while
//  dP^T runs, dS^T while dV runs); the two warpgroups' elementwise phases
//  overlap each other's products.  Every product is waited for before the
//  step ends: one left in flight across the loop's back edge makes ptxas
//  serialise every wgmma of the kernel (C7514).  A tile whose every pair is
//  attendable skips the per-element mask.
//  Shared memory: a 64-row tile of 64 dims is one box of 128-byte rows with
//  the 128-byte swizzle of TMA, the canonical wgmma layout (8-row groups
//  1024 bytes apart).  D 80 (160-byte rows do not tile into 128-byte atoms)
//  takes the forward's split boxes (flash_attention_sm90.cu): the 64-column
//  box, then a 16-column box of 32-byte rows with the 32-byte swizzle
//  (flash_common.cuh: desc32), loaded from column h * 80 + 64 of the same
//  3-D tensor map.  S^T / dP^T (and S / dP) then take a fifth k-step of 16
//  on the tail boxes, and each product into dV, dK or dQ is m64n64k16 on
//  the box plus m64n16k16 on the tail (flash_common.cuh: wgmma_rs on 40
//  registers), both read through the transpose bit.  A D-80 tile is 10 KB:
//  bwd_dkdv takes 40 KB for K and V, 20 KB a ring stage, ~145 KB in all;
//  bwd_dq the same.  The ring keeps 5 stages at both head dims.
//  Tensor maps are 3-D, {heads * D, S, B}, so a ragged last tile reads
//  zeros and never the next batch row; a row past Sq has lse +inf (P = 0)
//  and a key past Skv is masked by its int32-max position.
// Written in plain PTX (no CuTe), which keeps the nvcc build at seconds.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_common.cuh"

namespace {

using flash::attend;
using flash::desc;
using flash::desc32;
using flash::exp2_approx;
using flash::kLog2e;
using flash::kPadPos;
using flash::mbar_arrive;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::pack_a;
using flash::pin;
using flash::smem_u32;
using flash::tma_load;
using flash::wg_commit;
using flash::wg_fence;
using flash::wg_wait;
using flash::wgmma_rs;
using flash::wgmma_ss;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // consumer warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kRows = 64 * kConsumers;            // keys of a dkdv block, queries of a dq block
constexpr int kTile = 64;                         // queries of a dkdv step, keys of a dq tile
constexpr int kBox = kTile * 64 * 2;              // one 64-row box of 64 columns: 8 KB
constexpr int kStages = 5;
constexpr int kDeltaThreads = 256;

// A 64-row tile of kD dims: the 64-column box, then (D 80) the 16-column
// box of 32-byte rows at + kBox
template <int kD>
struct Tile {
  static_assert(kD == 64 || kD == 80, "head dim 64 or 80");
  static constexpr int kTail = kD - 64;
  static constexpr int kBytes = kTile * kD * 2;   // 8 KB, 10 KB at D 80
  static_assert(kBytes % 1024 == 0, "TMA boxes start on the swizzle's 1024-byte period");
};

struct Params {
  const int* qpos;
  const int* kvpos;
  const float* lse;    // (B, H, Sq) from the forward
  const float* delta;  // (B, H, Sq) from bwd_delta
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Sq, Skv, H, KV;
  long long qpos_bs, kvpos_bs;  // batch strides of the position arrays
  int causal, window;
  float sl2;    // log2(e) / sqrt(D)
  float scale;  // 1 / sqrt(D)
};

// bwd_dkdv's shared memory from a 1024-byte aligned base: K and V (a tile
// of 64 keys for each consumer warpgroup), the ring of (Q, dO) tiles, the
// ring's staged log-sum-exp, Delta and query positions (64 each), the
// barriers, then the live-tile list and its 3 ints of scratch.
template <int kD>
struct DkdvSmem {
  static constexpr int kT = Tile<kD>::kBytes;
  static constexpr int kK = 0, kV = 2 * kT;
  static constexpr int kStage = 4 * kT;              // stage s: Q at + s 2 kT, dO after it
  static constexpr int kStaged = kStage + kStages * 2 * kT;  // stage s: + s * 768
  static constexpr int kStagedBytes = 3 * kTile * 4;
  static constexpr int kBarOff = kStaged + kStages * kStagedBytes;
  static constexpr int kListOff = kBarOff + 8 * (2 * kStages + 1);
  static int bytes(int Sq) { return 1024 + kListOff + ((Sq + kTile - 1) / kTile + 3) * 4; }
};

// bwd_dq's: Q and dO (a tile of 64 rows for each consumer warpgroup), the
// ring of (K, V) tiles, the barriers, then the live-tile list and its
// scratch.
template <int kD>
struct DqSmem {
  static constexpr int kT = Tile<kD>::kBytes;
  static constexpr int kQ = 0, kDO = 2 * kT;
  static constexpr int kStage = 4 * kT;              // stage s: K at + s 2 kT, V after it
  static constexpr int kBarOff = kStage + kStages * 2 * kT;
  static constexpr int kListOff = kBarOff + 8 * (2 * kStages + 1);
  static int bytes(int Skv) { return 1024 + kListOff + ((Skv + kTile - 1) / kTile + 3) * 4; }
};

// ------------------------------------------------------------ products
// d (+)= A B^T over the kD dims, 64 x 64; A and B the K-major tiles at a
// and b: four k-steps of 16 in the 128-byte swizzled box, then (D 80) one
// in the 32-byte swizzled tail
template <int kD>
__device__ __forceinline__ void issue_dims(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, desc(a + kk * 32, 16, 1024), desc(b + kk * 32, 16, 1024), kk > 0);
  if constexpr (Tile<kD>::kTail > 0) wgmma_ss(d, desc32(a + kBox), desc32(b + kBox), 1);
}

// d += A B for k-step kk (rows 16 kk .. 16 kk + 15 of the MN-major tile:
// 2 KB of the box, 512 bytes of D 80's tail at ``tail``), A in registers
template <int kD>
__device__ __forceinline__ void issue_rows(float (&d)[kD / 2], const uint32_t (&a)[4], int kk,
                                           uint32_t box, uint32_t tail) {
  if constexpr (Tile<kD>::kTail == 0)
    wgmma_rs(d, a, desc(box + kk * 2048, kBox, 1024));
  else
    wgmma_rs(d, a, desc(box + kk * 2048, kBox, 1024), desc32(tail + kk * 512));
}

// a tile's TMA loads: the 64-column box and (D 80) the 16-column one
template <int kD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* box,
                                          const CUtensorMap* tail, uint32_t bar, int col,
                                          int row, int b) {
  tma_load(dst, box, bar, col, row, b);
  if constexpr (Tile<kD>::kTail > 0) tma_load(dst + kBox, tail, bar, col + 64, row, b);
}

// ------------------------------------------------------------- 1. Delta
// Delta of row (b, i, h), rows in memory order: 8 threads a row, 16 bytes
// (8 dims) a load
template <int kD>
__global__ void __launch_bounds__(kDeltaThreads)
    bwd_delta(const bf16* __restrict__ out, const bf16* __restrict__ dout, float* delta, int Sq,
              int H, long long rows) {
  const long long row = ((long long)blockIdx.x * kDeltaThreads + threadIdx.x) >> 3;
  const int part = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int u = 0; u < (kD / 8 + 7) / 8; ++u) {
      const int j = part + 8 * u;
      if (j < kD / 8) {
        const uint4 o = __ldg(reinterpret_cast<const uint4*>(out + row * kD) + j);
        const uint4 d = __ldg(reinterpret_cast<const uint4*>(dout + row * kD) + j);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]), g = __bfloat1622float2(d2[e]);
          acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
        }
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part == 0 && row < rows) {
    const long long bi = row / H;  // b * Sq + i
    const int h = (int)(row - bi * H);
    const long long b = bi / Sq;
    delta[(b * H + h) * Sq + (bi - b * Sq)] = acc;
  }
}

// ------------------------------------------------------------ 2. dK, dV
// tmQ, tmK, tmV, tmO: the 64-column boxes; tmQt ... tmOt: D 80's 16-column
// boxes (unused at D 64; after the parameters, so D 64's offsets stay)
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
             const __grid_constant__ CUtensorMap tmV, const __grid_constant__ CUtensorMap tmO,
             const Params p, const __grid_constant__ CUtensorMap tmQt,
             const __grid_constant__ CUtensorMap tmKt, const __grid_constant__ CUtensorMap tmVt,
             const __grid_constant__ CUtensorMap tmOt) {
  using L = DkdvSmem<kD>;
  constexpr int kT = L::kT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));   // the same, generic
  const uint32_t bar_full = base + L::kBarOff, bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;
  int* list = reinterpret_cast<int*>(gbase + L::kListOff);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int hk = blockIdx.x, b = blockIdx.y, G = p.H / p.KV;
  const int k0 = blockIdx.z * kRows;
  const int* qpos = p.qpos + b * p.qpos_bs;
  const int* kvpos = p.kvpos + b * p.kvpos_bs;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1 + 32);   // the TMA thread and the staging warp
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 4 * kT);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      load_tile<kD>(base + L::kK + half * kT, &tmK, &tmKt, bar_kv, hk * kD, k0 + half * kTile, b);
      load_tile<kD>(base + L::kV + half * kT, &tmV, &tmVt, bar_kv, hk * kD, k0 + half * kTile, b);
    }
  }
  __syncthreads();  // the barriers are initialised for every thread
  const int nq = (p.Sq + kTile - 1) / kTile;
  const int nlive = flash::live_q_tiles<kTile, kRows, kThreads>(
      qpos, p.Sq, kvpos, k0, p.Skv, p.causal, p.window, list, list + nq);
  const int steps = G * nlive;  // every head of the group, every live query tile

  if (wg == kConsumers) {
    // ---- producer warpgroup: thread 0 loads (Q, dO) tiles, warp 1 stages
    // each step's log-sum-exp, Delta and query positions
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = tid - 128 * kConsumers, lane = tid & 31;
    if (ptid == 0) {
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages, h = hk * G + i / nlive;
        const int q0 = (list[i % nlive] >> 1) * kTile;
        if (i >= kStages) mbar_wait(bar_empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st, qs = base + L::kStage + st * 2 * kT;
        mbar_expect_tx(full, 2 * kT);
        load_tile<kD>(qs, &tmQ, &tmQt, full, h * kD, q0, b);
        load_tile<kD>(qs + kT, &tmO, &tmOt, full, h * kD, q0, b);
      }
    } else if (ptid >= 32 && ptid < 64) {
      for (int i = 0; i < steps; ++i) {
        const int st = i % kStages, h = hk * G + i / nlive;
        const int q0 = (list[i % nlive] >> 1) * kTile;
        if (i >= kStages) mbar_wait(bar_empty + 8 * st, (i / kStages - 1) & 1);
        float* lse_s = reinterpret_cast<float*>(gbase + L::kStaged + st * L::kStagedBytes);
        float* dl_s = lse_s + kTile;
        int* qp_s = reinterpret_cast<int*>(dl_s + kTile);
        const long long row0 = ((long long)b * p.H + h) * p.Sq;
#pragma unroll
        for (int r = lane; r < kTile; r += 32) {
          const int q = q0 + r;
          const bool ok = q < p.Sq;
          lse_s[r] = ok ? __ldg(p.lse + row0 + q) : INFINITY;  // P = 0 on a missing row
          dl_s[r] = ok ? __ldg(p.delta + row0 + q) : 0.f;
          qp_s[r] = ok ? __ldg(qpos + q) : 0;
        }
        mbar_arrive(bar_full + 8 * st);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
    const int kr0 = k0 + 64 * wg + 16 * warp + g, kr1 = kr0 + 8;
    const int kp0 = kr0 < p.Skv ? kvpos[kr0] : kPadPos, kp1 = kr1 < p.Skv ? kvpos[kr1] : kPadPos;
    const uint32_t ks = base + L::kK + wg * kT, vs = base + L::kV + wg * kT;
    float dk[kD / 2], dv[kD / 2], st_[32], dpt[32];
    uint32_t pa[4][4] = {}, pd[4][4] = {};
#pragma unroll
    for (int x = 0; x < kD / 2; ++x) dk[x] = dv[x] = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) st_[x] = dpt[x] = 0.f;
    mbar_wait(bar_kv, 0);
    __syncwarp();

    // Step i: S^T = K Q^T and dP^T = V dO^T issued together (two groups);
    // P^T once S^T is in, while dP^T runs; dV += P^T dO issued, dS^T once
    // dP^T is in, while dV runs; dK += dS^T Q issued; every product waited
    // for before the step ends (a product in flight across the loop's back
    // edge makes ptxas serialise every wgmma of the kernel).
    for (int i = 0; i < steps; ++i) {
      const int st = i % kStages;
      const uint32_t qs = base + L::kStage + st * 2 * kT, dos = qs + kT;
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::kStaged + st * L::kStagedBytes);
      const float* dl_s = lse_s + kTile;
      const int* qp_s = reinterpret_cast<const int*>(dl_s + kTile);
      mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
      __syncwarp();
      wg_fence();
      issue_dims<kD>(st_, ks, qs);
      wg_commit();
      issue_dims<kD>(dpt, vs, dos);
      wg_commit();
      const int entry = list[i % nlive];
      wg_wait<1>();  // S^T; dP^T may run on
      pin(st_);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + nb * 8 + 2 * c);
        st_[4 * nb + 0] = exp2_approx(fmaf(st_[4 * nb + 0], p.sl2, -ls.x));
        st_[4 * nb + 1] = exp2_approx(fmaf(st_[4 * nb + 1], p.sl2, -ls.y));
        st_[4 * nb + 2] = exp2_approx(fmaf(st_[4 * nb + 2], p.sl2, -ls.x));
        st_[4 * nb + 3] = exp2_approx(fmaf(st_[4 * nb + 3], p.sl2, -ls.y));
      }
      if (entry & 1) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int qp = qp_s[nb * 8 + 2 * c + j];
            if (!attend(qp, kp0, p.causal, p.window)) st_[4 * nb + j] = 0.f;
            if (!attend(qp, kp1, p.causal, p.window)) st_[4 * nb + 2 + j] = 0.f;
          }
      }
      pack_a(pa, st_);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rows<kD>(dv, pa[kk], kk, dos, dos + kBox);
      wg_commit();
      wg_wait<1>();  // dP^T; dV may run on (it reads pa: dS^T goes to pd)
      pin(dpt);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + nb * 8 + 2 * c);
        st_[4 * nb + 0] *= dpt[4 * nb + 0] - d2.x;
        st_[4 * nb + 1] *= dpt[4 * nb + 1] - d2.y;
        st_[4 * nb + 2] *= dpt[4 * nb + 2] - d2.x;
        st_[4 * nb + 3] *= dpt[4 * nb + 3] - d2.y;
      }
      pack_a(pd, st_);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rows<kD>(dk, pd[kk], kk, qs, qs + kBox);
      wg_commit();
      wg_wait<0>();
      pin(dk);
      pin(dv);
      pin(pa);
      pin(pd);
      // the stage is free once both warpgroups are done with it
      if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // the accumulator's 8-column block nb holds dims nb * 8 + 2c, + 1 (at D
    // 80 blocks 8 and 9 are the tail product's)
    const long long kvrs = (long long)p.KV * kD;
    bf16* DK = p.dk + (long long)b * p.Skv * kvrs + (long long)hk * kD;
    bf16* DV = p.dv + (long long)b * p.Skv * kvrs + (long long)hk * kD;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const int col = nb * 8 + 2 * c;
      if (kr0 < p.Skv) {
        *reinterpret_cast<__nv_bfloat162*>(DK + kr0 * kvrs + col) =
            __floats2bfloat162_rn(dk[4 * nb] * p.scale, dk[4 * nb + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(DV + kr0 * kvrs + col) =
            __floats2bfloat162_rn(dv[4 * nb], dv[4 * nb + 1]);
      }
      if (kr1 < p.Skv) {
        *reinterpret_cast<__nv_bfloat162*>(DK + kr1 * kvrs + col) =
            __floats2bfloat162_rn(dk[4 * nb + 2] * p.scale, dk[4 * nb + 3] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(DV + kr1 * kvrs + col) =
            __floats2bfloat162_rn(dv[4 * nb + 2], dv[4 * nb + 3]);
      }
    }
  }
}

// ------------------------------------------------------------------ 3. dQ
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
           const __grid_constant__ CUtensorMap tmV, const __grid_constant__ CUtensorMap tmO,
           const Params p, const __grid_constant__ CUtensorMap tmQt,
           const __grid_constant__ CUtensorMap tmKt, const __grid_constant__ CUtensorMap tmVt,
           const __grid_constant__ CUtensorMap tmOt) {
  using L = DqSmem<kD>;
  constexpr int kT = L::kT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_full = base + L::kBarOff, bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;
  int* list = reinterpret_cast<int*>(gbase + L::kListOff);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (p.H / p.KV);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int* qpos = p.qpos + b * p.qpos_bs;
  const int* kvpos = p.kvpos + b * p.kvpos_bs;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 4 * kT);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      load_tile<kD>(base + L::kQ + half * kT, &tmQ, &tmQt, bar_q, h * kD, q0 + half * kTile, b);
      load_tile<kD>(base + L::kDO + half * kT, &tmO, &tmOt, bar_q, h * kD, q0 + half * kTile, b);
    }
  }
  __syncthreads();
  const int ntiles = flash::live_tiles<kRows, kTile, kThreads>(
      qpos, q0, p.Sq, kvpos, p.Skv, p.causal, p.window, list,
      list + (p.Skv + kTile - 1) / kTile);

  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring of K/V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 128 * kConsumers) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages, key0 = (list[i] >> 1) * kTile;
        if (i >= kStages) mbar_wait(bar_empty + 8 * st, (i / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st, ks = base + L::kStage + st * 2 * kT;
        mbar_expect_tx(full, 2 * kT);
        load_tile<kD>(ks, &tmK, &tmKt, full, hk * kD, key0, b);
        load_tile<kD>(ks + kT, &tmV, &tmVt, full, hk * kD, key0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const long long row = ((long long)b * p.H + h) * p.Sq;
    const bool ok0 = r0 < p.Sq, ok1 = r1 < p.Sq;
    const int qp0 = ok0 ? qpos[r0] : 0, qp1 = ok1 ? qpos[r1] : 0;
    const float lse0 = ok0 ? p.lse[row + r0] : INFINITY, lse1 = ok1 ? p.lse[row + r1] : INFINITY;
    const float dl0 = ok0 ? p.delta[row + r0] : 0.f, dl1 = ok1 ? p.delta[row + r1] : 0.f;
    const uint32_t qs = base + L::kQ + wg * kT, dos = base + L::kDO + wg * kT;
    float dq[kD / 2], s[32], dp[32];
    uint32_t pd[4][4] = {};
#pragma unroll
    for (int x = 0; x < kD / 2; ++x) dq[x] = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    mbar_wait(bar_q, 0);
    __syncwarp();

    // Tile t: S = Q K^T and dP = dO V^T issued together (two groups); P
    // once S is in, while dP runs; dS = P o (dP - Delta), dQ += dS K; every
    // product waited for before the tile ends (see bwd_dkdv).
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      const uint32_t ks = base + L::kStage + st * 2 * kT, vs = ks + kT;
      mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
      __syncwarp();
      wg_fence();
      issue_dims<kD>(s, qs, ks);
      wg_commit();
      issue_dims<kD>(dp, dos, vs);
      wg_commit();
      const int entry = list[t], key0 = (entry >> 1) * kTile;
      wg_wait<1>();  // S; dP may run on
      pin(s);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[4 * nb + j] = exp2_approx(fmaf(s[4 * nb + j], p.sl2, -lse0));
          s[4 * nb + 2 + j] = exp2_approx(fmaf(s[4 * nb + 2 + j], p.sl2, -lse1));
        }
      if (entry & 1) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = key0 + nb * 8 + 2 * c + j;
            const int kp = n < p.Skv ? __ldg(kvpos + n) : kPadPos;
            if (!attend(qp0, kp, p.causal, p.window)) s[4 * nb + j] = 0.f;
            if (!attend(qp1, kp, p.causal, p.window)) s[4 * nb + 2 + j] = 0.f;
          }
      }
      wg_wait<0>();  // dP
      pin(dp);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[4 * nb + j] *= dp[4 * nb + j] - dl0;
          s[4 * nb + 2 + j] *= dp[4 * nb + 2 + j] - dl1;
        }
      pack_a(pd, s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) issue_rows<kD>(dq, pd[kk], kk, ks, ks + kBox);
      wg_commit();
      wg_wait<0>();
      pin(dq);
      pin(pd);
      if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * st);
    }

    const long long qrs = (long long)p.H * kD;
    bf16* DQ = p.dq + (long long)b * p.Sq * qrs + (long long)h * kD;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const int col = nb * 8 + 2 * c;
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(DQ + r0 * qrs + col) =
            __floats2bfloat162_rn(dq[4 * nb] * p.scale, dq[4 * nb + 1] * p.scale);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(DQ + r1 * qrs + col) =
            __floats2bfloat162_rn(dq[4 * nb + 2] * p.scale, dq[4 * nb + 3] * p.scale);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* qpos, const void* kvpos, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int Sq, int Skv, int H, int KV, long long qpos_bs,
           long long kvpos_bs, int causal, int window, cudaStream_t st) {
  using flash::encode;
  cudaError_t e = flash::current_context();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash::EncodeTiled fn = flash::encoder();
  if (fn == nullptr) return -3;
  CUtensorMap tmQ, tmK, tmV, tmO, tmQt, tmKt, tmVt, tmOt;
  if (!encode(fn, &tmQ, q, H, kD, Sq, B, 64, kTile) ||
      !encode(fn, &tmO, dout, H, kD, Sq, B, 64, kTile) ||
      !encode(fn, &tmK, k, KV, kD, Skv, B, 64, kTile) ||
      !encode(fn, &tmV, v, KV, kD, Skv, B, 64, kTile))
    return -2;
  if (Tile<kD>::kTail == 0) {
    tmQt = tmQ;
    tmKt = tmK;
    tmVt = tmV;
    tmOt = tmO;
  } else if (!encode(fn, &tmQt, q, H, kD, Sq, B, 16, kTile) ||
             !encode(fn, &tmOt, dout, H, kD, Sq, B, 16, kTile) ||
             !encode(fn, &tmKt, k, KV, kD, Skv, B, 16, kTile) ||
             !encode(fn, &tmVt, v, KV, kD, Skv, B, 16, kTile)) {
    return -2;
  }
  const long long rows = (long long)B * Sq * H;
  bwd_delta<kD><<<(unsigned)((rows * 8 + kDeltaThreads - 1) / kDeltaThreads), kDeltaThreads, 0,
                  st>>>(static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
                        static_cast<float*>(delta), Sq, H, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params p{static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                 static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
                 Skv, H, KV, qpos_bs, kvpos_bs, causal, window, kLog2e / sqrtf((float)kD),
                 1.0f / sqrtf((float)kD)};
  const int dkdv_smem = DkdvSmem<kD>::bytes(Sq), dq_smem = DqSmem<kD>::bytes(Skv);
  if ((e = set_smem(bwd_dkdv<kD>, dkdv_smem)) != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv<kD><<<dim3(KV, B, (Skv + kRows - 1) / kRows), kThreads, dkdv_smem, st>>>(
      tmQ, tmK, tmV, tmO, p, tmQt, tmKt, tmVt, tmOt);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = set_smem(bwd_dq<kD>, dq_smem)) != cudaSuccess) return static_cast<int>(e);
  bwd_dq<kD><<<dim3(H, B, (Sq + kRows - 1) / kRows), kThreads, dq_smem, st>>>(
      tmQ, tmK, tmV, tmO, p, tmQt, tmKt, tmVt, tmOt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, KV, D); all bf16,
// contiguous and 16-byte aligned, D 64 or 80.  lse: the forward's f32
// (B, H, Sq) log-sum-exp; delta: an f32 workspace of B * H * Sq.  Returns
// cudaGetLastError() after the launches, -1 for another head dim, -2 if a
// tensor map could not be encoded, -3 if the driver has no tensor-map
// encoder.
extern "C" int flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* qpos,
                                        const void* kvpos, const void* lse, void* delta,
                                        void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                                        int H, int KV, int D, long long qpos_bs,
                                        long long kvpos_bs, int causal, int window,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, out, dout, qpos, kvpos, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                      KV, qpos_bs, kvpos_bs, causal, window, st);
  if (D == 80)
    return launch<80>(q, k, v, out, dout, qpos, kvpos, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                      KV, qpos_bs, kvpos_bs, causal, window, st);
  return -1;
}

extern "C" const char* flash_attention_bwd_sm90_error_string(int code) {
  if (code == -1) return "unsupported head dim (64 or 80)";
  if (code == -2) return "tensor map encoding failed (shape, stride or alignment)";
  if (code == -3) return "the driver has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
