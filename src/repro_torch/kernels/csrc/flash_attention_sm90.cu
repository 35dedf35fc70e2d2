// Flash attention for Hopper with wgmma and TMA: bf16, head dim 64, 80 or
// 128, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the
// Pallas TPU kernel) for bf16 at D = 128, the video DiT's self- and
// cross-attention, at D = 80 for the hybrid LM's prefill and at D = 64 for
// the dense LM's training forward (granite), from 128 queries up (ops.py's
// flash_kernel routes by dtype, head dim and query count);
// flash_attention.cu keeps D 64 and 80 below 128 queries and f32,
// flash_decode.cu the decode step.
//
// Same function as flash_attention.cu: scores q.k / sqrt(D) in f32; a key
// is attended when its position is not int32-max, and, if asked, causal
// (kv_pos <= q_pos) and inside a sliding window (kv_pos > q_pos - window);
// query head h reads kv head h / (H / KV); m, l and acc are f32; P is
// rounded to bf16 for the P.V product; out = acc / max(l, 1e-37).
//
// What bounds it.  ~4 * Sq * Skv * D operations against ~4 * S * D bytes
// per head: the tensor cores.  mma.sync reaches a fraction of Hopper's
// rate; wgmma, a 64-row product issued by a warpgroup with its operands
// read from shared memory, is the way to the rest.
//
// Design.
//  - Two kernels per call.  A pre-pass (grid (q blocks, B), 256 threads)
//    writes the list of each (batch, 128-query block)'s live key tiles
//    (flash_common.cuh: live_tiles) into a global int32 buffer of
//    (B, q blocks, tiles + 1): entries 2 * tile + 1 (the tile has a masked
//    pair) or 2 * tile (every pair attendable) in key order, -1 after
//    them, the count last.  The caller allocates it (ops.py, torch.empty):
//    the launcher allocates nothing.  The H attention blocks of a (batch,
//    q block) read the one list, so the scan runs once instead of H times,
//    and no shared memory depends on the key count: any Skv is taken.
//  - An attention block owns 128 query rows of one (batch, head): two
//    consumer warpgroups of 64 rows and one producer warpgroup.  Q is
//    loaded once by TMA.
//  - One thread of the producer warpgroup keeps a ring of 3 K/V stages
//    full: each listed tile of 128 keys is loaded by TMA onto the stage's
//    "full" mbarrier, and the stage is refilled once both consumer
//    warpgroups have arrived on its "empty" mbarrier.  The producer gives
//    its registers up (setmaxnreg 24) and the consumers take them
//    (setmaxnreg 240).
//  - Each consumer issues tile i's S = Q K^T together with tile i-1's
//    O += P V (both asynchronous wgmma groups), waits for S only, and runs
//    the softmax of tile i while the P.V product is still on the tensor
//    cores; O takes tile i's correction just before tile i's P.V.
//  - S = Q K^T: wgmma.m64n128k16 with both operands in shared memory, one
//    per 16 dims (8 at D 128, 5 at D 80); K is stored [key][dim], which is
//    K-major for B.  The online softmax runs in f32 registers on the
//    accumulator fragment (row g and g + 8 of each warp's 16, two columns
//    in each 8-column block).
//  - O += P V with A = P converted to bf16 in registers (the accumulator's
//    layout is A's register layout) and B = V from shared memory with the
//    transpose bit (V is [key][dim], so B is MN-major: LBO steps the
//    swizzle atoms along the dims, SBO the 8-key groups).
//  - Shared-memory layout of a row of D dims.  D 128: two 64-column boxes
//    with the 128-byte swizzle; P.V is one wgmma.m64n128k16 per 16 keys
//    across both (O: 64 f32 registers).  D 80 (160-byte rows do not tile
//    into 128-byte atoms): split boxes, a 64-column box with the 128-byte
//    swizzle and a 16-column box with the 32-byte swizzle, loaded from
//    column h * 80 + 64 of the same 3-D map.  Every operand is then a
//    canonical wgmma layout: the fifth Q.K^T k-step reads the 32-byte
//    atom (descriptor layout type 3, SBO 256 = 8 rows of 32 bytes), and
//    P.V is m64n64k16 on the 64-column box plus m64n16k16 on the 16-column
//    one (O: 32 + 8 f32 registers, laid out as one 80-column fragment).
//    The padded alternative (a second 64-column box, 48 of its columns
//    out of bounds) would need P.V n80 across a partial 128-byte atom,
//    which is not a canonical layout, or n128 on 48 zero columns (37% of
//    P.V wasted).  The split boxes also take 40 KB a K/V stage (64 KB at
//    D 128) and 20 KB for Q: 141 KB of shared memory against 225 KB.
//  - D 64: one 64-column box with the 128-byte swizzle and no tail; Q.K^T
//    is 4 k-steps as at D 128, P.V one m64n64k16 per 16 keys on a
//    32-register accumulator (the first half of D 80's P.V).  16 KB K/V
//    tiles; the ring keeps 3 stages, as at D 80 and 128: a deeper one left
//    the time unchanged (tools/flash_sm90_ablation.py, stages5).
//  - An optional f32 output of each row's log-sum-exp, (B, H, Sq), for the
//    backward (flash_attention_bwd_sm90.cu, flash_attention_bwd.cu): the
//    epilogue writes it from the m and l it already holds, in the units of
//    kernels/ref.py: flash_attention_lse_ref (log2 of the sum of exp of the
//    scaled scores, +inf on a row that attends no key).  A null pointer
//    writes nothing, as the serving paths pass.
//  - Tensor maps are 3-D, {heads * D, S, B}, so the rows past S of a
//    ragged last tile are zero-filled and never the next batch's keys;
//    the mask drops them by position (int32-max) in any case.
//  - Only listed tiles are visited, and only the tiles with a masked pair
//    pay for the per-element mask.
//  - The tensor-map encoder (flash_common.cuh: encoder) is fetched with
//    cudaGetDriverEntryPoint, so the build needs no -lcuda; the maps are
//    encoded on the host for each call and passed as __grid_constant__
//    parameters.
// Written in plain PTX (no CuTe), which keeps the nvcc build at seconds.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "flash_common.cuh"

namespace {

using flash::attend;
using flash::desc;
using flash::desc32;
using flash::exp2_approx;
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

constexpr int kBM = 128;        // query rows per block: two warpgroups of 64
constexpr int kBN = 128;        // keys per tile
constexpr int kConsumers = 2;   // consumer warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kScanThreads = 256;                 // the live-tile pre-pass

// Shared memory of the head dim kD, from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes, the 32-byte swizzle
// every 8 rows of 32 bytes).  Q: [wg][box][64 rows][64 dims], then (D 80)
// [wg][64 rows][16 dims]; a K or V tile: [box][128 keys][64 dims], then
// (D 80) [128 keys][16 dims].
template <int kD>
struct Smem {
  static constexpr int kBoxes = kD / 64;                  // 64-column boxes
  static constexpr int kTail = kD % 64;                   // 16 at D 80, else 0
  static_assert(kTail == 0 || kTail == 16, "head dim 64, 80 or 128");
  // the K/V ring, at D 64 too: a deeper ring, which D 64's 16 KB tiles
  // would leave room for, bought nothing (tools/flash_sm90_ablation.py)
  static constexpr int kStages = 3;
  static constexpr int kQBox = 64 * 64 * 2;               // 64 rows x 64 dims
  static constexpr int kQBytes = kBM * kD * 2;
  static constexpr int kQTail = kConsumers * kBoxes * kQBox;  // + wg * 64 rows * 32 B
  static constexpr int kKBox = kBN * 64 * 2;              // 128 keys x 64 dims
  static constexpr int kTileBytes = kBN * kD * 2;         // one K or V tile
  static constexpr int kTileTail = kBoxes * kKBox;        // its 16-column part
  static constexpr int kKOff = kQBytes;                   // stage s at + 2 s kTileBytes
  static constexpr int kBarOff = kKOff + kStages * 2 * kTileBytes;
  static constexpr int kBytes = 1024 + kBarOff + 8 * (2 * kStages + 1);  // 1024: alignment
  static_assert(kQTail % 1024 == 0 && kKOff % 1024 == 0 && kTileBytes % 1024 == 0 &&
                    kTileTail % 1024 == 0,
                "TMA boxes start on the swizzle's 1024-byte period");
  static_assert(kBytes <= 232448, "fits a block's shared memory on Hopper (227 KB)");
};

struct Params {
  const int* qpos;
  const int* kvpos;
  const int* lists;  // (B, q blocks, ntiles + 1) from the pre-pass
  void* out;
  float* lse;        // (B, H, Sq) or null: each row's log-sum-exp (kernels/ref.py)
  int Sq, Skv, H, KV, ntiles;
  long long qpos_bs, kvpos_bs;
  int causal, window;
  float sl2;  // log2(e) / sqrt(D)
};

// named barriers 1 and 2: the two consumer warpgroups take turns to issue
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(256) : "memory");
}

#define D64_REGS                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define D64_OPS                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),        \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),        \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),        \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),        \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
// d (+)= A B, 64 x 128 x 16; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64_OPS
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, 64 x 128 x 16; A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The online softmax of one tile's scores ``s`` (two rows per thread: g
// and g + 8 of its warp's 16), in place: masked pairs (only tiles with a
// masked pair pay for the mask) become 0, the others
// exp2((s - max) * log2(e) / sqrt(D)); the running max and sum move on,
// and corr0 / corr1 receive the factor the accumulated O must take.
__device__ __forceinline__ void softmax_tile(float (&s)[64], int entry, int key0, int c,
                                             int qp0, int qp1, const Params& p,
                                             const int* kvpos, float& m0, float& m1,
                                             float& l0, float& l1, float& corr0,
                                             float& corr1) {
  if (entry & 1) {
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = key0 + nb * 8 + 2 * c + j;
        const int kp = n < p.Skv ? kvpos[n] : kPadPos;
        if (!attend(qp0, kp, p.causal, p.window)) s[4 * nb + j] = -INFINITY;
        if (!attend(qp1, kp, p.causal, p.window)) s[4 * nb + 2 + j] = -INFINITY;
      }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * nb], s[4 * nb + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // a row with no attendable key so far keeps max -inf: its masked scores
  // give exp2(-inf) = 0 and its (zero) sums any finite factor
  const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * p.sl2;
  const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * p.sl2;
  corr0 = exp2_approx(m0 * p.sl2 - ms0);
  corr1 = exp2_approx(m1 * p.sl2 - ms1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[4 * nb + j] = exp2_approx(fmaf(s[4 * nb + j], p.sl2, -ms0));
      s[4 * nb + 2 + j] = exp2_approx(fmaf(s[4 * nb + 2 + j], p.sl2, -ms1));
      sum0 += s[4 * nb + j];
      sum1 += s[4 * nb + 2 + j];
    }
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
  m0 = mx0;
  m1 = mx1;
}

// O *= the softmax's correction of its rows (accumulator index bit 1: row g + 8)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float corr0, float corr1) {
#pragma unroll
  for (int x = 0; x < N; ++x) o[x] *= (x & 2) ? corr1 : corr0;
}

// O += P V: P from the softmax's registers (k-step kk covers keys 16 kk ..
// 16 kk + 15, the 8-column blocks 2 kk and 2 kk + 1 of S), V's 16 keys two
// 8-key groups: 2 KB of the 64-column boxes (LBO steps the boxes), 512
// bytes of D 80's 16-column box
template <int kD>
__device__ __forceinline__ void issue_pv(float (&o)[kD / 2], const uint32_t (&pa)[8][4],
                                         uint32_t vs) {
  using L = Smem<kD>;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    if constexpr (L::kTail == 0)
      wgmma_rs(o, pa[kk], desc(vs + kk * 2048, L::kKBox, 1024));
    else
      wgmma_rs(o, pa[kk], desc(vs + kk * 2048, L::kKBox, 1024),
               desc32(vs + L::kTileTail + kk * 512));
  }
}

// The pre-pass: block (q block, batch) writes its list of live key tiles
// (entries in key order, -1 after them, the count at [ntiles]).
__global__ void __launch_bounds__(kScanThreads)
    live_tiles_pass(const int* qpos, const int* kvpos, int* lists, int Sq, int Skv, int ntiles,
                    long long qpos_bs, long long kvpos_bs, int causal, int window) {
  __shared__ int scratch[3];
  const int b = blockIdx.y;
  int* list = lists + ((long long)b * gridDim.x + blockIdx.x) * (ntiles + 1);
  const int count = flash::live_tiles<kBM, kBN, kScanThreads>(
      qpos + b * qpos_bs, blockIdx.x * kBM, Sq, kvpos + b * kvpos_bs, Skv, causal, window, list,
      scratch);
  for (int t = count + threadIdx.x; t < ntiles; t += kScanThreads) list[t] = -1;
  if (threadIdx.x == 0) list[ntiles] = count;
}

// tmQ, tmK, tmV: the 64-column boxes; tmQt, tmKt, tmVt: D 80's 16-column
// boxes (unused at D 128)
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __grid_constant__ CUtensorMap tmQt,
                   const __grid_constant__ CUtensorMap tmKt,
                   const __grid_constant__ CUtensorMap tmVt, const Params p) {
  using L = Smem<kD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::kBarOff;           // [kStages]
  const uint32_t bar_empty = bar_full + 8 * L::kStages;  // [kStages]
  const uint32_t bar_q = bar_empty + 8 * L::kStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.KV);
  const int q0 = blockIdx.x * kBM;
  const int* qpos = p.qpos + b * p.qpos_bs;
  const int* kvpos = p.kvpos + b * p.kvpos_bs;
  // this (batch, q block)'s live key tiles, written by the pre-pass
  const int* live = p.lists + ((long long)b * gridDim.x + blockIdx.x) * (p.ntiles + 1);

  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);  // one arrival per consumer warpgroup
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
#pragma unroll
      for (int box = 0; box < L::kBoxes; ++box)
        tma_load(base + (w * L::kBoxes + box) * L::kQBox, &tmQ, bar_q, h * kD + 64 * box,
                 q0 + 64 * w, b);
      if constexpr (L::kTail > 0)
        tma_load(base + L::kQTail + w * 64 * 32, &tmQt, bar_q, h * kD + 64 * L::kBoxes,
                 q0 + 64 * w, b);
    }
  }
  __syncthreads();  // the barriers are initialised for every thread
  const int ntiles = __ldg(live + p.ntiles);

  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring of K/V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 128 * kConsumers) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % L::kStages, key0 = (__ldg(live + i) >> 1) * kBN;
        if (i >= L::kStages) mbar_wait(bar_empty + 8 * st, (i / L::kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st, ks = base + L::kKOff + st * 2 * L::kTileBytes;
        const uint32_t vs = ks + L::kTileBytes;
        mbar_expect_tx(full, 2 * L::kTileBytes);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load(ks + box * L::kKBox, &tmK, full, hk * kD + 64 * box, key0, b);
          tma_load(vs + box * L::kKBox, &tmV, full, hk * kD + 64 * box, key0, b);
        }
        if constexpr (L::kTail > 0) {
          tma_load(ks + L::kTileTail, &tmKt, full, hk * kD + 64 * L::kBoxes, key0, b);
          tma_load(vs + L::kTileTail, &tmVt, full, hk * kD + 64 * L::kBoxes, key0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.  Tile i's S = Q K^T is
    // issued together with tile i-1's O += P V, so the tensor cores work
    // on one while the softmax of the other waits for its scores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const int qp0 = r0 < p.Sq ? qpos[r0] : 0, qp1 = r1 < p.Sq ? qpos[r1] : 0;
    const uint32_t qs = base + wg * L::kBoxes * L::kQBox, qt = base + L::kQTail + wg * 64 * 32;
    float o[kD / 2], s[64];
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int x = 0; x < kD / 2; ++x) o[x] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, corr0 = 1.f, corr1 = 1.f;
    mbar_wait(bar_q, 0);
    __syncwarp();

    // S = Q K^T of tile i into s (k-steps of 16 dims: 32 bytes inside a
    // 128-byte swizzled row, then D 80's 32-byte row), issued and
    // committed, not waited for
    auto issue_s = [&](int i) {
      const uint32_t ks = base + L::kKOff + (i % L::kStages) * 2 * L::kTileBytes;
      mbar_wait(bar_full + 8 * (i % L::kStages), (i / L::kStages) & 1);
      __syncwarp();
#pragma unroll
      for (int x = 0; x < 64; ++x) s[x] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * L::kBoxes; ++kk)
        wgmma_ss(s, desc(qs + (kk >> 2) * L::kQBox + (kk & 3) * 32, 16, 1024),
                 desc(ks + (kk >> 2) * L::kKBox + (kk & 3) * 32, 16, 1024), kk > 0);
      if constexpr (L::kTail > 0) wgmma_ss(s, desc32(qt), desc32(ks + L::kTileTail), 1);
      wg_commit();
    };
    auto vs_of = [&](int i) {
      return base + L::kKOff + (i % L::kStages) * 2 * L::kTileBytes + L::kTileBytes;
    };
    // The warpgroups take turns to issue their products (warpgroup w waits
    // on barrier 1 + w, then lets the other go), so one's softmax runs
    // while the other's products hold the tensor cores.  Each issues
    // ntiles + 1 times; warpgroup 1 opens the first turn and does not pass
    // on its last.
    const int mine = 1 + wg, other = 2 - wg;
    // (no branch between a wgmma and its wait: ptxas would serialise them)
    if (ntiles > 0) {
      if (wg == 1) bar_arrive(other);
      bar_sync(mine);
      issue_s(0);
      bar_arrive(other);
      wg_wait<0>();
      pin(s);
      int entry = __ldg(live);
      softmax_tile(s, entry, (entry >> 1) * kBN, c, qp0, qp1, p, kvpos, m0, m1, l0, l1, corr0,
                   corr1);
      pack_a(pa, s);
      for (int i = 1; i < ntiles; ++i) {
        bar_sync(mine);
        issue_s(i);
        // O = O * corr(i-1) + P(i-1) V(i-1), in flight beside S(i)
        rescale(o, corr0, corr1);
        wg_fence();
        issue_pv<kD>(o, pa, vs_of(i - 1));
        wg_commit();
        bar_arrive(other);
        entry = __ldg(live + i);
        wg_wait<1>();
        pin(s);
        softmax_tile(s, entry, (entry >> 1) * kBN, c, qp0, qp1, p, kvpos, m0, m1, l0, l1,
                     corr0, corr1);
        wg_wait<0>();
        pin(o);
        pin(pa);
        // tile i-1's stage is free once both warpgroups are done with it
        if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * ((i - 1) % L::kStages));
        pack_a(pa, s);
      }
      bar_sync(mine);
      rescale(o, corr0, corr1);
      wg_fence();
      issue_pv<kD>(o, pa, vs_of(ntiles - 1));
      wg_commit();
      if (wg == 0) bar_arrive(other);
      wg_wait<0>();
      pin(o);
    }

    // each row's log-sum-exp (log2 units, +inf on a row that attends no
    // key), when asked: m and l are whole in every lane of the row's quad
    if (p.lse != nullptr && c == 0) {
      float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
      if (r0 < p.Sq) lse[r0] = l0 > 0.f ? fmaf(m0, p.sl2, __log2f(l0)) : INFINITY;
      if (r1 < p.Sq) lse[r1] = l1 > 0.f ? fmaf(m1, p.sl2, __log2f(l1)) : INFINITY;
    }
    // the accumulator's 8-column block nb holds columns nb * 8 + 2c, + 1
    // (at D 80 blocks 8 and 9 are the 16-column product's)
    const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
    const long long qrs = (long long)p.H * kD;
    __nv_bfloat16* O =
        static_cast<__nv_bfloat16*>(p.out) + (long long)b * p.Sq * qrs + (long long)h * kD;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const int col = nb * 8 + 2 * c;
      if (r0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(O + r0 * qrs + col) =
            __floats2bfloat162_rn(o[4 * nb] * inv0, o[4 * nb + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(O + r1 * qrs + col) =
            __floats2bfloat162_rn(o[4 * nb + 2] * inv1, o[4 * nb + 3] * inv1);
    }
  }
}

cudaError_t launch_live_tiles(const void* qpos, const void* kvpos, void* lists, int B, int Sq,
                              int Skv, long long qpos_bs, long long kvpos_bs, int causal,
                              int window, cudaStream_t stream) {
  const dim3 grid((Sq + kBM - 1) / kBM, B);
  live_tiles_pass<<<grid, kScanThreads, 0, stream>>>(
      static_cast<const int*>(qpos), static_cast<const int*>(kvpos), static_cast<int*>(lists),
      Sq, Skv, (Skv + kBN - 1) / kBN, qpos_bs, kvpos_bs, causal, window);
  return cudaGetLastError();
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
           void* lists, void* out, void* lse, int B, int Sq, int Skv, int H, int KV,
           long long qpos_bs, long long kvpos_bs, int causal, int window, cudaStream_t stream) {
  using flash::encode;
  cudaError_t e = flash::current_context();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash::EncodeTiled fn = flash::encoder();
  if (fn == nullptr) return -3;
  CUtensorMap tmQ, tmK, tmV, tmQt, tmKt, tmVt;
  if (!encode(fn, &tmQ, q, H, kD, Sq, B, 64, 64) || !encode(fn, &tmK, k, KV, kD, Skv, B, 64, kBN) ||
      !encode(fn, &tmV, v, KV, kD, Skv, B, 64, kBN))
    return -2;
  if (Smem<kD>::kTail == 0) {
    tmQt = tmQ;
    tmKt = tmK;
    tmVt = tmV;
  } else if (!encode(fn, &tmQt, q, H, kD, Sq, B, 16, 64) ||
             !encode(fn, &tmKt, k, KV, kD, Skv, B, 16, kBN) ||
             !encode(fn, &tmVt, v, KV, kD, Skv, B, 16, kBN)) {
    return -2;
  }
  e = launch_live_tiles(qpos, kvpos, lists, B, Sq, Skv, qpos_bs, kvpos_bs, causal, window,
                        stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
           static_cast<const int*>(lists), out, static_cast<float*>(lse), Sq, Skv, H, KV,
           (Skv + kBN - 1) / kBN,
           qpos_bs, kvpos_bs, causal, window, 1.4426950408889634f / sqrtf((float)kD)};
  e = cudaFuncSetAttribute(flash_fwd_sm90<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Smem<kD>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_sm90<kD><<<grid, kThreads, Smem<kD>::kBytes, stream>>>(tmQ, tmK, tmV, tmQt, tmKt,
                                                                   tmVt, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B, Sq, H, D), k and v (B, Skv, KV, D), all contiguous and 16-byte
// aligned, D 64, 80 or 128; ``lists`` an int32 buffer of B * ceil(Sq / 128)
// * (ceil(Skv / 128) + 1) for the pre-pass; ``lse`` an f32 (B, H, Sq) buffer
// for each row's log-sum-exp, or null for none.  Returns cudaGetLastError()
// after the launches, -1 for another head dim, -2 if a tensor map could not
// be encoded, -3 if the driver has no tensor-map encoder.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                                        const void* qpos, const void* kvpos, void* lists,
                                        void* out, void* lse, int B, int Sq, int Skv, int H,
                                        int KV, int D, long long qpos_bs, long long kvpos_bs,
                                        int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, qpos, kvpos, lists, out, lse, B, Sq, Skv, H, KV, qpos_bs,
                       kvpos_bs, causal, window, st);
  if (D == 80)
    return launch<80>(q, k, v, qpos, kvpos, lists, out, lse, B, Sq, Skv, H, KV, qpos_bs,
                      kvpos_bs, causal, window, st);
  if (D == 64)
    return launch<64>(q, k, v, qpos, kvpos, lists, out, lse, B, Sq, Skv, H, KV, qpos_bs,
                      kvpos_bs, causal, window, st);
  return -1;
}

// The pre-pass alone (the same launch the attention makes first), so its
// lists can be checked against their plain version.
extern "C" int flash_attention_sm90_live_tiles(const void* qpos, const void* kvpos, void* lists,
                                               int B, int Sq, int Skv, long long qpos_bs,
                                               long long kvpos_bs, int causal, int window,
                                               void* stream) {
  return static_cast<int>(launch_live_tiles(qpos, kvpos, lists, B, Sq, Skv, qpos_bs, kvpos_bs,
                                            causal, window, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_sm90_error_string(int code) {
  if (code == -1) return "unsupported head dim (64, 80 or 128)";
  if (code == -2) return "tensor map encoding failed (shape, stride or alignment)";
  if (code == -3) return "the driver has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
