// Flash attention (tiled online softmax) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention, the
// Pallas TPU kernel (grid (B, H, q blocks, kv blocks) with the kv axis
// run in order and m, l, acc carried in VMEM scratch).
//
// Same function: scores q.k / sqrt(D) in f32; a key is attended when its
// position is not int32-max (padded slot), and, if asked, causal
// (kv_pos <= q_pos) and inside a sliding window (kv_pos > q_pos - window);
// query head h reads kv head h / (H / KV) (GQA); m, l and acc are f32;
// out = acc / max(l, 1e-37) in the input type.
//
// Design.  Blocks run in parallel and in no order on the GPU, so one
// block owns one (batch, head, q tile) and the TPU's sequential kv grid
// axis becomes a loop inside the block: K and V tiles are staged in shared
// memory and the online-softmax state stays in registers.
//
// Head dims 64 and 80 (Zamba2's shared attention, 2560 / 32) in bf16, run
// for 9-127 queries (ops.py: flash_kernel) and for the training forward's
// few-query calls (FlashAttention never takes flash_decode.cu, which writes
// no log-sum-exp); from 128 queries up, and at D = 128, bf16 runs on
// flash_attention_sm90.cu (wgmma + TMA); f32 at 32 (the reduced configs'
// head dim, which the CLI trains), 64, 80 and 128.  Both kernels write each
// row's log-sum-exp when given a buffer (the backward's input:
// kernels/ref.py: flash_attention_lse_ref; f32's for
// flash_attention_bwd_f32.cu).  D = 80 keeps the
// design: 5 k-steps of 16 dims for Q.K^T (the odd last one reads its K
// fragment with ldmatrix.x2), 10 8-dim blocks for P.V (paired by
// ldmatrix.x4.trans), and shared-memory rows of 88 bf16 (176 B, a
// multiple of 16 for cp.async and ldmatrix, and conflict-free: the 8 rows
// of one ldmatrix start in 8 distinct 4-bank groups).
//
// What bounds it.  At the LM's prefill (S 4096, D = 80) the
// work is ~4*S*Skv*D operations against ~4*S*D bytes per head, far above
// the card's ~295 operations per byte: tensor-core throughput bounds it.
// bf16 therefore runs on mma.sync m16n8k16 tensor-core products (f32
// accumulate): four warps, 16 query rows each, 32-key tiles, P converted
// to bf16 in registers for the P.V product, K/V fragments read with
// ldmatrix, and the next K/V tile loaded by cp.async while the current
// one is multiplied.  The softmax's elementwise work competes with the
// mma.sync issue slots, so a tile that needs no mask skips it.  f32 (the
// reduced configs' training and the checks, not serving) runs the same
// design on 3xTF32 mma.sync m16n8k8 products (the f32 section below):
// 2 x 2048 tokens at D 32 take ~2.15 GFLOP over the causal pairs, three
// TF32 products each, far above the card's operations per byte.
//
// Both kernels visit only the key tiles that may hold an attendable pair
// for the block's queries (flash_common.cuh: live_tiles), judged from the
// positions, so a causal prefill walks about half the tiles and a decode
// step over a mostly empty cache only the filled ones.  The reference's
// skip_upper does the same for contiguous positions only.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "flash_common.cuh"
#include "flash_tf32.cuh"

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

constexpr float kNegInf = -1.0e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kvpos;
  void* out;
  float* lse;  // (B, H, Sq) or null: each row's log-sum-exp
  int B, Sq, Skv, H, KV;
  long long qpos_bs, kvpos_bs;  // batch strides of the position arrays
  int causal, window;
  float scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------- bf16
// Fragment layouts of mma m16n8k16: flash_common.cuh.  The C layout of a
// 16x16 slice of S equals the A layout of P, so P never leaves registers.
// K is stored [key][dim], which is B's layout for S = Q K^T (plain
// ldmatrix); V is stored [key][dim] too and ldmatrix.trans turns it into
// B's layout for O = P V.  K/V tiles go
// through two shared-memory stages: tile t+1 is in flight (cp.async)
// while tile t is multiplied.
constexpr int kWarps = 4, kThreads = 32 * kWarps;  // 16 query rows per warp
constexpr int kBN = 32;                             // keys per tile

template <int D>
constexpr int bf16_smem_bytes() {
  return 2 * 2 * kBN * (D + 8) * 2 + 2 * kBN * 4;  // 2 stages x (K, V) + kv positions
}

// shared memory after the tiles: the live-tile list (one int per key tile)
// and live_tiles' 3 ints of scratch
inline int list_bytes(int Skv, int BN) { return ((Skv + BN - 1) / BN + 3) * 4; }

// The live key tiles of this block's queries (flash_common.cuh), written
// to ``live``; returns how many.
template <int BM, int BN, int kThreads>
__device__ __forceinline__ int ntiles_live(const Params& p, int b, int* live) {
  return flash::live_tiles<BM, BN, kThreads>(p.qpos + b * p.qpos_bs, blockIdx.x * BM, p.Sq,
                                             p.kvpos + b * p.kvpos_bs, p.Skv, p.causal,
                                             p.window, live, live + (p.Skv + BN - 1) / BN);
}

// One block's work; kLse: also write each row's log-sum-exp to p.lse (the
// training forward's entry, flash_fwd_bf16_lse).
template <int D, bool kLse>
__device__ __forceinline__ void fwd_bf16(const Params& p) {
  constexpr int BM = 16 * kWarps, BN = kBN, LD = D + 8;  // +8: no bank conflicts
  constexpr int KSTEPS = D / 16, DB = D / 8, NB = BN / 8, TILE = BN * LD;
  static_assert(D % 16 == 0 && DB % 2 == 0, "k-steps of 16 dims, P.V dim blocks in pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BN][LD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                            // [2][BN][LD]
  int* kvp_s = reinterpret_cast<int*>(Vs + 2 * TILE);           // [2][BN]
  int* live = kvp_s + 2 * BN;                                   // [ntiles + 3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.KV);
  const long long qrs = (long long)p.H * D;   // row strides, elements
  const long long kvrs = (long long)p.KV * D;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + (long long)b * p.Sq * qrs + (long long)h * D;
  const __nv_bfloat16* Kg =
      static_cast<const __nv_bfloat16*>(p.k) + (long long)b * p.Skv * kvrs + (long long)hk * D;
  const __nv_bfloat16* Vg =
      static_cast<const __nv_bfloat16*>(p.v) + (long long)b * p.Skv * kvrs + (long long)hk * D;

  const int r0 = blockIdx.x * BM + warp * 16 + g, r1 = r0 + 8;
  const bool ok_r0 = r0 < p.Sq, ok_r1 = r1 < p.Sq;
  const int qp0 = ok_r0 ? p.qpos[b * p.qpos_bs + r0] : 0;
  const int qp1 = ok_r1 ? p.qpos[b * p.qpos_bs + r1] : 0;

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 16 + 2 * c;
    qf[kk][0] = ok_r0 ? ld32(Q + r0 * qrs + col) : 0u;
    qf[kk][1] = ok_r1 ? ld32(Q + r1 * qrs + col) : 0u;
    qf[kk][2] = ok_r0 ? ld32(Q + r0 * qrs + col + 8) : 0u;
    qf[kk][3] = ok_r1 ? ld32(Q + r1 * qrs + col + 8) : 0u;
  }

  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  // scores are kept unscaled; the softmax runs in base 2 with
  // log2(e) / sqrt(D) folded into one FMA per element
  const float sl2 = p.scale * 1.4426950408889634f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  auto load_tile = [&](int n0, int st) {
    __nv_bfloat16* ks = Ks + st * TILE;
    __nv_bfloat16* vs = Vs + st * TILE;
    for (int i = tid; i < BN * D / 8; i += kThreads) {
      const int row = i / (D / 8), cc = (i % (D / 8)) * 8;
      const int n = n0 + row;
      const long long off = n < p.Skv ? n * kvrs + cc : 0;
      cp_async16(ks + row * LD + cc, Kg + off, n < p.Skv);
      cp_async16(vs + row * LD + cc, Vg + off, n < p.Skv);
    }
    if (tid < BN) {
      const int n = n0 + tid;
      kvp_s[st * BN + tid] = n < p.Skv ? p.kvpos[b * p.kvpos_bs + n] : kPadPos;
    }
  };

  const int ntiles = ntiles_live<BM, BN, kThreads>(p, b, live);
  if (ntiles > 0) load_tile((live[0] >> 1) * BN, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) load_tile((live[t + 1] >> 1) * BN, st ^ 1);
    cp_async_commit();  // possibly empty: keeps "all but the newest" = tile t
    cp_async_wait_one();
    __syncthreads();
    // every pair of the tile attendable (no padding, no causal or window
    // cut): the per-element mask is skipped
    const bool full = !(live[t] & 1);
    const __nv_bfloat16* ks = Ks + st * TILE;
    const __nv_bfloat16* vs = Vs + st * TILE;
    const int* kvp = kvp_s + st * BN;

    // S = Q K^T for this warp's 16 rows x BN keys (one ldmatrix.x4 feeds
    // two k-steps of one 8-key block; an odd last k-step, D = 80, takes
    // an ldmatrix.x2)
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (nb * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
        mma_bf16(s[nb], qf[kk], kb[0], kb[1]);
        mma_bf16(s[nb], qf[kk + 1], kb[2], kb[3]);
      }
      if constexpr (KSTEPS % 2 == 1) {
        uint32_t kb[2];
        ldsm_x2(kb, ks + (nb * 8 + (lane & 7)) * LD + (KSTEPS - 1) * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[nb], qf[KSTEPS - 1], kb[0], kb[1]);
      }
    }

    // mask, row max (a row's BN values live in the 4 lanes of a quad)
    bool ok[NB][4];
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (full) {
          ok[nb][j] = ok[nb][2 + j] = true;
        } else {
          const int kp = kvp[nb * 8 + 2 * c + j];
          ok[nb][j] = attend(qp0, kp, p.causal, p.window);
          ok[nb][2 + j] = attend(qp1, kp, p.causal, p.window);
          if (!ok[nb][j]) s[nb][j] = kNegInf;
          if (!ok[nb][2 + j]) s[nb][2 + j] = kNegInf;
        }
        mx0 = fmaxf(mx0, s[nb][j]);
        mx1 = fmaxf(mx1, s[nb][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = exp2_approx((m0 - mx0) * sl2), corr1 = exp2_approx((m1 - mx1) * sl2);
    const float ms0 = mx0 * sl2, ms1 = mx1 * sl2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nb][j] = ok[nb][j] ? exp2_approx(fmaf(s[nb][j], sl2, -ms0)) : 0.f;
        s[nb][2 + j] = ok[nb][2 + j] ? exp2_approx(fmaf(s[nb][2 + j], sl2, -ms1)) : 0.f;
        sum0 += s[nb][j];
        sum1 += s[nb][2 + j];
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
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      o[db][0] *= corr0;
      o[db][1] *= corr0;
      o[db][2] *= corr1;
      o[db][3] *= corr1;
    }

    // O += P V, P as the A operand straight from the S registers
#pragma unroll
    for (int k2 = 0; k2 < BN / 16; ++k2) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
      a[1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
      a[2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
      a[3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
      // matrices: (keys +0, dims db), (keys +8, db), (+0, db+1), (+8, db+1)
      const __nv_bfloat16* vrow =
          vs + (k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vrow + db * 8);
        mma_bf16(o[db], a, vb[0], vb[1]);
        mma_bf16(o[db + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-37f), inv1 = 1.f / fmaxf(l1, 1e-37f);
  __nv_bfloat16* O =
      static_cast<__nv_bfloat16*>(p.out) + (long long)b * p.Sq * qrs + (long long)h * D;
#pragma unroll
  for (int db = 0; db < DB; ++db) {
    const int col = db * 8 + 2 * c;
    if (ok_r0)
      *reinterpret_cast<__nv_bfloat162*>(O + r0 * qrs + col) =
          __floats2bfloat162_rn(o[db][0] * inv0, o[db][1] * inv0);
    if (ok_r1)
      *reinterpret_cast<__nv_bfloat162*>(O + r1 * qrs + col) =
          __floats2bfloat162_rn(o[db][2] * inv1, o[db][3] * inv1);
  }
  // each row's log-sum-exp (log2 units, +inf on a row that attends no key:
  // kernels/ref.py: flash_attention_lse_ref)
  if (kLse && c == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (ok_r0) lse[r0] = l0 > 0.f ? fmaf(m0, sl2, __log2f(l0)) : INFINITY;
    if (ok_r1) lse[r1] = l1 > 0.f ? fmaf(m1, sl2, __log2f(l1)) : INFINITY;
  }
}

// The serving calls' entry (no log-sum-exp).
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  fwd_bf16<D, false>(p);
}

// The training forward's entry.  At least 3 blocks an SM: without that
// bound ptxas holds the D-80 instantiation to 128 registers and spills.
template <int D>
__global__ void __launch_bounds__(kThreads, 3) flash_fwd_bf16_lse(Params p) {
  fwd_bf16<D, true>(p);
}

// ----------------------------------------------------------------- f32
// The bf16 kernel's design with every product in 3xTF32 on mma.sync
// m16n8k8 (flash_tf32.cuh), each f32 operand split once: Q when the block
// loads it, K and V as each tile is staged (the thread that copied a chunk
// with cp.async splits it, then starts the next tile's copy into it, which
// runs while this tile is multiplied), P in registers.  A block owns T
// query rows (16 a warp) and walks the live key tiles of T keys (T:
// f32_tile).  O = P V takes P from the S registers (flash_tf32.cuh:
// tile_product), each key tile's product into a zeroed accumulator added
// to the running O with one FFMA that also applies the softmax's rescale
// (the tensor core's additions do not round to nearest).  The softmax runs
// in base 2 on unscaled scores, as the bf16 kernel's; a tile that needs no
// mask skips it.  The q tiles launch longest first (the grid's slowest
// axis, reversed), so a causal prefill does not end on its longest blocks.

// Rows of a block and keys of a tile: 64 up to D 64, 32 above (shared memory)
template <int D>
__host__ __device__ constexpr int f32_tile() { return D <= 64 ? 64 : 32; }

// Q hi / lo, K hi / lo, V hi / lo and the raw K / V stage, each [T][D + 4]
// f32, then the tiles' key positions [2][T]
template <int D>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (8 * f32_tile<D>() * (D + 4) + 2 * f32_tile<D>()) * 4;
}

// One block's work; kLse: also write each row's log-sum-exp to p.lse (the
// training forward's entry, flash_fwd_f32_lse).
template <int D, bool kLse>
__device__ __forceinline__ void fwd_f32(const Params& p) {
  constexpr int T = f32_tile<D>(), NT = 2 * T, LD = D + 4;
  constexpr int NB = T / 8, DB = D / 8;  // key blocks of a tile, dim blocks
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* Qh = reinterpret_cast<uint32_t*>(smem);  // [T][LD] each
  uint32_t* Ql = Qh + T * LD;
  uint32_t* Kh = Ql + T * LD;
  uint32_t* Kl = Kh + T * LD;
  uint32_t* Vh = Kl + T * LD;
  uint32_t* Vl = Vh + T * LD;
  float* Kr = reinterpret_cast<float*>(Vl + T * LD);  // the raw stage: Q, then K
  float* Vr = Kr + T * LD;
  int* kvp_s = reinterpret_cast<int*>(Vr + T * LD);   // [2][T]
  int* live = kvp_s + 2 * T;                          // [ntiles + 3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int hk = h / (p.H / p.KV);
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const float* Q = static_cast<const float*>(p.q) + (long long)b * p.Sq * qrs + (long long)h * D;
  const float* Kg =
      static_cast<const float*>(p.k) + (long long)b * p.Skv * kvrs + (long long)hk * D;
  const float* Vg =
      static_cast<const float*>(p.v) + (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int q0 = qt * T, wr = warp * 16;
  int row[2], qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + wr + g + 8 * i;
    qp[i] = row[i] < p.Sq ? p.qpos[b * p.qpos_bs + row[i]] : 0;
  }

  flash_tf32::stage<D, T, NT>(Kr, Q, qrs, q0, p.Sq, tid);
  cp_async_commit();
  const int ntiles = flash::live_tiles<T, T, NT>(p.qpos + b * p.qpos_bs, q0, p.Sq,
                                                 p.kvpos + b * p.kvpos_bs, p.Skv, p.causal,
                                                 p.window, live, live + (p.Skv + T - 1) / T);
  ssd::cp_async_wait_all();
  flash_tf32::split_staged<D, T, NT>(Kr, Qh, Ql, tid);

  auto load_tile = [&](int t) {
    const int n0 = (live[t] >> 1) * T;
    flash_tf32::stage<D, T, NT>(Kr, Kg, kvrs, n0, p.Skv, tid);
    flash_tf32::stage<D, T, NT>(Vr, Vg, kvrs, n0, p.Skv, tid);
    if (tid < T) {
      const int n = n0 + tid;
      kvp_s[(t & 1) * T + tid] = n < p.Skv ? p.kvpos[b * p.kvpos_bs + n] : kPadPos;
    }
  };

  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  const float sl2 = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (ntiles > 0) load_tile(0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    ssd::cp_async_wait_all();  // this thread's chunks of tile t
    __syncthreads();           // every warp is done with tile t - 1's split operands
    flash_tf32::split_staged<D, T, NT>(Kr, Kh, Kl, tid);
    flash_tf32::split_staged<D, T, NT>(Vr, Vh, Vl, tid);
    if (t + 1 < ntiles) load_tile(t + 1);  // into the chunks just split
    cp_async_commit();
    __syncthreads();
    const bool full = !(live[t] & 1);
    const int* kvp = kvp_s + (t & 1) * T;

    // S = Q K^T, this warp's 16 rows x T keys
    float s[NB][4];
    flash_tf32::rows_dot<D, NB>(s, Qh, Ql, wr, Kh, Kl, lane);

    // mask, row max (a row's T values live in the 4 lanes of a quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full && !attend(qp[e >> 1], kvp[nb * 8 + 2 * c + (e & 1)], p.causal, p.window))
          s[nb][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2_approx((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[nb][e] = s[nb][e] > 0.5f * kNegInf ? exp2_approx(fmaf(s[nb][e], sl2, -m[i] * sl2))
                                             : 0.f;
        sum[i] += s[nb][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
    flash_tf32::tile_product<D, NB>(o, s, Vh, Vl, g, c, corr);  // O = O corr + P V
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-37f), 1.f / fmaxf(l[1], 1e-37f)};
  flash_tf32::store_rows<D>(
      static_cast<float*>(p.out) + (long long)b * p.Sq * qrs + (long long)h * D, qrs, row, p.Sq,
      o, inv, c);
  // log2 units, +inf on a row that attends no key (kernels/ref.py:
  // flash_attention_lse_ref)
  if (kLse && c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.Sq)
        p.lse[((long long)b * p.H + h) * p.Sq + row[i]] =
            l[i] > 0.f ? fmaf(m[i], sl2, __log2f(l[i])) : INFINITY;
  }
}

// Blocks an SM each entry is built for: without a bound ptxas holds D 80's
// log-sum-exp entry to 128 registers and spills (and at 168, 6 blocks of 64
// threads, still does); 4 blocks of 64 threads leave it 255
template <int D>
__host__ __device__ constexpr int f32_min_blocks() { return D == 80 ? 4 : 1; }

// The entry without the log-sum-exp.
template <int D>
__global__ void __launch_bounds__(2 * f32_tile<D>(), f32_min_blocks<D>()) flash_fwd_f32(Params p) {
  fwd_f32<D, false>(p);
}

// The f32 training forward's entry.
template <int D>
__global__ void __launch_bounds__(2 * f32_tile<D>(), f32_min_blocks<D>())
    flash_fwd_f32_lse(Params p) {
  fwd_f32<D, true>(p);
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t st) {
  const auto kernel = p.lse != nullptr ? flash_fwd_bf16_lse<D> : flash_fwd_bf16<D>;
  // dynamic: may pass the 48 KiB default
  const int smem = bf16_smem_bytes<D>() + list_bytes(p.Skv, kBN);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + 16 * kWarps - 1) / (16 * kWarps), p.H, p.B);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  constexpr int T = f32_tile<D>();
  const auto kernel = p.lse != nullptr ? flash_fwd_f32_lse<D> : flash_fwd_f32<D>;
  const int smem = f32_smem_bytes<D>() + list_bytes(p.Skv, T);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // q tiles on the slowest axis, walked in reverse by the blocks: the
  // longest causal rows start first
  const dim3 grid(p.H, p.B, (p.Sq + T - 1) / T);
  kernel<<<grid, 2 * T, smem, st>>>(p);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ``lse``: an f32 (B, H, Sq) buffer for
// each row's log-sum-exp, or null.  Returns cudaGetLastError() after the
// launch, or -1 for a dtype / head dim this file has no kernel for.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kvpos, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int KV, int D,
                                   long long qpos_bs, long long kvpos_bs, int causal,
                                   int window, int dtype, void* stream) {
  Params p{q, k, v, static_cast<const int*>(qpos), static_cast<const int*>(kvpos), out,
           static_cast<float*>(lse), B, Sq, Skv, H, KV, qpos_bs, kvpos_bs, causal, window,
           1.0f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    if (D == 80) e = launch_bf16<80>(p, st);
    else if (D == 64) e = launch_bf16<64>(p, st);
    else return -1;
  } else if (dtype == 0) {
    if (D == 128) e = launch_f32<128>(p, st);
    else if (D == 80) e = launch_f32<80>(p, st);
    else if (D == 64) e = launch_f32<64>(p, st);
    else if (D == 32) e = launch_f32<32>(p, st);
    else return -1;
  } else {
    return -1;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code < 0) return "unsupported dtype or head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
