// Flash attention for a few queries against a long, mostly empty cache (an
// LM decode step) for Hopper, sm_90a: split-KV, one launch a call.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention, the
// Pallas TPU kernel (grid (B, H, q blocks, kv blocks) with the kv axis run
// in order and m, l, acc carried in VMEM scratch), for bf16 at head dims 64
// and 80 with few queries; flash_attention.cu and flash_attention_sm90.cu
// compute the same function for the other cases.
//
// Same function: scores q.k in f32 (softmax scale 1/sqrt(D), taken in base
// 2 as the other two kernels do); a key is attended when its position is
// not int32-max (padded slot), is below kv_len[b] if kv_len is given, and,
// if asked, causal (kv_pos <= q_pos) and inside a sliding window (kv_pos >
// q_pos - window); query head h reads kv head h / (H / KV) (GQA); m, l and
// acc in f32; out = acc / max(l, 1e-37) in bf16, so a row with no
// attendable key is zero.
//
// What bounds it.  One query against S keys reads 4 * S * D bytes of K and
// V for 4 * S * D operations: memory, far below the card's ~295
// operations a byte.  At a decode step most of a 4096-slot cache is empty,
// so the bytes that count are those of the attendable keys, and a block
// that fetches them one 32-key tile at a time after a scan of every tile
// pays a device-memory round trip per step of that chain.
//
// Design.  Blocks are (key split, kv head, batch row).  The host picks the
// split count from Skv, B * KV and the resident blocks of the card, so a
// full cache fills every SM once and a mostly empty one costs one wave.  A
// block's rows are the (query, query head) pairs of its kv head, 16 at a
// time (one m16 tile), so under GQA each K/V row is read once for its
// whole group.  For each window of kScan = 512 keys of its split, every
// thread reads 4 key positions with one 16-byte load (the next window's
// load is issued before the current window's keys are used), flags the
// keys that some row of the pass may attend (judged from the pass's
// smallest and largest query position) and a block scan compacts them
// into a list in key order.  The listed keys' K and V rows go to shared
// memory by cp.async 16-byte copies, kChunk = 64 keys a stage, two stages
// in flight, so a split of up to 128 attendable keys costs one
// device-memory round trip.  The products run on mma.sync m16n8k16 (bf16
// in, f32 accumulate; P rounded to bf16 for P.V as in the other two
// kernels), so their cost does not grow with the rows up to 16: each warp
// takes 16 keys of every chunk and keeps its own online softmax (m, l and
// O in registers, Q's fragments loaded once a pass), so no warp waits on
// another inside a chunk; the four warps' partials are merged through
// shared memory when the pass ends.  Each split ends in a partial (m, l,
// acc[D]) in a workspace the wrapper allocates; a split with no
// attendable key writes l = 0 and no acc.  The last block of each (batch
// row, kv head) to finish, told so by a ticket counter that it resets to
// zero for the next call, merges the partials in split order (4 splits'
// loads in flight at a time), so the result does not depend on which block
// came last.  Under 48 KB of static shared memory a block: no
// cudaFuncSetAttribute, no memset.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
using flash::kPadPos;
using flash::ldsm_x2;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kRows = 16;              // (query, head) rows a pass: one m16 tile
constexpr int kChunk = 16 * kWarps;    // keys a stage: 16 a warp
constexpr int kScan = 4 * kThreads;    // key positions a window: one int4 a thread
constexpr float kNegInf = -1.0e30f;    // the running max of a row with no key yet

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* qpos;
  const int* kvpos;
  const int* kvlen;     // (B,) or null
  __nv_bfloat16* out;
  float2* ws_ml;        // (B * KV * splits * rows) (m, l) partials
  float* ws_acc;        // (B * KV * splits * rows * D) acc partials
  int* tickets;         // (B * KV), zero between calls
  int B, Sq, Skv, H, KV;
  long long qpos_bs, kvpos_bs;  // batch strides of the position arrays
  int causal, window;
  float sl2;            // log2(e) / sqrt(D)
  int splits, split_len, vec_pos;
};

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // 16-byte rows that put ldmatrix's 8 rows on 8 bank groups
  __nv_bfloat16 k[2][kChunk][LD];   // also the warps' O partials when a pass ends
  __nv_bfloat16 v[2][kChunk][LD];
  int pos[kScan];                   // positions of the window's listed keys
  unsigned short idx[kScan];        // their offsets in the window, in key order
  float wm[kWarps][kRows], wl[kWarps][kRows];   // the warps' m and l when a pass ends
  int qp[kRows];
  int warp_sum[kWarps];
  int last;
};

// positions of keys k0 .. k0+3 (k0 a multiple of 4); int32-max past hi
__device__ __forceinline__ int4 load_pos4(const int* kvpos, int k0, int hi, int vec) {
  if (vec && k0 + 4 <= hi) return __ldg(reinterpret_cast<const int4*>(kvpos + k0));
  int4 r;
  r.x = k0 < hi ? __ldg(kvpos + k0) : kPadPos;
  r.y = k0 + 1 < hi ? __ldg(kvpos + k0 + 1) : kPadPos;
  r.z = k0 + 2 < hi ? __ldg(kvpos + k0 + 2) : kPadPos;
  r.w = k0 + 3 < hi ? __ldg(kvpos + k0 + 3) : kPadPos;
  return r;
}

// cp.async of the K and V rows of listed keys c * kChunk .. of the window
// at w0 into stage st; rows past the list up to the next 16 are zero, so
// a warp's masked keys multiply finite values
template <int D>
__device__ __forceinline__ void issue_chunk(Smem<D>& sm, const __nv_bfloat16* Kg,
                                            const __nv_bfloat16* Vg, long long kvrs, int w0,
                                            int n_live, int c, int st) {
  constexpr int P = D / 8;  // 16-byte pieces a row
  const int n = min(kChunk, n_live - c * kChunk), n16 = (n + 15) & ~15;
  for (int i = threadIdx.x; i < n16 * P; i += kThreads) {
    const int j = i / P, pc = i % P;
    const bool ok = j < n;
    const long long off = ok ? (w0 + sm.idx[c * kChunk + j]) * kvrs + pc * 8 : 0;
    cp_async16(&sm.k[st][j][pc * 8], Kg + off, ok);
    cp_async16(&sm.v[st][j][pc * 8], Vg + off, ok);
  }
}

// grid (splits, KV, B), kThreads threads.  mma.sync fragments (g = lane / 4,
// cq = lane % 4): A (16x16) a0 (g, 2cq..), a1 (g+8, 2cq..), a2 (g, 2cq+8..),
// a3 (g+8, 2cq+8..); B (16x8) b0 (k = 2cq.., n = g), b1 (k = 2cq+8.., n = g);
// C (16x8) c0,c1 (g, 2cq..), c2,c3 (g+8, 2cq..).  A warp's S (16 rows x its
// 16 keys) in C layout is P's A layout for P.V, so P stays in registers.
template <int D>
__global__ void __launch_bounds__(kThreads, 4) flash_decode_kernel(Params p) {
  constexpr int KSTEPS = D / 16, DB = D / 8, DP = D / 2;
  static_assert(D % 16 == 0 && DB % 2 == 0, "k-steps of 16 dims, P.V dim blocks in pairs");
  static_assert(sizeof(Smem<D>::k) >= sizeof(float) * kWarps * kRows * D, "O partials fit");
  using S = Smem<D>;
  __shared__ __align__(16) S sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, cq = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV, rows = p.Sq * G;
  const int bk = b * p.KV + kvh;
  const int lo = split * p.split_len, hi = min(lo + p.split_len, p.Skv);
  const int kl = p.kvlen ? p.kvlen[b] : INT_MAX;
  const int* kvpos = p.kvpos + b * p.kvpos_bs;
  const long long kvrs = static_cast<long long>(p.KV) * D;
  const __nv_bfloat16* Kg = p.k + static_cast<long long>(b) * p.Skv * kvrs + kvh * D;
  const __nv_bfloat16* Vg = p.v + static_cast<long long>(b) * p.Skv * kvrs + kvh * D;
  const long long part = (static_cast<long long>(bk) * p.splits + split) * rows;
  // the element offset of row `row` (a (query, query head) pair) in q and out
  auto qrow = [&](int row) {
    return ((static_cast<long long>(b) * p.Sq + row / G) * p.H + kvh * G + row % G) * D;
  };

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    const int nr = min(kRows, rows - r0);
    int4 kp4 = load_pos4(kvpos, lo + 4 * tid, hi, p.vec_pos);   // the first window's keys
    const bool ok0 = g < nr, ok1 = g + 8 < nr;
    const long long q0 = ok0 ? qrow(r0 + g) : 0, q1 = ok1 ? qrow(r0 + g + 8) : 0;
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = kk * 16 + 2 * cq;
      qf[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(p.q + q0 + col) : 0u;
      qf[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(p.q + q1 + col) : 0u;
      qf[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(p.q + q0 + col + 8) : 0u;
      qf[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(p.q + q1 + col + 8) : 0u;
    }
    if (tid < kRows) sm.qp[tid] = tid < nr ? p.qpos[b * p.qpos_bs + (r0 + tid) / G] : 0;
    __syncthreads();
    const int qp0 = sm.qp[g], qp1 = sm.qp[g + 8];
    int qlo = INT_MAX, qhi = INT_MIN;
    for (int r = 0; r < nr; ++r) {
      qlo = min(qlo, sm.qp[r]);
      qhi = max(qhi, sm.qp[r]);
    }
    // this warp's online softmax over its keys: rows g and g+8
    float o[DB][4];
#pragma unroll
    for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int w0 = lo; w0 < hi; w0 += kScan) {
      // the keys of this window that some row of the pass may attend
      const int k0 = w0 + 4 * tid;
      const int kp[4] = {kp4.x, kp4.y, kp4.z, kp4.w};
      unsigned live = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = k0 + e < hi && kp[e] != kPadPos && kp[e] < kl;
        if (p.causal) ok = ok && kp[e] <= qhi;
        if (p.window > 0)
          ok = ok && static_cast<long long>(kp[e]) > static_cast<long long>(qlo) - p.window;
        live |= (ok ? 1u : 0u) << e;
      }
      kp4 = load_pos4(kvpos, w0 + kScan + 4 * tid, hi, p.vec_pos);   // next window, in flight
      const int cnt = __popc(live);
      int incl = cnt;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, s);
        if (lane >= s) incl += y;
      }
      if (lane == 31) sm.warp_sum[warp] = incl;
      __syncthreads();
      int at = incl - cnt, n_live = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += sm.warp_sum[w];
        n_live += sm.warp_sum[w];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((live >> e) & 1u) {
          sm.idx[at] = static_cast<unsigned short>(4 * tid + e);
          sm.pos[at] = kp[e];
          ++at;
        }
      }
      __syncthreads();

      // their K and V rows, kChunk keys a stage, two stages in flight
      const int nch = (n_live + kChunk - 1) / kChunk;
      if (nch > 0) issue_chunk(sm, Kg, Vg, kvrs, w0, n_live, 0, 0);
      cp_async_commit();
      for (int c = 0; c < nch; ++c) {
        const int st = c & 1, n = min(kChunk, n_live - c * kChunk), jw = 16 * warp;
        if (c + 1 < nch) issue_chunk(sm, Kg, Vg, kvrs, w0, n_live, c + 1, st ^ 1);
        cp_async_commit();  // possibly empty: keeps "all but the newest" = chunk c
        cp_async_wait_one();
        __syncthreads();
        if (jw < n) {        // a warp with no key of this chunk leaves its softmax alone
          const __nv_bfloat16* ks = &sm.k[st][jw][0];
          const __nv_bfloat16* vs = &sm.v[st][jw][0];
          constexpr int LD = S::LD;
          // S = Q K^T for the 16 rows x this warp's 16 keys
          float s[2][4];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
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
              ldsm_x2(kb, ks + (nb * 8 + (lane & 7)) * LD + (KSTEPS - 1) * 16
                              + ((lane >> 3) & 1) * 8);
              mma_bf16(s[nb], qf[KSTEPS - 1], kb[0], kb[1]);
            }
          }
          // mask (a masked score becomes kNegInf, which no product of bf16
          // values reaches), row max (a row's 16 values live in the 4 lanes of a quad)
          float mx0 = m0, mx1 = m1;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int j = jw + nb * 8 + 2 * cq + jj;
              const int kpj = j < n ? sm.pos[c * kChunk + j] : kPadPos;
              if (!attend(qp0, kpj, p.causal, p.window)) s[nb][jj] = kNegInf;
              if (!attend(qp1, kpj, p.causal, p.window)) s[nb][2 + jj] = kNegInf;
              mx0 = fmaxf(mx0, s[nb][jj]);
              mx1 = fmaxf(mx1, s[nb][2 + jj]);
            }
          }
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
          const float corr0 = exp2_approx((m0 - mx0) * p.sl2);
          const float corr1 = exp2_approx((m1 - mx1) * p.sl2);
          const float ms0 = mx0 * p.sl2, ms1 = mx1 * p.sl2;
          float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              s[nb][jj] = s[nb][jj] != kNegInf ? exp2_approx(fmaf(s[nb][jj], p.sl2, -ms0)) : 0.f;
              s[nb][2 + jj] =
                  s[nb][2 + jj] != kNegInf ? exp2_approx(fmaf(s[nb][2 + jj], p.sl2, -ms1)) : 0.f;
              sum0 += s[nb][jj];
              sum1 += s[nb][2 + jj];
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
          uint32_t a[4];
          a[0] = pack_bf16(s[0][0], s[0][1]);
          a[1] = pack_bf16(s[0][2], s[0][3]);
          a[2] = pack_bf16(s[1][0], s[1][1]);
          a[3] = pack_bf16(s[1][2], s[1][3]);
          // matrices: (keys +0, dims db), (keys +8, db), (+0, db+1), (+8, db+1)
          const __nv_bfloat16* vrow =
              vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int db = 0; db < DB; db += 2) {
            uint32_t vb[4];
            ldsm_x4_trans(vb, vrow + db * 8);
            mma_bf16(o[db], a, vb[0], vb[1]);
            mma_bf16(o[db + 1], a, vb[2], vb[3]);
          }
        }
        __syncthreads();  // this stage is refilled next
      }
    }

    // the four warps' partials of the pass, merged in warp order
    float* ex = reinterpret_cast<float*>(&sm.k[0][0][0]);   // [kWarps][kRows][D]
    if (cq == 0) {
      sm.wm[warp][g] = m0;
      sm.wm[warp][g + 8] = m1;
      sm.wl[warp][g] = l0;
      sm.wl[warp][g + 8] = l1;
    }
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      float* e0 = ex + (warp * kRows + g) * D + db * 8 + 2 * cq;
      *reinterpret_cast<float2*>(e0) = make_float2(o[db][0], o[db][1]);
      *reinterpret_cast<float2*>(e0 + 8 * D) = make_float2(o[db][2], o[db][3]);
    }
    __syncthreads();
    for (int i = tid; i < nr * DP; i += kThreads) {
      const int r = i / DP, dp = i % DP, row = r0 + r;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (sm.wl[w][r] > 0.f) M = fmaxf(M, sm.wm[w][r]);
      float L = 0.f;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm.wl[w][r] > 0.f) {
          const float f = exp2_approx((sm.wm[w][r] - M) * p.sl2);
          const float2 x = *reinterpret_cast<const float2*>(ex + (w * kRows + r) * D + 2 * dp);
          L += sm.wl[w][r] * f;
          acc.x += x.x * f;
          acc.y += x.y * f;
        }
      }
      if (dp == 0) p.ws_ml[part + row] = make_float2(M, L);    // this split's partial
      if (L > 0.f) reinterpret_cast<float2*>(p.ws_acc + (part + row) * D)[dp] = acc;
    }
    __syncthreads();  // the next pass refills the stages
  }

  // the last split of (b, kv head) to finish merges the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(p.tickets + bk, 1) == p.splits - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const long long first = static_cast<long long>(bk) * p.splits * rows;
  for (int i = tid; i < rows * DP; i += kThreads) {
    const int row = i / DP, dp = i % DP;
    float M = kNegInf, L = 0.f;
    float2 o = make_float2(0.f, 0.f);
    for (int s0 = 0; s0 < p.splits; s0 += 4) {
      float2 ml[4], a[4];   // 4 splits' loads in flight; an empty split's acc is never used
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u < p.splits) {
          const long long at = first + static_cast<long long>(s0 + u) * rows + row;
          ml[u] = __ldcg(p.ws_ml + at);
          a[u] = __ldcg(reinterpret_cast<const float2*>(p.ws_acc + at * D) + dp);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u < p.splits && ml[u].y > 0.f) {   // in split order
          const float Mn = fmaxf(M, ml[u].x);
          const float fo = exp2_approx((M - Mn) * p.sl2), fa = exp2_approx((ml[u].x - Mn) * p.sl2);
          L = L * fo + ml[u].y * fa;
          o.x = o.x * fo + a[u].x * fa; o.y = o.y * fo + a[u].y * fa;
          M = Mn;
        }
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-37f);
    *reinterpret_cast<__nv_bfloat162*>(p.out + qrow(row) + 2 * dp) =
        __floats2bfloat162_rn(o.x * inv, o.y * inv);
  }
  if (tid == 0) p.tickets[bk] = 0;  // zero again for the next call on this stream
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const dim3 grid(p.splits, p.KV, p.B);
  flash_decode_kernel<D><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Resident blocks an SM of the kernel at head dim D (64 or 80), for the
// wrapper's choice of the split count; -1 for another head dim.
extern "C" int flash_decode_blocks_per_sm(int D) {
  int n = 0;
  cudaError_t e;
  if (D == 80)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_decode_kernel<80>, kThreads, 0);
  else if (D == 64)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_decode_kernel<64>, kThreads, 0);
  else
    return -1;
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// bf16 q (B, Sq, H, D), k and v (B, Skv, KV, D); int32 positions with batch
// strides; kv_len int32 (B,) or null; out bf16 like q.  ``splits`` key
// splits of ``split_len`` keys (a multiple of 64; the last may be short);
// ws_ml holds B*KV*splits*Sq*(H/KV) float2 and ws_acc that many times D
// floats, and ``tickets`` B*KV ints that are zero (and are zero again when
// the kernel ends).  Returns cudaGetLastError() after the launch, or -1
// for arguments this file has no kernel for.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v, const void* qpos,
                                const void* kvpos, const void* kvlen, void* out, void* ws_ml,
                                void* ws_acc, void* tickets, int B, int Sq, int Skv, int H,
                                int KV, int D, long long qpos_bs, long long kvpos_bs,
                                int causal, int window, int splits, int split_len,
                                void* stream) {
  if ((D != 64 && D != 80) || B < 1 || B > 65535 || KV < 1 || KV > 65535 || H % KV ||
      splits < 1 || split_len < kChunk || split_len % kChunk ||
      static_cast<long long>(splits - 1) * split_len >= (Skv > 0 ? Skv : 1) ||
      !ws_ml || !ws_acc || !tickets)
    return -1;
  const int* kp = static_cast<const int*>(kvpos);
  const int vec = reinterpret_cast<uintptr_t>(kp) % 16 == 0 && kvpos_bs % 4 == 0;
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos), kp,
           static_cast<const int*>(kvlen), static_cast<__nv_bfloat16*>(out),
           static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc), static_cast<int*>(tickets),
           B, Sq, Skv, H, KV, qpos_bs, kvpos_bs, causal, window,
           1.4426950408889634f / sqrtf(static_cast<float>(D)), splits, split_len, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D == 80 ? launch<80>(p, st) : launch<64>(p, st));
}

extern "C" const char* flash_decode_error_string(int code) {
  if (code < 0) return "unsupported head dim, shape or split";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
