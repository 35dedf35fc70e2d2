// Backward of the grouped, wide-head chunked SSD scan (mamba_ssd_wide.cu)
// for Hopper, sm_90a: f32 in and out, every product on the tensor cores in
// 3xTF32 (mma.sync m16n8k8), deterministic.
//
// Replaces no TPU kernel: the reference trains the xLSTM through XLA's
// gradient of the jnp gated_linear_scan (src/repro/models/ssm.py:54, called
// at src/repro/models/xlstm.py:78 and :81), and its Pallas mamba_ssd
// (src/repro/kernels/mamba_ssd.py) has no backward.  It is the gradient of
// kernels/ref.py:ssd_scan(factorized=True) with B and C in g groups (g | h,
// head hh reading group hh / (h / g)), the function kernels/ref.py:
// ssd_scan_bwd computes: the clip passes no gradient where +-60 bites, the
// centre (max cum + min cum) / 2 passes its gradient to the tied extremes
// in equal shares, the padding of a ragged last chunk takes none; dB and dC
// sum a group's heads in head order.  It takes every shape the forward
// takes: any p (p = 1, the mLSTM's normaliser, included), n a multiple of
// 16, chunk a multiple of 16 in [16, 128].
//
// Per (batch, chunk, head), with ai = exp(clip(cum - c)), bj = exp(clip(c -
// cum)), u = dt bj, w = exp(total - cum), z = w dt, ec = exp(cum), G the
// group's causal C B^T, S the state entering the chunk (the forward's
// states, mamba_ssd_wide(..., return_states=True)) and dS the gradient of
// the state leaving it:
//   dS_{c-1} = exp(total_c) dS_c + C_c^T (ec dy_c),  dS = 0 leaving the last;
//   M = dy x^T and dG = ai_i u_j M, A2 = ai_i u_j G on j <= i;
//   dx = A2^T dy + z (B dS);
//   dC = sum over the group's heads of dG B + ec (dy S^T);
//   dB = sum over the group's heads of dG^T C + z (x dS^T);
// and the scalars' chain to dt and cum from dai = sum_j G u M, du = sum_i
// G ai M, dec = sum C (dy S^T), dz = sum B (x dS^T) and <dS, S>.
//
// What bounds it.  At xlstm-1.3b's training microbatch (the value scan: b 2,
// s 2048, h = g = 4, p = n = 1024, chunk 128) it needs 74.1 G
// multiply-adds: per (batch, head, chunk) the four Q x n x p products (C^T
// (ec dy), B dS, dy S^T, x dS^T: 4 x 134.2 M) and four causal Q^2 ones
// (dy x^T and A2^T dy over p, dG B and dG^T C over n: 4 x 8.5 M), per
// (batch, group, chunk) the causal Gram (8.5 M).  148 GFLOP, issued three
// times over in 3xTF32, is 0.90 ms at the 495 TFLOP/s TF32 rate, against
// 0.30 ms for its 1.01 GB of inputs and outputs (x, dy, B, C, the states
// read; dx, dB, dC written; f32).  So operations bound it.  Its own traffic
// adds dS (the states' size, 537 MB, written by launch 2 and read by 4 and
// 5) and the states read twice more.
//
// Design: simple, in the forward's style, chunk-parallel in six launches (a
// (batch, head)'s dS is n x p f32, 4 MB at full width: it cannot stay on
// chip, so it goes through device memory as the forward's states do):
// 1. prep, a block per (chunk, batch x group): the causal Gram (as the
//    forward's) and, a warp per head, the decay scalars (the prefix sum and
//    the centre in double, as the forward's), the tie weights of the centre
//    and exp(total).
// 2. sweep, a block per (batch, head, 64 x 64 tile of n x p): dS over the
//    chunks in reverse, written to the scratch buffer at each chunk, with
//    the tile's share of <dS, S>; its product C^T diag(ec) dy is the
//    forward's state update with C, ec and dy for B, wj and x.
// 3. qq, a block per (batch, chunk, head), a warp per 16-row strip: M (K =
//    p through shared memory), then dG and A2 (to the scratch buffer) and
//    the row and column sums dai and du, the columns summed over the
//    strips in order.
// 4. dx, a block per (batch, chunk, head, 64 columns of p): A2^T dy (A2 from
//    L2) + z (B dS) (K = n in slabs), the forward's output kernel's shape.
// 5. dbc, a block per (batch, chunk, group, 64 columns of n, dB or dC): the
//    group's heads in order, each adding dG B + ec E (E = dy S^T) or dG^T C
//    + z F (F = x dS^T) to the block's sum, and its dec or dz per row.
// 6. chain, a warp per (batch, chunk, head): the scalars' chain to dscale
//    and dlog_decay (the reverse cumulative sum in the chunk), the partial
//    sums of launches 2, 3 and 5 summed in a fixed order.
// Every operand is split as hi = tf32(v), lo = tf32(v - hi) at its load and
// each product issued as lo.hi + hi.lo + hi.hi, a k-step's three summed from
// zero and added to the f32 accumulator by FADD (mamba_ssd_wide.cu: mma3x).
// Each output element has one owner and each sum a fixed order: no atomics,
// two calls bit-equal.  Making it fast is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "ssd_common.cuh"

namespace {

using ssd::clip60;
using ssd::cp_async16;
using ssd::cp_async_commit;
using ssd::cp_async_wait_all;
using ssd::kClip;
using ssd::ldsm_a;
using ssd::load_a;
using ssd::load_b;
using ssd::mma;
using ssd::split;

constexpr int kTile = 64;          // n rows / p columns of a sweep tile; columns of dx, dB, dC
constexpr int kSlabN = 32;         // K columns a slab
constexpr int kSlabQ = 64;         // most tokens a slab of the sweep
constexpr int kSweepThreads = 128;
constexpr int kXP = kTile + 8;     // pitches (floats), as the forward's
constexpr int kKP = kSlabN + 4;
constexpr int kNS = 10;            // scalars a token
enum { kAI, kBJ, kU, kZ, kW, kEC, kDT, kMA, kMB, kTW };

struct Params {
  const float* x;       // (b, s, h, p)
  const float* a;       // (b, s, h)  log decay
  const float* dt;      // (b, s, h)  input scale
  const float* B;       // (b, s, g, n)
  const float* C;       // (b, s, g, n)
  const float* dy;      // (b, s, h, p)
  const float* states;  // (b, chunks, h, n, p): the state entering each chunk
  float* dx;            // (b, s, h, p)
  float* da;            // (b, s, h)
  float* ddt;           // (b, s, h)
  float* dB;            // (b, s, g, n)
  float* dC;            // (b, s, g, n)
  float* dS;            // (b, chunks, h, n, p): dS leaving each chunk
  float* gram;          // (b, chunks, g, Q, Q + 4): the causal Gram
  float* scal;          // (b, chunks, h, kNS, Q): the scalars
  float* et;            // (b, chunks, h): exp(total)
  float* dg;            // (b, chunks, h, Q, Q + 4): dG on j <= i (0 above)
  float* a2;            // (b, chunks, h, Q, Q + 4): A2 on j <= i (0 above)
  float* rowsum;        // (b, chunks, h, Q): dai
  float* colsum;        // (b, chunks, h, Q): du
  float* decp;          // (b, chunks, h, n tiles, Q): dec per 64 columns of n
  float* dzp;           // (b, chunks, h, n tiles, Q): dz per 64 columns of n
  float* detp;          // (b, chunks, h, n x p tiles): <dS, S> per sweep tile
  int b, s, h, g, p, n, Q, nch, ntn, ntp;
};

__device__ __forceinline__ int group_of(int hh, int h, int g) { return hh / (h / g); }

// (batch, chunk, head) -> its index in the per-head scratch arrays
__device__ __forceinline__ long long bch(const Params& p, int bb, int ch, int hh) {
  return ((long long)bb * p.nch + ch) * p.h + hh;
}

// 1 where clip60 passes its argument's gradient (torch.clamp's inclusive range)
__device__ __forceinline__ float in_clip(float v) { return (v >= -kClip && v <= kClip) ? 1.f : 0.f; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc <- acc + u.v in 3xTF32, a k-step's three products summed from zero and
// added to acc in FP32 (mamba_ssd_wide.cu: mma3x)
__device__ __forceinline__ void mma3x(float (&acc)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                      const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Copy a rows x (ncols8 * 8) tile into shared memory (pitch `ld`): row r
// from src_row(r) (nullptr: a row past the end), columns < w; the other
// columns and rows are zero-filled (their copies read src_row(-1), any
// valid address).  16-byte copies where the rows are 16-byte aligned
// (vec), 4-byte ones otherwise.
template <typename RowFn>
__device__ __forceinline__ void copy_tile(float* dst, int ld, int rows, int ncols8, int w,
                                          bool vec, RowFn src_row, int tid, int nthr) {
  if (vec) {
    const int pieces = 2 * ncols8;
    for (int i = tid; i < rows * pieces; i += nthr) {
      const int r = i / pieces, q = i % pieces;
      const float* row = src_row(r);
      const bool ok = row != nullptr && 4 * q < w;
      cp_async16(dst + r * ld + 4 * q, ok ? row + 4 * q : src_row(-1), ok);
    }
  } else {
    const int cols = 8 * ncols8;
    for (int i = tid; i < rows * cols; i += nthr) {
      const int r = i / cols, e = i % cols;
      const float* row = src_row(r);
      const bool ok = row != nullptr && e < w;
      cp_async4(dst + r * ld + e, ok ? row + e : src_row(-1), ok);
    }
  }
}

// ---------------------------------------------------------------- 1. prep
// A block per (chunk, batch x group), a warp per 16-row strip of the Gram
// (the forward's wide_prep), then a warp per head of the group: the decay
// scalars.  A ragged last chunk's padded tokens take the last real token's
// cumulative decay exactly (zero decay), as the reference's padding gives.
__global__ void __launch_bounds__(256) mamba_ssd_wide_bwd_prep(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4;
  const int ch = blockIdx.x, bb = blockIdx.y / p.g, grp = blockIdx.y % p.g, t0 = ch * Q;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5, gq = lane >> 2, t = lane & 3;
  const int nsl = (p.n + kSlabN - 1) / kSlabN, stage = 2 * Q * kKP;
  const float* zero_src = p.C;

  auto issue = [&](int sl, int st) {
    float* cs = sm + st * stage;
    float* bs = cs + Q * kKP;
    const int k0 = sl * kSlabN, kw = min(kSlabN, p.n - k0), pieces = kw / 4;
    for (int i = tid; i < 2 * Q * pieces; i += nthr) {
      const int which = i / (Q * pieces), r = (i / pieces) % Q, q = i % pieces, tok = t0 + r;
      const float* src = (which ? p.B : p.C) +
                         (((long long)bb * p.s + tok) * p.g + grp) * p.n + k0 + 4 * q;
      cp_async16((which ? bs : cs) + r * kKP + 4 * q, tok < p.s ? src : zero_src, tok < p.s);
    }
    cp_async_commit();
  };

  const int r0 = warp * 16, nct = 2 * warp + 2;
  float acc[16][4] = {};
  issue(0, 0);
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* cs = sm + (sl & 1) * stage;
    const float* bs = cs + Q * kKP;
    const int kw = min(kSlabN, p.n - sl * kSlabN);
    for (int kk = 0; kk < kw; kk += 8) {
      uint32_t ah[4], al[4];
      load_a(cs, kKP, r0, kk, gq, t, ah, al);
#pragma unroll
      for (int ct = 0; ct < 16; ++ct)
        if (ct < nct) {
          uint32_t bh[2], bl[2];
          const float* pb = bs + (ct * 8 + gq) * kKP + kk + t;
          split(pb[0], bh[0], bl[0]);
          split(pb[4], bh[1], bl[1]);
          mma3x(acc[ct], ah, al, bh, bl);
        }
    }
    __syncthreads();
  }
  float* gout = p.gram + (((long long)bb * p.nch + ch) * p.g + grp) * Q * GP;
#pragma unroll
  for (int ct = 0; ct < 16; ++ct)
    if (ct < nct) {
      const int i = r0 + gq, j = ct * 8 + 2 * t;
      *reinterpret_cast<float2*>(gout + i * GP + j) =
          make_float2(j <= i ? acc[ct][0] : 0.f, j + 1 <= i ? acc[ct][1] : 0.f);
      *reinterpret_cast<float2*>(gout + (i + 8) * GP + j) =
          make_float2(j <= i + 8 ? acc[ct][2] : 0.f, j + 1 <= i + 8 ? acc[ct][3] : 0.f);
    }

  const int rep = p.h / p.g, E = (Q + 31) / 32, j0 = lane * E;
  const int last = min(Q, p.s - t0) - 1;  // the chunk's last real token
  for (int r = warp; r < rep; r += nwarps) {
    const int hh = grp * rep + r;
    double cum[4];
    float dts[4];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = t0 + j0 + e;
      const bool in = e < E && j0 + e < Q && tok < p.s;
      const long long off = ((long long)bb * p.s + tok) * p.h + hh;
      run += in ? static_cast<double>(p.a[off]) : 0.0;
      dts[e] = in ? p.dt[off] : 0.f;
      cum[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const double off = incl - run;
    double lastv = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cum[e] += off;
      if (j0 + e == last) lastv = cum[e];
    }
    lastv = __shfl_sync(0xffffffffu, lastv, last / E);
    double mx = -INFINITY, mn = INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) {
        if (j0 + e > last) cum[e] = lastv;
        mx = fmax(mx, cum[e]);
        mn = fmin(mn, cum[e]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    int nmx = 0, nmn = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) {
        nmx += cum[e] == mx;
        nmn += cum[e] == mn;
      }
    nmx = __reduce_add_sync(0xffffffffu, nmx);
    nmn = __reduce_add_sync(0xffffffffu, nmn);
    const double center = 0.5 * (mx + mn), total = lastv;
    float* so = p.scal + bch(p, bb, ch, hh) * kNS * Q;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) {
        const int j = j0 + e;
        const double cj = cum[e];
        const float ea = static_cast<float>(cj - center), eb = static_cast<float>(center - cj);
        const float ai = expf(clip60(ea)), bj = expf(clip60(eb));
        const float w = expf(static_cast<float>(total - cj));
        so[kAI * Q + j] = ai;
        so[kBJ * Q + j] = bj;
        so[kU * Q + j] = dts[e] * bj;
        so[kZ * Q + j] = w * dts[e];
        so[kW * Q + j] = w;
        so[kEC * Q + j] = expf(static_cast<float>(cj));
        so[kDT * Q + j] = dts[e];
        so[kMA * Q + j] = in_clip(ea);
        so[kMB * Q + j] = in_clip(eb);
        so[kTW * Q + j] = (cj == mx ? 0.5f / nmx : 0.f) + (cj == mn ? 0.5f / nmn : 0.f);
      }
    if (lane == 0) p.et[bch(p, bb, ch, hh)] = expf(static_cast<float>(total));
  }
}

// ---------------------------------------------------------------- 2. sweep
__host__ __device__ inline int slab_tokens(int Q) { return Q <= kSlabQ ? Q : Q / 2; }

// A block per (64 x 64 tile of n x p, head, batch row), 4 warps, warp w
// owning rows 16 w .. 16 w + 15 of the tile: over the chunks in reverse, the
// running dS (registers) is written as dS leaving the chunk, its tile's
// share of <dS, S> goes to detp, and then dS <- exp(total) dS + C^T diag(ec)
// dy, the product in slabs of kSlabQ tokens (C and dy double-buffered).
__global__ void __launch_bounds__(kSweepThreads) mamba_ssd_wide_bwd_sweep(Params p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kSweepThreads / 32];
  const int Q = p.Q, KQ = slab_tokens(Q), halves = Q / KQ, nsl = p.nch * halves;
  const int stage = 2 * KQ * kXP + KQ;  // C [KQ][kXP], dy [KQ][kXP], ec [KQ]
  const int tn = blockIdx.x % p.ntn, tp = blockIdx.x / p.ntn, hh = blockIdx.y, bb = blockIdx.z;
  const int grp = group_of(hh, p.h, p.g);
  const int n0 = tn * kTile, c0 = tp * kTile;
  const int rows = min(kTile, p.n - n0), pw = min(kTile, p.p - c0), nct = (pw + 7) / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const bool active = r0 < rows, vec = p.p % 4 == 0;

  auto chunk_of = [&](int sl) { return p.nch - 1 - sl / halves; };
  auto issue = [&](int sl, int st) {
    float* cs = sm + st * stage;
    float* ys = cs + KQ * kXP;
    float* ec = ys + KQ * kXP;
    const int ch = chunk_of(sl), tok0 = ch * Q + (sl % halves) * KQ;
    copy_tile(cs, kXP, KQ, rows / 8, rows, true, [&](int r) -> const float* {
      if (r < 0) return p.C;
      const int tok = tok0 + r;
      return tok < p.s ? p.C + (((long long)bb * p.s + tok) * p.g + grp) * p.n + n0 : nullptr;
    }, tid, kSweepThreads);
    copy_tile(ys, kXP, KQ, nct, pw, vec, [&](int r) -> const float* {
      if (r < 0) return p.dy;
      const int tok = tok0 + r;
      return tok < p.s ? p.dy + (((long long)bb * p.s + tok) * p.h + hh) * p.p + c0 : nullptr;
    }, tid, kSweepThreads);
    const float* esrc = p.scal + bch(p, bb, ch, hh) * kNS * Q + kEC * Q + (sl % halves) * KQ;
    for (int i = tid; i < KQ / 4; i += kSweepThreads) cp_async16(ec + 4 * i, esrc + 4 * i, true);
    cp_async_commit();
  };

  float S[8][4] = {}, acc[8][4] = {};
  issue(0, 0);
  for (int sl = 0; sl < nsl; ++sl) {
    const int ch = chunk_of(sl), hf = sl % halves;
    if (hf == 0) {  // dS leaving chunk ch, and its tile's <dS, S>
      float part = 0.f;
      if (active) {
        const long long base = (bch(p, bb, ch, hh) * p.n + n0 + r0) * p.p + c0;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nct)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = c * 8 + 2 * t + e;
                if (col < pw) {
                  const long long o = base + (long long)(gq + 8 * half) * p.p + col;
                  p.dS[o] = S[c][2 * half + e];
                  part = fmaf(S[c][2 * half + e], __ldg(p.states + o), part);
                }
              }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f;
        for (int w = 0; w < kSweepThreads / 32; ++w) sum += red[w];
        p.detp[bch(p, bb, ch, hh) * (p.ntn * p.ntp) + blockIdx.x] = sum;
      }
      __syncthreads();
    }
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // slab sl has landed
    if (active) {
      const float* cs = sm + (sl & 1) * stage;
      const float* ys = cs + KQ * kXP;
      const float* ec = ys + KQ * kXP;
      for (int k0 = 0; k0 < KQ; k0 += 8) {
        // A (n, j) = C[j][n] ec[j]
        const float w0 = ec[k0 + t], w1 = ec[k0 + t + 4];
        const float* pa = cs + (k0 + t) * kXP + r0 + gq;
        uint32_t ah[4], al[4];
        split(pa[0] * w0, ah[0], al[0]);
        split(pa[8] * w0, ah[1], al[1]);
        split(pa[4 * kXP] * w1, ah[2], al[2]);
        split(pa[4 * kXP + 8] * w1, ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nct) {
            uint32_t bh[2], bl[2];
            load_b(ys, kXP, k0, c * 8, gq, t, bh, bl);
            mma3x(acc[c], ah, al, bh, bl);
          }
      }
      if (hf == halves - 1) {  // dS <- exp(total) dS + the chunk's local term
        const float et = p.et[bch(p, bb, ch, hh)];
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            S[c][e] = et * S[c][e] + acc[c][e];
            acc[c][e] = 0.f;
          }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

// ------------------------------------------------------------------- 3. qq
// A block per (chunk, head, batch row), a warp per 16-row strip i: M = dy
// x^T on the strip's 8-column tiles up to the diagonal (K = p in slabs of
// kSlabN, dy and x double-buffered), then with G (the prep's, from L2):
// dG = ai_i u_j M and A2 = ai_i u_j G on j <= i (0 above the diagonal,
// where ai_i u_j may overflow and is never formed), dai_i (the strip's own
// rows) and the strip's shares of du_j, summed over the strips in order.
__host__ __device__ inline int qq_smem_floats(int Q) { return 2 * 2 * Q * kKP + (2 + Q / 16) * Q; }

__global__ void __launch_bounds__(256) mamba_ssd_wide_bwd_qq(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4, stage = 2 * Q * kKP;
  const int ch = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z, t0 = ch * Q;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5, gq = lane >> 2, t = lane & 3;
  const bool vec = p.p % 4 == 0;
  float* ai = sm + 2 * stage;
  float* u = ai + Q;
  float* colp = u + Q;  // [nwarps][Q]
  const long long me = bch(p, bb, ch, hh);
  const float* so = p.scal + me * kNS * Q;
  for (int i = tid; i < Q / 4; i += nthr) {
    cp_async16(ai + 4 * i, so + kAI * Q + 4 * i, true);
    cp_async16(u + 4 * i, so + kU * Q + 4 * i, true);
  }
  auto issue = [&](int sl, int st) {
    float* ds = sm + st * stage;
    float* xs = ds + Q * kKP;
    const int k0 = sl * kSlabN, w = min(kSlabN, p.p - k0);
    copy_tile(ds, kKP, Q, kSlabN / 8, w, vec, [&](int r) -> const float* {
      if (r < 0) return p.dy;
      const int tok = t0 + r;
      return tok < p.s ? p.dy + (((long long)bb * p.s + tok) * p.h + hh) * p.p + k0 : nullptr;
    }, tid, nthr);
    copy_tile(xs, kKP, Q, kSlabN / 8, w, vec, [&](int r) -> const float* {
      if (r < 0) return p.x;
      const int tok = t0 + r;
      return tok < p.s ? p.x + (((long long)bb * p.s + tok) * p.h + hh) * p.p + k0 : nullptr;
    }, tid, nthr);
    cp_async_commit();
  };

  const int r0 = warp * 16, nct = 2 * warp + 2, nsl = (p.p + kSlabN - 1) / kSlabN;
  float acc[16][4] = {};
  issue(0, 0);
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* ds = sm + (sl & 1) * stage;
    const float* xs = ds + Q * kKP;
    const int kw = min(kSlabN, p.p - sl * kSlabN);
    for (int kk = 0; kk < kw; kk += 8) {
      uint32_t ah[4], al[4];
      load_a(ds, kKP, r0, kk, gq, t, ah, al);  // (i, k) = dy[i][k]
#pragma unroll
      for (int ct = 0; ct < 16; ++ct)
        if (ct < nct) {
          uint32_t bh[2], bl[2];
          const float* pb = xs + (ct * 8 + gq) * kKP + kk + t;  // (k, j) = x[j][k]
          split(pb[0], bh[0], bl[0]);
          split(pb[4], bh[1], bl[1]);
          mma3x(acc[ct], ah, al, bh, bl);
        }
    }
    __syncthreads();
  }

  const float* G = p.gram + (((long long)bb * p.nch + ch) * p.g + group_of(hh, p.h, p.g)) * Q * GP;
  float* dgo = p.dg + me * Q * GP;
  float* a2o = p.a2 + me * Q * GP;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int ct = 0; ct < 16; ++ct)
    if (ct < nct) {
      float cl[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + gq + 8 * half;
        const float aii = ai[i];
        float dgv[2], a2v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = ct * 8 + 2 * t + e;
          const float Gv = __ldg(G + i * GP + j), Mv = acc[ct][2 * half + e];
          dgv[e] = a2v[e] = 0.f;
          if (j <= i) {
            const float uj = u[j], au = aii * uj;
            dgv[e] = au * Mv;
            a2v[e] = au * Gv;
            rs[half] = fmaf(Gv * uj, Mv, rs[half]);
            cl[e] = fmaf(Gv * aii, Mv, cl[e]);
          }
        }
        *reinterpret_cast<float2*>(dgo + i * GP + ct * 8 + 2 * t) = make_float2(dgv[0], dgv[1]);
        *reinterpret_cast<float2*>(a2o + i * GP + ct * 8 + 2 * t) = make_float2(a2v[0], a2v[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // columns: over the 8 quads
        cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], 4);
        cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], 8);
        cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], 16);
      }
      if (gq == 0) {
        colp[warp * Q + ct * 8 + 2 * t] = cl[0];
        colp[warp * Q + ct * 8 + 2 * t + 1] = cl[1];
      }
    }
  for (int j = nct * 8 + lane; j < Q; j += 32) colp[warp * Q + j] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // rows: over the 4 lanes of a quad
    rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 1);
    rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 2);
  }
  if (t == 0) {
    p.rowsum[me * Q + r0 + gq] = rs[0];
    p.rowsum[me * Q + r0 + gq + 8] = rs[1];
  }
  __syncthreads();
  for (int j = tid; j < Q; j += nthr) {
    float sum = 0.f;
    for (int w = 0; w < nwarps; ++w) sum += colp[w * Q + j];
    p.colsum[me * Q + j] = sum;
  }
}

// ------------------------------------------------------------------- 4. dx
// A block per (64 columns of p, head, batch x chunk), a warp per 16 rows j:
// dx = A2^T dy (A2 from L2, i from the strip on) + z_j (B dS) (B and dS in
// slabs of kSlabN state rows, double-buffered; dS leaving the last chunk is
// zero and skipped).
__host__ __device__ inline int dx_slab_floats(int Q) { return Q * kKP + kSlabN * kXP; }
__host__ __device__ inline int dx_smem_floats(int Q) { return 2 * dx_slab_floats(Q) + Q * kXP + Q; }

__global__ void __launch_bounds__(256) mamba_ssd_wide_bwd_dx(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4, slab = dx_slab_floats(Q);
  const int tp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z / p.nch, ch = blockIdx.z % p.nch;
  const int grp = group_of(hh, p.h, p.g);
  const int c0 = tp * kTile, pw = min(kTile, p.p - c0), nct = (pw + 7) / 8;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, r0 = warp * 16, t0 = ch * Q;
  const bool vec = p.p % 4 == 0;
  float* dys = sm + 2 * slab;
  float* z = dys + Q * kXP;
  const long long me = bch(p, bb, ch, hh);

  copy_tile(dys, kXP, Q, nct, pw, vec, [&](int r) -> const float* {
    if (r < 0) return p.dy;
    const int tok = t0 + r;
    return tok < p.s ? p.dy + (((long long)bb * p.s + tok) * p.h + hh) * p.p + c0 : nullptr;
  }, tid, nthr);
  const float* zsrc = p.scal + me * kNS * Q + kZ * Q;
  for (int i = tid; i < Q / 4; i += nthr) cp_async16(z + 4 * i, zsrc + 4 * i, true);
  cp_async_commit();

  const int nsl = ch < p.nch - 1 ? (p.n + kSlabN - 1) / kSlabN : 0;
  const float* dS = p.dS + me * p.n * p.p + c0;
  auto issue = [&](int sl, int st) {
    float* bs = sm + st * slab;
    float* ss = bs + Q * kKP;
    const int k0 = sl * kSlabN, kw = min(kSlabN, p.n - k0);
    copy_tile(bs, kKP, Q, kw / 8, kw, true, [&](int r) -> const float* {
      if (r < 0) return p.B;
      const int tok = t0 + r;
      return tok < p.s ? p.B + (((long long)bb * p.s + tok) * p.g + grp) * p.n + k0 : nullptr;
    }, tid, nthr);
    copy_tile(ss, kXP, kw, nct, pw, vec, [&](int r) -> const float* {
      return r < 0 ? p.dS : dS + (long long)(k0 + r) * p.p;
    }, tid, nthr);
    cp_async_commit();
  };
  if (nsl > 0) {
    issue(0, 0);
    cp_async_wait_one();
  } else {
    cp_async_wait_all();
  }
  __syncthreads();  // dy and z have landed

  float pa[8][4] = {}, rb[8][4] = {};
  // -------- A2^T dy: A (j, i) = A2[i][j], zero for i < j
  const float* A2 = p.a2 + me * Q * GP;
  for (int k0 = r0; k0 < Q; k0 += 8) {
    const float* pg = A2 + (k0 + t) * GP + r0 + gq;
    uint32_t ah[4], al[4];
    split(__ldg(pg), ah[0], al[0]);
    split(__ldg(pg + 8), ah[1], al[1]);
    split(__ldg(pg + 4 * GP), ah[2], al[2]);
    split(__ldg(pg + 4 * GP + 8), ah[3], al[3]);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nct) {
        uint32_t bh[2], bl[2];
        load_b(dys, kXP, k0, c * 8, gq, t, bh, bl);
        mma3x(pa[c], ah, al, bh, bl);
      }
  }
  // -------- B dS
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* bs = sm + (sl & 1) * slab;
    const float* ss = bs + Q * kKP;
    const int kw = min(kSlabN, p.n - sl * kSlabN);
    for (int kk = 0; kk < kw; kk += 8) {
      float v[4];
      uint32_t ah[4], al[4];
      ldsm_a(bs, kKP, r0, kk, lane, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], ah[e], al[e]);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < nct) {
          uint32_t bh[2], bl[2];
          load_b(ss, kXP, kk, c * 8, gq, t, bh, bl);
          mma3x(rb[c], ah, al, bh, bl);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = r0 + gq + 8 * half, tok = t0 + j;
    if (tok >= p.s) continue;
    const float zj = z[j];
    float* row = p.dx + (((long long)bb * p.s + tok) * p.h + hh) * p.p + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nct)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c * 8 + 2 * t + e;
          if (col < pw) row[col] = pa[c][2 * half + e] + zj * rb[c][2 * half + e];
        }
  }
}

// ------------------------------------------------------------------ 5. dbc
// A block per (64 columns of n and dC or dB, group, batch x chunk), a warp
// per 16 rows: for each head of the group in order, E = dy S^T (dC) or F =
// x dS^T (dB) (K = p in slabs, the state's rows of the tile through shared
// memory), then dG B or dG^T C (dG from L2) added to the group's sum in
// registers with ec_i E or z_j F, and the head's dec_i = sum C E or dz_j =
// sum B F over the tile's columns.  The state entering the first chunk
// and dS leaving the last are zero: their products are skipped.
__host__ __device__ inline int dbc_slab_floats(int Q) { return (Q + kTile) * kKP; }
__host__ __device__ inline int dbc_smem_floats(int Q) {
  return 2 * dbc_slab_floats(Q) + 2 * Q * kXP + Q;
}

__global__ void __launch_bounds__(256) mamba_ssd_wide_bwd_dbc(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4, slab = dbc_slab_floats(Q);
  const int kind = blockIdx.x & 1, tn = blockIdx.x >> 1, grp = blockIdx.y;
  const int bb = blockIdx.z / p.nch, ch = blockIdx.z % p.nch, t0 = ch * Q;
  const int n0 = tn * kTile, nw = min(kTile, p.n - n0), nctn = nw / 8;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, r0 = warp * 16, rep = p.h / p.g;
  const bool vec = p.p % 4 == 0;
  float* bt = sm + 2 * slab;  // B [Q][kXP] of the tile's columns
  float* ct = bt + Q * kXP;   // C [Q][kXP]
  float* sv = ct + Q * kXP;   // the head's ec (dC) or z (dB)
  const float* Ain = kind ? p.x : p.dy;
  const float* Sin = kind ? p.dS : p.states;

  for (int which = 0; which < 2; ++which)
    copy_tile(which ? ct : bt, kXP, Q, nctn, nw, true, [&](int r) -> const float* {
      const float* m = which ? p.C : p.B;
      if (r < 0) return m;
      const int tok = t0 + r;
      return tok < p.s ? m + (((long long)bb * p.s + tok) * p.g + grp) * p.n + n0 : nullptr;
    }, tid, nthr);

  float sum[8][4] = {};
  for (int r = 0; r < rep; ++r) {
    const int hh = grp * rep + r;
    const long long me = bch(p, bb, ch, hh);
    __syncthreads();  // the previous head is done with sv and the stages
    const float* ssrc = p.scal + me * kNS * Q + (kind ? kZ : kEC) * Q;
    for (int i = tid; i < Q / 4; i += nthr) cp_async16(sv + 4 * i, ssrc + 4 * i, true);
    const bool skip = kind ? ch == p.nch - 1 : ch == 0;
    const int nsl = skip ? 0 : (p.p + kSlabN - 1) / kSlabN;
    const float* st_in = Sin + (me * p.n + n0) * p.p;
    auto issue = [&](int sl, int st) {
      float* as = sm + st * slab;
      float* ss = as + Q * kKP;
      const int k0 = sl * kSlabN, w = min(kSlabN, p.p - k0);
      copy_tile(as, kKP, Q, kSlabN / 8, w, vec, [&](int rr) -> const float* {
        if (rr < 0) return Ain;
        const int tok = t0 + rr;
        return tok < p.s ? Ain + (((long long)bb * p.s + tok) * p.h + hh) * p.p + k0 : nullptr;
      }, tid, nthr);
      copy_tile(ss, kKP, kTile, kSlabN / 8, w, vec, [&](int rr) -> const float* {
        if (rr < 0) return Sin;
        return rr < nw ? st_in + (long long)rr * p.p + k0 : nullptr;
      }, tid, nthr);
      cp_async_commit();
    };
    float E[8][4] = {};
    if (nsl > 0) {
      issue(0, 0);
    } else {
      cp_async_commit();
    }
    for (int sl = 0; sl < nsl; ++sl) {
      if (sl + 1 < nsl) {
        issue(sl + 1, (sl + 1) & 1);
        cp_async_wait_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const float* as = sm + (sl & 1) * slab;
      const float* ss = as + Q * kKP;
      const int kw = min(kSlabN, p.p - sl * kSlabN);
      for (int kk = 0; kk < kw; kk += 8) {
        uint32_t ah[4], al[4];
        load_a(as, kKP, r0, kk, gq, t, ah, al);  // (i, k) = dy[i][k] or x[i][k]
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nctn) {
            uint32_t bh[2], bl[2];
            const float* q = ss + (c * 8 + gq) * kKP + kk + t;  // (k, m) = S[m][k]
            split(q[0], bh[0], bl[0]);
            split(q[4], bh[1], bl[1]);
            mma3x(E[c], ah, al, bh, bl);
          }
      }
      __syncthreads();
    }
    cp_async_wait_all();
    __syncthreads();  // sv, and on the first head B and C, have landed

    // dG B (rows i, j up to the strip's end) or dG^T C (rows j, i from the strip on)
    const float* dG = p.dg + me * Q * GP;
    if (kind == 0) {
      for (int k0 = 0; k0 < r0 + 16; k0 += 8) {
        const float* pg = dG + (r0 + gq) * GP + k0 + t;
        uint32_t ah[4], al[4];
        split(__ldg(pg), ah[0], al[0]);
        split(__ldg(pg + 8 * GP), ah[1], al[1]);
        split(__ldg(pg + 4), ah[2], al[2]);
        split(__ldg(pg + 8 * GP + 4), ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nctn) {
            uint32_t bh[2], bl[2];
            load_b(bt, kXP, k0, c * 8, gq, t, bh, bl);
            mma3x(sum[c], ah, al, bh, bl);
          }
      }
    } else {
      for (int k0 = r0; k0 < Q; k0 += 8) {
        const float* pg = dG + (k0 + t) * GP + r0 + gq;
        uint32_t ah[4], al[4];
        split(__ldg(pg), ah[0], al[0]);
        split(__ldg(pg + 8), ah[1], al[1]);
        split(__ldg(pg + 4 * GP), ah[2], al[2]);
        split(__ldg(pg + 4 * GP + 8), ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nctn) {
            uint32_t bh[2], bl[2];
            load_b(ct, kXP, k0, c * 8, gq, t, bh, bl);
            mma3x(sum[c], ah, al, bh, bl);
          }
      }
    }
    // + ec_i E (z_j F), and dec_i = sum C E (dz_j = sum B F) over the columns
    const float* mine = kind ? bt : ct;
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + gq + 8 * half;
      const float si = sv[i];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < nctn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float Ev = E[c][2 * half + e];
            sum[c][2 * half + e] = fmaf(si, Ev, sum[c][2 * half + e]);
            dot[half] = fmaf(mine[i * kXP + c * 8 + 2 * t + e], Ev, dot[half]);
          }
      dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 1);
      dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 2);
    }
    if (t == 0) {
      float* dp = (kind ? p.dzp : p.decp) + (me * p.ntn + tn) * Q;
      dp[r0 + gq] = dot[0];
      dp[r0 + gq + 8] = dot[1];
    }
  }
  float* out = kind ? p.dB : p.dC;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = t0 + r0 + gq + 8 * half;
    if (tok >= p.s) continue;
    float* row = out + (((long long)bb * p.s + tok) * p.g + grp) * p.n + n0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nctn)
        *reinterpret_cast<float2*>(row + c * 8 + 2 * t) =
            make_float2(sum[c][2 * half], sum[c][2 * half + 1]);
  }
}

// ---------------------------------------------------------------- 6. chain
// A warp per (chunk, head, batch row): the scalars' chain to dt and cum
// (kernels/ref.py: ssd_scan_bwd; mamba_ssd_bwd.cu's warp 0), from dai and du
// (launch 3), dec and dz (launch 5, its n tiles summed in order) and <dS, S>
// (launch 2, its tiles summed in order); dlog_decay is the reverse
// cumulative sum of dcum in the chunk.
__global__ void __launch_bounds__(32) mamba_ssd_wide_bwd_chain(Params p) {
  const int Q = p.Q, ch = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z, t0 = ch * Q;
  const int lane = threadIdx.x, E = (Q + 31) / 32, j0 = lane * E;
  const long long me = bch(p, bb, ch, hh);
  const float* sc = p.scal + me * kNS * Q;
  float dcum[4], cen = 0.f, tot = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dcum[e] = 0.f;
    const int j = j0 + e;
    if (e >= E || j >= Q) continue;
    const float dai = p.rowsum[me * Q + j], du = p.colsum[me * Q + j];
    float dec = 0.f, dz = 0.f;
    for (int tn = 0; tn < p.ntn; ++tn) {
      dec += p.decp[(me * p.ntn + tn) * Q + j];
      dz += p.dzp[(me * p.ntn + tn) * Q + j];
    }
    const float ai = sc[kAI * Q + j], bj = sc[kBJ * Q + j], w = sc[kW * Q + j];
    const float dtj = sc[kDT * Q + j], ec = sc[kEC * Q + j];
    const int tok = t0 + j;
    if (tok < p.s) p.ddt[((long long)bb * p.s + tok) * p.h + hh] = bj * du + w * dz;
    const float dbj = dtj * du, dw = dtj * dz;
    const float ga = dai * ai * sc[kMA * Q + j], gb = dbj * bj * sc[kMB * Q + j];
    dcum[e] = ga - gb - dw * w + dec * ec;
    cen += gb - ga;
    tot += dw * w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cen += __shfl_xor_sync(0xffffffffu, cen, o);
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
  }
  float det = 0.f;
  const int ntiles = p.ntn * p.ntp;
  for (int i = 0; i < ntiles; ++i) det += p.detp[me * ntiles + i];
  tot += det * p.et[me];
  float run = 0.f, loc[4];
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    const int j = j0 + e;
    if (e < E && j < Q) {
      dcum[e] += cen * sc[kTW * Q + j] + (j == Q - 1 ? tot : 0.f);
      run += dcum[e];
    }
    loc[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += v;
  }
  const float above = incl - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e, tok = t0 + j;
    if (e < E && j < Q && tok < p.s)
      p.da[((long long)bb * p.s + tok) * p.h + hh] = loc[e] + above;
  }
}

bool shape_ok(int b, int s, int h, int g, int p, int n, int Q) {
  return b >= 1 && s >= 1 && h >= 1 && g >= 1 && h % g == 0 && p >= 1 && n >= 16 &&
         n % 16 == 0 && Q >= 16 && Q <= 128 && Q % 16 == 0 &&
         (long long)b * ((s + Q - 1) / Q) <= 65535 && (long long)b * g <= 65535 && h <= 65535;
}

long long up4(long long v) { return (v + 3) / 4 * 4; }

// The scratch buffer's sections, in floats from its start (each a multiple
// of 4, so every section starts on 16 bytes): dS, the Gram, the scalars,
// exp(total), dG, A2, dai, du, the dec and dz partial sums, <dS, S>'s.
struct Layout {
  long long dS, gram, scal, et, dg, a2, rowsum, colsum, decp, dzp, detp, total;
};

Layout layout(int b, int s, int h, int g, int p, int n, int Q) {
  const long long nch = (s + Q - 1) / Q, bh = (long long)b * nch * h, GP = Q + 4;
  const long long ntn = (n + kTile - 1) / kTile, ntp = (p + kTile - 1) / kTile;
  Layout L;
  L.dS = 0;
  L.gram = L.dS + up4(bh * n * p);
  L.scal = L.gram + up4((long long)b * nch * g * Q * GP);
  L.et = L.scal + up4(bh * kNS * Q);
  L.dg = L.et + up4(bh);
  L.a2 = L.dg + up4(bh * Q * GP);
  L.rowsum = L.a2 + up4(bh * Q * GP);
  L.colsum = L.rowsum + up4(bh * Q);
  L.decp = L.colsum + up4(bh * Q);
  L.dzp = L.decp + up4(bh * ntn * Q);
  L.detp = L.dzp + up4(bh * ntn * Q);
  L.total = L.detp + up4(bh * ntn * ntp);
  return L;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& prm,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer mamba_ssd_wide_bwd needs (dS, the size of the
// states, is most of it), or 0 for a shape it does not take.
extern "C" long long mamba_ssd_wide_bwd_scratch_bytes(int b, int s, int h, int g, int p, int n,
                                                      int chunk) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return 0;
  return 4 * layout(b, s, h, g, p, n, chunk).total;
}

// All tensors f32 and contiguous, 16-byte aligned: the forward's inputs, dy
// (b, s, h, p), the states (b, ceil(s / chunk), h, n, p) the forward wrote;
// out dx, dlog_decay, dscale, dB, dC in the inputs' shapes; scratch holds
// mamba_ssd_wide_bwd_scratch_bytes.  Six launches on `stream`; returns
// cudaGetLastError() after them, or -1 for a shape this kernel does not take
// (the forward's: g | h; n a multiple of 16; chunk a multiple of 16 in [16,
// 128]).
extern "C" int mamba_ssd_wide_bwd(const void* x, const void* a, const void* dt, const void* B,
                                  const void* C, const void* dy, const void* states, void* dx,
                                  void* da, void* ddt, void* dB, void* dC, void* scratch, int b,
                                  int s, int h, int g, int p, int n, int chunk, void* stream) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return -1;
  const int Q = chunk, nch = (s + Q - 1) / Q;
  const int ntn = (n + kTile - 1) / kTile, ntp = (p + kTile - 1) / kTile;
  const Layout L = layout(b, s, h, g, p, n, Q);
  float* f = static_cast<float*>(scratch);
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<const float*>(dy),
             static_cast<const float*>(states), static_cast<float*>(dx),
             static_cast<float*>(da), static_cast<float*>(ddt), static_cast<float*>(dB),
             static_cast<float*>(dC), f + L.dS, f + L.gram, f + L.scal, f + L.et, f + L.dg,
             f + L.a2, f + L.rowsum, f + L.colsum, f + L.decp, f + L.dzp, f + L.detp,
             b, s, h, g, p, n, Q, nch, ntn, ntp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = Q / 16;
  const int sweep_smem = 2 * (2 * slab_tokens(Q) * kXP + slab_tokens(Q)) * 4;
  cudaError_t e;
  if ((e = launch(mamba_ssd_wide_bwd_prep, dim3(nch, b * g), 32 * warps, 2 * 2 * Q * kKP * 4,
                  prm, st)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = launch(mamba_ssd_wide_bwd_sweep, dim3(ntn * ntp, h, b), kSweepThreads, sweep_smem,
                  prm, st)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = launch(mamba_ssd_wide_bwd_qq, dim3(nch, h, b), 32 * warps, qq_smem_floats(Q) * 4,
                  prm, st)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = launch(mamba_ssd_wide_bwd_dx, dim3(ntp, h, b * nch), 32 * warps,
                  dx_smem_floats(Q) * 4, prm, st)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = launch(mamba_ssd_wide_bwd_dbc, dim3(2 * ntn, g, b * nch), 32 * warps,
                  dbc_smem_floats(Q) * 4, prm, st)) != cudaSuccess)
    return static_cast<int>(e);
  return static_cast<int>(
      launch(mamba_ssd_wide_bwd_chain, dim3(nch, h, b), 32, 0, prm, st));
}

extern "C" const char* mamba_ssd_wide_bwd_error_string(int code) {
  if (code < 0) return "unsupported shape (g | h; n a multiple of 16; chunk a multiple of 16 "
                       "in [16, 128]; batch x chunks <= 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
