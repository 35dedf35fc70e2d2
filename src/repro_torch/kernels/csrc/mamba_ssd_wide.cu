// Grouped, wide-head chunked SSD scan for Hopper, sm_90a: f32 in and out,
// every product on the tensor cores in 3xTF32 (mma.sync m16n8k8).
//
// Replaces: no Pallas kernel of its own.  src/repro/kernels/mamba_ssd.py
// (mamba_ssd, the TPU kernel) takes groups 1 only, and the reference runs
// the mLSTM's scans (src/repro/models/xlstm.py:78 and :80-81) through the
// jnp gated_linear_scan (src/repro/models/ssm.py:62) under XLA.  This is
// that function for what mamba_ssd.cu does not take: B and C with g groups
// (g | h, head hh reading group hh / (h / g)), state and head widths n and
// p past 128 (the mLSTM's 1024), and p = 1 (its normaliser).
//
// Same function as gated_linear_scan(factorized=True): per (batch, head)
// and chunk of Q tokens, with cum the in-chunk cumulative sum of
// log_decay, total = cum[Q-1] and the centre c = (max cum + min cum) / 2,
//   y[i]  = exp(clip(cum_i - c)) * sum_{j<=i} (C_i.B_j) dt_j exp(clip(c - cum_j)) x_j
//         + exp(cum_i) * C_i . S
//   S    <- exp(total) S + sum_j exp(total - cum_j) dt_j B_j (x) x_j
// with clip to [-60, 60] and S = 0 at the first chunk.  A ragged last
// chunk is padded with zero decay and zero input, as the reference pads.
//
// What bounds it.  At xlstm-1.3b's prefill (b 2, s 4096, h = g = 4,
// p = n = 1024, Q 128) the scan needs 73.0 G multiply-adds (per (batch,
// head, chunk) the causal G.x, C.S and the state update; the causal Gram
// per (batch, group, chunk)): 146 GFLOP, issued three times over in
// 3xTF32, is 0.886 ms at the 495 TFLOP/s TF32 rate, against 0.160 ms for
// its 537 MB of x, B, C and y.  So operations bound it.  The normaliser
// (p = 1) is bound by reading B and C (0.080 ms).
//
// Design.  One (batch, head)'s state is n x p f32, 4 MB at the prefill:
// it cannot stay on chip, so the scan runs chunk-parallel in three
// launches (a later backward reads the states the second one writes):
// 1. prep, a block per (chunk, batch, group): the causal Gram
//    G = tril(C B^T) (K = n, in slabs of 32 state columns through shared
//    memory), and per head of the group the decay scalars ai, dtb, wj, ec
//    (a warp per head: the prefix scan and the centre in double, then the
//    exps), into a scratch buffer the wrapper allocates.
// 2. states, a block per (batch, head, 64 x 64 tile of n x p): a sweep
//    over the chunks that writes the state entering each chunk and adds
//    the chunk's own state B^T diag(wj) x (K = Q, 64 tokens a slab) to the
//    running state in registers: S_in[c] = exp(total[c-1]) S_in[c-1] +
//    dS[c-1].  The states (b, chunks, h, n, p) f32 lead the scratch buffer
//    (mamba_ssd_fwd_states' layout).
// 3. out, a block per (batch, chunk, head, 64 columns of p), a warp per 16
//    rows: y = ai (G diag(dtb)) x + ec C S_in, G read from L2, C and S_in
//    in slabs of 32 state rows double-buffered through shared memory.
// Every operand is split as hi = tf32(v), lo = tf32(v - hi) at its load
// (ssd_common.cuh) and each product issued as lo.hi + hi.lo + hi.hi, a
// k-step's three summed from zero and added to the f32 accumulator by FADD
// (mma3x: the tensor core's additions do not round to nearest).  The
// p columns of x, S and y are masked to p (p = 1 runs on the same code);
// loads past p and past s are zero-filled.  Making it fast (wgmma on
// pre-split operands, one Gram for the two mLSTM scans) is later work.
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
using ssd::ldsm_a;
using ssd::load_a;
using ssd::load_b;
using ssd::mma;
using ssd::split;

constexpr int kTile = 64;     // n rows and p columns of a states tile; p columns of an out block
constexpr int kSlabN = 32;    // state columns (prep, out) a slab
constexpr int kSlabQ = 64;    // most tokens a slab (states)
constexpr int kStatesThreads = 128;
// pitches (floats): 8 mod 32 for x, S and the states' B slab, whose
// fragments are read (k + t) * pitch + g; 4 mod 32 for the C and B slabs of
// the Gram and of C.S, read (r + g) * pitch + k + t
constexpr int kXP = kTile + 8;
constexpr int kKP = kSlabN + 4;

struct Params {
  const float* x;   // (b, s, h, p)
  const float* a;   // (b, s, h)  log decay
  const float* dt;  // (b, s, h)  input scale
  const float* B;   // (b, s, g, n)
  const float* C;   // (b, s, g, n)
  float* y;         // (b, s, h, p)
  float* states;    // (b, chunks, h, n, p): the state entering each chunk
  float* gram;      // (b, chunks, g, Q, Q + 4): the causal Gram of each chunk and group
  float* scal;      // (b, chunks, h, 4, Q): ai, dtb, wj, ec (ec[Q-1] = exp(total))
  int b, s, h, g, p, n, Q, nch;
};

// the group whose B and C head hh reads
__device__ __forceinline__ int group_of(int hh, int h, int g) { return hh / (h / g); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc <- acc + u.v in 3xTF32: lo.hi + hi.lo + hi.hi of one k-step summed in
// the tensor core from zero, then added to acc in FP32.  The tensor core's
// own additions do not round to nearest; over the long sums here (K = n =
// 1024: 384 of them into one accumulator) their error grows past the
// tolerance, so each k-step's three products get a fresh accumulator and
// acc is summed with FADD, round to nearest.
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
// from src_row(r) (nullptr: a row past s), columns < w; the other columns
// and rows are zero-filled (their copies read src_row(-1), any valid
// address).  16-byte copies where the rows are 16-byte aligned (vec),
// 4-byte ones otherwise (p = 1).
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
// A block per (chunk, batch x group), a warp per 16-row strip of the Gram:
// G[i][j] = (j <= i) C_i.B_j for the strip's 8-column tiles on or left of
// the diagonal, K = n in slabs of kSlabN double-buffered; then, a warp per
// head of the group, the decay scalars of the chunk.
__global__ void __launch_bounds__(256) wide_prep(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4;
  const int ch = blockIdx.x, bb = blockIdx.y / p.g, grp = blockIdx.y % p.g, t0 = ch * Q;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5, gq = lane >> 2, t = lane & 3;
  const int nsl = (p.n + kSlabN - 1) / kSlabN, stage = 2 * Q * kKP;
  const float* zero_src = p.C;  // any valid address for a zero-filled copy

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

  const int r0 = warp * 16, nct = 2 * warp + 2;  // 8-column tiles up to the diagonal
  float acc[16][4] = {};
  issue(0, 0);
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // slab sl has landed
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
          const float* pb = bs + (ct * 8 + gq) * kKP + kk + t;  // (k, j) = B[j][k]
          split(pb[0], bh[0], bl[0]);
          split(pb[4], bh[1], bl[1]);
          mma3x(acc[ct], ah, al, bh, bl);
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
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

  // the decays of each head of the group: lane holds tokens j0 .. j0 + E - 1.
  // The prefix sum, the centre and the differences the exps take are in
  // double: in f32 a shuffle scan rounds cum_i and cum_j along different
  // paths, and with steep decays (|cum| in the hundreds) the weights
  // exp(cum_i - cum_j) lose ~1e-4 of their value, which the sums amplify
  const int rep = p.h / p.g, E = (Q + 31) / 32, j0 = lane * E;
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
    double mx = -INFINITY, mn = INFINITY, last = 0.0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) {
        cum[e] += off;
        mx = fmax(mx, cum[e]);
        mn = fmin(mn, cum[e]);
        if (j0 + e == Q - 1) last = cum[e];
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    const double center = 0.5 * (mx + mn);
    const double total = __shfl_sync(0xffffffffu, last, (Q - 1) / E);
    float* so = p.scal + (((long long)bb * p.nch + ch) * p.h + hh) * 4 * Q;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) {
        const int j = j0 + e;
        const double cj = cum[e];
        so[j] = expf(clip60(static_cast<float>(cj - center)));
        so[Q + j] = dts[e] * expf(clip60(static_cast<float>(center - cj)));
        so[2 * Q + j] = expf(static_cast<float>(total - cj)) * dts[e];
        so[3 * Q + j] = expf(static_cast<float>(cj));
      }
  }
}

// ---------------------------------------------------------------- 2. states
// tokens a slab of the states' sweep: the chunk, or half of it past kSlabQ
__host__ __device__ inline int slab_tokens(int Q) { return Q <= kSlabQ ? Q : Q / 2; }

// A block per (64 x 64 tile of n x p, head, batch row), 4 warps, warp w
// owning state rows 16 w .. 16 w + 15 of the tile: a sweep over the chunks
// in slabs of kSlabQ tokens (B and x double-buffered), the running state S
// and the chunk's own state in registers.
__global__ void __launch_bounds__(kStatesThreads) wide_states(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, KQ = slab_tokens(Q), halves = Q / KQ, nsl = p.nch * halves;
  const int stage = 2 * KQ * kXP + KQ;  // B [KQ][kXP], x [KQ][kXP], wj [KQ]
  const int ntn = (p.n + kTile - 1) / kTile;
  const int tn = blockIdx.x % ntn, tp = blockIdx.x / ntn, hh = blockIdx.y, bb = blockIdx.z;
  const int grp = group_of(hh, p.h, p.g);
  const int n0 = tn * kTile, c0 = tp * kTile;
  const int rows = min(kTile, p.n - n0), pw = min(kTile, p.p - c0), nct = (pw + 7) / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const bool active = r0 < rows, vec = p.p % 4 == 0;

  auto issue = [&](int sl, int st) {
    float* bs = sm + st * stage;
    float* xs = bs + KQ * kXP;
    float* wj = xs + KQ * kXP;
    const int ch = sl / halves, tok0 = ch * Q + (sl % halves) * KQ;
    copy_tile(bs, kXP, KQ, rows / 8, rows, true, [&](int r) -> const float* {
      if (r < 0) return p.B;
      const int tok = tok0 + r;
      return tok < p.s ? p.B + (((long long)bb * p.s + tok) * p.g + grp) * p.n + n0 : nullptr;
    }, tid, kStatesThreads);
    copy_tile(xs, kXP, KQ, nct, pw, vec, [&](int r) -> const float* {
      if (r < 0) return p.x;
      const int tok = tok0 + r;
      return tok < p.s ? p.x + (((long long)bb * p.s + tok) * p.h + hh) * p.p + c0 : nullptr;
    }, tid, kStatesThreads);
    const float* wsrc = p.scal + (((long long)bb * p.nch + ch) * p.h + hh) * 4 * Q + 2 * Q +
                        (sl % halves) * KQ;
    for (int i = tid; i < KQ / 4; i += kStatesThreads) cp_async16(wj + 4 * i, wsrc + 4 * i, true);
    cp_async_commit();
  };

  float S[8][4] = {}, acc[8][4] = {};
  issue(0, 0);
  for (int sl = 0; sl < nsl; ++sl) {
    const int ch = sl / halves, hf = sl % halves;
    if (hf == 0 && active) {  // the state entering chunk ch
      float* so = p.states + ((((long long)bb * p.nch + ch) * p.h + hh) * p.n + n0 + r0) * p.p + c0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < nct)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* d = so + (long long)(gq + 8 * half) * p.p + c * 8 + 2 * t;
            const int col = c * 8 + 2 * t;
            if (col < pw) d[0] = S[c][2 * half];
            if (col + 1 < pw) d[1] = S[c][2 * half + 1];
          }
    }
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // slab sl has landed
    if (active) {
      const float* bs = sm + (sl & 1) * stage;
      const float* xs = bs + KQ * kXP;
      const float* wj = xs + KQ * kXP;
      for (int k0 = 0; k0 < KQ; k0 += 8) {
        // A (n, j) = B[j][n] wj[j]
        const float w0 = wj[k0 + t], w1 = wj[k0 + t + 4];
        const float* pa = bs + (k0 + t) * kXP + r0 + gq;
        uint32_t ah[4], al[4];
        split(pa[0] * w0, ah[0], al[0]);
        split(pa[8] * w0, ah[1], al[1]);
        split(pa[4 * kXP] * w1, ah[2], al[2]);
        split(pa[4 * kXP + 8] * w1, ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < nct) {
            uint32_t bh[2], bl[2];
            load_b(xs, kXP, k0, c * 8, gq, t, bh, bl);
            mma3x(acc[c], ah, al, bh, bl);
          }
      }
      if (hf == halves - 1) {  // S <- exp(total) S + the chunk's own state
        const float et =
            p.scal[(((long long)bb * p.nch + ch) * p.h + hh) * 4 * Q + 3 * Q + Q - 1];
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

// ---------------------------------------------------------------- 3. out
// A block per (64 columns of p, head, batch x chunk), a warp per 16 rows of
// the chunk.  Shared memory: slab stage 0, then the x tile and the scalars,
// which slab stage 1 overwrites once the intra-chunk product is done.
__host__ __device__ inline int out_slab_floats(int Q) { return Q * kKP + kSlabN * kXP; }
__host__ __device__ inline int out_smem_floats(int Q) {
  const int slab = out_slab_floats(Q), xt = Q * kXP + 3 * Q;
  return slab + (xt > slab ? xt : slab);
}

__global__ void __launch_bounds__(256) wide_out(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4, slab = out_slab_floats(Q);
  const int tp = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z / p.nch, ch = blockIdx.z % p.nch;
  const int grp = group_of(hh, p.h, p.g);
  const int c0 = tp * kTile, pw = min(kTile, p.p - c0), nct = (pw + 7) / 8;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3, r0 = warp * 16;
  const bool vec = p.p % 4 == 0;
  float* xs = sm + slab;
  float* ai = xs + Q * kXP;
  float* dtb = ai + Q;
  float* ec = ai + 2 * Q;
  const long long sbase = (((long long)bb * p.nch + ch) * p.h + hh);

  // the chunk's x columns and its scalars ai, dtb, ec
  copy_tile(xs, kXP, Q, nct, pw, vec, [&](int r) -> const float* {
    if (r < 0) return p.x;
    const int tok = ch * Q + r;
    return tok < p.s ? p.x + (((long long)bb * p.s + tok) * p.h + hh) * p.p + c0 : nullptr;
  }, tid, nthr);
  const float* ssrc = p.scal + sbase * 4 * Q;
  for (int i = tid; i < 3 * Q / 4; i += nthr) {
    const int row = i / (Q / 4), q = i % (Q / 4);   // ai, dtb, then ec (scalar row 3)
    cp_async16(ai + row * Q + 4 * q, ssrc + (row == 2 ? 3 : row) * Q + 4 * q, true);
  }
  cp_async_commit();

  // C . S_in in slabs of kSlabN state rows; the state entering chunk 0 is zero
  const int nsl = ch > 0 ? (p.n + kSlabN - 1) / kSlabN : 0;
  const float* states_in = p.states + sbase * p.n * p.p + c0;
  auto issue = [&](int sl, int st) {
    float* cs = sm + st * slab;
    float* ss = cs + Q * kKP;
    const int k0 = sl * kSlabN, kw = min(kSlabN, p.n - k0);
    copy_tile(cs, kKP, Q, kw / 8, kw, true, [&](int r) -> const float* {
      if (r < 0) return p.C;
      const int tok = ch * Q + r;
      return tok < p.s ? p.C + (((long long)bb * p.s + tok) * p.g + grp) * p.n + k0 : nullptr;
    }, tid, nthr);
    copy_tile(ss, kXP, kw, nct, pw, vec, [&](int r) -> const float* {
      return r < 0 ? p.states : states_in + (long long)(k0 + r) * p.p;
    }, tid, nthr);
    cp_async_commit();
  };
  if (nsl > 0) {
    issue(0, 0);
    cp_async_wait_one();
  } else {
    cp_async_wait_all();
  }
  __syncthreads();  // x and the scalars have landed

  float yi[8][4] = {}, ys[8][4] = {};
  // -------- G diag(dtb) x, G = 0 past the diagonal: stop at the strip's end
  const float* G = p.gram + (((long long)bb * p.nch + ch) * p.g + grp) * Q * GP;
  for (int k0 = 0; k0 < r0 + 16; k0 += 8) {
    const float* pg = G + (r0 + gq) * GP + k0 + t;
    const float d0 = dtb[k0 + t], d1 = dtb[k0 + t + 4];
    uint32_t ah[4], al[4];
    split(__ldg(pg) * d0, ah[0], al[0]);
    split(__ldg(pg + 8 * GP) * d0, ah[1], al[1]);
    split(__ldg(pg + 4) * d1, ah[2], al[2]);
    split(__ldg(pg + 8 * GP + 4) * d1, ah[3], al[3]);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nct) {
        uint32_t bh[2], bl[2];
        load_b(xs, kXP, k0, c * 8, gq, t, bh, bl);
        mma3x(yi[c], ah, al, bh, bl);
      }
  }
  const float A0 = ai[r0 + gq], A1 = ai[r0 + gq + 8], E0 = ec[r0 + gq], E1 = ec[r0 + gq + 8];
  __syncthreads();  // x is read before slab stage 1 overwrites it

  // -------- C S_in
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      issue(sl + 1, (sl + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // slab sl has landed
    const float* cs = sm + (sl & 1) * slab;
    const float* ss = cs + Q * kKP;
    const int kw = min(kSlabN, p.n - sl * kSlabN);
    for (int kk = 0; kk < kw; kk += 8) {
      float v[4];
      uint32_t ah[4], al[4];
      ldsm_a(cs, kKP, r0, kk, lane, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], ah[e], al[e]);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < nct) {
          uint32_t bh[2], bl[2];
          load_b(ss, kXP, kk, c * 8, gq, t, bh, bl);
          mma3x(ys[c], ah, al, bh, bl);
        }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // -------- y = ai (intra) + ec (inter), masked to p and s
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = ch * Q + r0 + gq + 8 * half;
    if (tok >= p.s) continue;
    const float A_ = half ? A1 : A0, E_ = half ? E1 : E0;
    float* yrow = p.y + (((long long)bb * p.s + tok) * p.h + hh) * p.p + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < nct) {
        const int col = c * 8 + 2 * t;
        if (col < pw) yrow[col] = A_ * yi[c][2 * half] + E_ * ys[c][2 * half];
        if (col + 1 < pw) yrow[col + 1] = A_ * yi[c][2 * half + 1] + E_ * ys[c][2 * half + 1];
      }
  }
}

bool shape_ok(int b, int s, int h, int g, int p, int n, int Q) {
  return b >= 1 && s >= 1 && h >= 1 && g >= 1 && h % g == 0 && p >= 1 && n >= 16 &&
         n % 16 == 0 && Q >= 16 && Q <= 128 && Q % 16 == 0 &&
         (long long)b * ((s + Q - 1) / Q) <= 65535 && (long long)b * g <= 65535 && h <= 65535;
}

long long states_floats(int b, int nch, int h, int n, int p) {
  return (long long)b * nch * h * n * p;
}
long long gram_floats(int b, int nch, int g, int Q) { return (long long)b * nch * g * Q * (Q + 4); }

int prep_smem(int Q) { return 2 * 2 * Q * kKP * 4; }
int states_smem(int Q) {
  const int KQ = slab_tokens(Q);
  return 2 * (2 * KQ * kXP + KQ) * 4;
}

cudaError_t allow_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Bytes of the scratch buffer mamba_ssd_wide_fwd needs: the states entering
// each chunk (b, chunks, h, n, p) first, then each chunk's Gram per group
// and the scalars per head.
extern "C" long long mamba_ssd_wide_scratch_bytes(int b, int s, int h, int g, int p, int n,
                                                  int chunk) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return 0;
  const int nch = (s + chunk - 1) / chunk;
  return 4 * (states_floats(b, nch, h, n, p) + gram_floats(b, nch, g, chunk) +
              (long long)b * nch * h * 4 * chunk);
}

// All tensors f32 and contiguous, 16-byte aligned; scratch holds
// mamba_ssd_wide_scratch_bytes.  Three launches on `stream`; returns
// cudaGetLastError() after them, or -1 for a shape this kernel does not
// take (g | h; n a multiple of 16; chunk a multiple of 16 in [16, 128]).
extern "C" int mamba_ssd_wide_fwd(const void* x, const void* a, const void* dt, const void* B,
                                  const void* C, void* y, void* scratch, int b, int s, int h,
                                  int g, int p, int n, int chunk, void* stream) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return -1;
  const int Q = chunk, nch = (s + Q - 1) / Q;
  float* sc = static_cast<float*>(scratch);
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<float*>(y),
             sc, sc + states_floats(b, nch, h, n, p),
             sc + states_floats(b, nch, h, n, p) + gram_floats(b, nch, g, Q),
             b, s, h, g, p, n, Q, nch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = Q / 16, ntn = (n + kTile - 1) / kTile, ntp = (p + kTile - 1) / kTile;
  // at most 74 KB a block (chunk 128): within the 227 KB for every chunk taken
  const int smem_prep = prep_smem(Q), smem_states = states_smem(Q),
            smem_out = out_smem_floats(Q) * 4;

  cudaError_t e = allow_smem(reinterpret_cast<const void*>(wide_prep), smem_prep);
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_prep<<<dim3(nch, b * g), 32 * warps, smem_prep, st>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  e = allow_smem(reinterpret_cast<const void*>(wide_states), smem_states);
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_states<<<dim3(ntn * ntp, h, b), kStatesThreads, smem_states, st>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  e = allow_smem(reinterpret_cast<const void*>(wide_out), smem_out);
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_out<<<dim3(ntp, h, b * nch), 32 * warps, smem_out, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_ssd_wide_error_string(int code) {
  if (code < 0) return "unsupported shape (g | h; n a multiple of 16; chunk a multiple of 16 "
                       "in [16, 128]; batch x chunks <= 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
