// Grouped, wide-head chunked SSD scan for Hopper, sm_90a: f32 in and out,
// every product on the tensor cores in 3xTF32.
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
// Design.  Two launches (three where n > 1024):
// 1. prep, a block per (chunk, batch, group): the causal Gram
//    G = tril(C B^T) (mma.sync, K = n in slabs of 32 state columns) and per
//    head of the group the decay scalars ai, dtb, wj, ec (a warp per head:
//    the prefix scan and the centre in double, then the exps), into a
//    scratch buffer the wrapper allocates.
// 2. scan, a cluster of 8 blocks per (batch, head, 128-column strip of p),
//    block r of the cluster holding the 128 x 128 slice of the state S^T
//    (p x n) for state rows n0 = 128 r .. n0 + 127 in registers, 64 p rows
//    a warpgroup, for the whole sweep over the chunks.  Per chunk:
//    a. C.S_in on wgmma with S^T as the register A operand: the block's
//       partial (p x Q) over its n slice, in units of 32 tokens, written to
//       its shared memory;
//    b. S^T <- exp(total) S^T + x^T (wj B) on wgmma (both operands from
//       shared memory), in slabs of 32 tokens; with each slab, the block's
//       share of the in-chunk term, (G diag dtb) x for the Q / 8 rows i it
//       owns;
//    c. each block sums the 8 partials of its Q / 8 rows through
//       distributed shared memory, rank 0 first, and writes
//       y = ai (G diag dtb x) + ec (C.S_in).
//    A step (a unit or a slab): its raw f32 tiles, copied by cp.async two
//    steps ahead into one of two slots, are split into the operands; the
//    copies of the step after next are issued; then the products run,
//    nothing else between a wgmma and its wait (ptxas serialises them
//    otherwise).  The state never leaves the chip; with states requested
//    (training) the state entering each chunk is also written, (b, chunks,
//    h, n, p) f32 at the head of the scratch (mamba_ssd_fwd_states' layout,
//    which mamba_ssd_wide_bwd.cu reads).  Past n = 1024 several clusters
//    split n; each writes its partial y to the scratch and
// 3. sum adds them in cluster order.
// For p <= 4 (the normaliser) the scan is the narrow launch instead (2b
// below: f32 FMA, no Gram: the prep writes only the scalars).
// On chip a block holds 64 KB of state in registers, a cluster 512 KB (a
// 1024 x 128 strip), and 224 KB of shared memory: the step's operands (64
// KB), two slots of raw tiles (66 KB) and the chunk's Gram rows and scalars
// (10 KB), G dtb for its rows (16 KB), the partials (68 KB).  The strip
// width trades state on chip against the reads of B and C from L2, once
// per strip: at the prefill 8 strips read B and C 8 times (2.15 GB) and 8
// slices read x 8 times (1.07 GB), ~3.2 GB from L2 a call.
//
// Operands are split as hi = tf32(v), lo = tf32(v - hi) once, by the
// step's split from the raw tiles into wgmma's K-major layout (no swizzle:
// 8-row core matrices of 16 bytes, K cores 128 bytes apart, row groups
// 256): C with its 8-column groups permuted (slot t holds column
// 2t, slot t + 4 column 2t + 1), which is how the accumulator layout of
// S^T reads as an A fragment; x, wj B and G dtb transposed to K = tokens.
// S^T is split in registers once a unit.  Each k-group (C.S: 16 state
// rows, 2 k-steps, 6 wgmma of lo.hi + hi.lo + hi.hi; the update and the
// in-chunk term: a slab's 32 tokens, 4 k-steps) is summed by the tensor
// core from zero and added to its f32 accumulator by FADD: the tensor
// core's own additions do not round to nearest, and over long sums (K = n
// = 1024, 384 of them into one accumulator) their error grows past the
// tolerance.
// Sums run in a fixed order and nothing is atomic: two calls are
// bit-equal.  Its arithmetic on the CPU: kernels/ref.py
// mamba_ssd_wide_tf32.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

#include "ssd_common.cuh"
#include "ssd_wgmma.cuh"

namespace {

using ssd::clip60;
using ssd::cluster_arrive;
using ssd::cluster_wait;
using ssd::cp_async16;
using ssd::cp_async_commit;
using ssd::cp_async_wait_all;
using ssd::cp_async_wait_one;
using ssd::fence_async_smem;
using ssd::kdesc;
using ssd::kofs;
using ssd::ld_cluster2;
using ssd::load_a;
using ssd::mma;
using ssd::pin;
using ssd::put4;
using ssd::smem_u32;
using ssd::split;
using ssd::wg_commit;
using ssd::wg_fence;
using ssd::wg_wait0;
using ssd::wgmma_rs32;
using ssd::wgmma_ss128;
using ssd::wgmma_ss16;

constexpr int kSlabN = 32;    // state columns of a prep slab
constexpr int kKP = kSlabN + 4;  // its pitch (floats): 4 mod 32, read (r + g) * pitch + k + t

struct Params {
  const float* x;   // (b, s, h, p)
  const float* a;   // (b, s, h)  log decay
  const float* dt;  // (b, s, h)  input scale
  const float* B;   // (b, s, g, n)
  const float* C;   // (b, s, g, n)
  float* y;         // (b, s, h, p)
  float* states;    // (b, chunks, h, n, p): the state entering each chunk, or null
  float* gram;      // (b, chunks, g, Q, Q + 4): the causal Gram of each chunk and group
  float* scal;      // (b, chunks, h, 4, Q): ai, dtb, wj, ec (ec[Q-1] = exp(total))
  float* ypart;     // (ncl, b, s, h, p): each cluster's partial y where ncl > 1, else null
  int b, s, h, g, p, n, Q, nch, ncl;
};

// the group whose B and C head hh reads
__device__ __forceinline__ int group_of(int hh, int h, int g) { return hh / (h / g); }

// acc <- acc + u.v in 3xTF32: lo.hi + hi.lo + hi.hi of one k-step summed in
// the tensor core from zero, then added to acc in FP32 (round to nearest)
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
  if (p.gram != nullptr) {  // the Gram (the narrow path needs none)
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

// ---------------------------------------------------------------- 2. scan
constexpr int kThreads = 256;          // two warpgroups
constexpr int kPW = 128;               // p columns of a block's strip, 64 a warpgroup
constexpr int kNS = 128;               // state rows of a block's slice of n
constexpr int kCL = 8;                 // blocks of a cluster, one slice of n each
constexpr int kTU = 32;                // tokens of a C unit (the N of C.S)
constexpr int kTS = 32;                // tokens of an x / B slab (one k-group)
constexpr int kQmax = 128;
constexpr int kIS = 16;                // rows i of a block's share (Q / 8), padded
constexpr int kPartPitch = kQmax + 8;  // floats: a float2 a lane, conflict-free
// shared memory (floats): the operands of a step (C hi, lo; or x hi, lo,
// wj B hi, lo); two slots of raw tiles, for the next two steps (C; or x,
// B and wj); a chunk's raw Gram rows, dtb, ai and ec; G dtb hi and lo for
// the block's rows; the partials (p x Q)
constexpr int kStage = 4 * kTS * kPW;
constexpr int kCLo = kTU * kNS;       // C lo's offset in the operands
constexpr int kGd = kIS * kQmax;
constexpr int kRawPitch = 128 + 4;    // a lane a row: conflict-free reads
constexpr int kRawC = 0, kRawX = 0;   // a step has C, or x and B (32 rows each)
constexpr int kRawB = kRawX + kTS * kRawPitch;
constexpr int kRawW = kRawB + kTS * kRawPitch;
constexpr int kSlot = kRawW + kTS;    // one slot of raw tiles
constexpr int kRawG = 2 * kSlot;
constexpr int kRawD = kRawG + kIS * kRawPitch;  // dtb, then ai, then ec
constexpr int kRaw = kRawD + 3 * kQmax;
constexpr int kScanFloats = kStage + kRaw + 2 * kGd + kPW * kPartPitch;
constexpr int kScanSmem = kScanFloats * 4;
static_assert(kTU * kRawPitch <= kSlot, "a C unit's rows fit a slot");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

struct Block {
  int rank, cgrp, hh, bb, grp, n0, nv, c0, pw, qs, i0;
  int U1, U2, spc;  // C units and x / B slabs a chunk, steps a chunk
};

// ---- the raw tiles of step `step` into its slot (and, for the chunk's
// first slab, its Gram rows and scalars into their own area) by cp.async,
// two steps ahead, in fixed trip counts; only what is in range is copied
// (the split zeroes the rest)
__device__ __forceinline__ void issue_raw(const Params& p, const Block& k, int step, float* raw) {
  if (step >= p.nch * k.spc) return;
  const int tid = threadIdx.x, Q = p.Q, ch = step / k.spc, j = step % k.spc;
  float* slot = raw + (step & 1) * kSlot;
  const long long cb = (long long)k.bb * p.nch + ch;
  const bool cunit = j < k.U1;
  const int tin0 = (cunit ? j : j - k.U1) * kTS;
  const int rows = min(kTS, min(Q - tin0, p.s - ch * Q - tin0));  // tokens in range
  const long long tok0 = (long long)k.bb * p.s + ch * Q + tin0;
  const float* bc = (cunit ? p.C : p.B) + (tok0 * p.g + k.grp) * p.n + k.n0;
#pragma unroll
  for (int q = 0; q < kTS * 32 / kThreads; ++q) {  // C, or B: 16-byte pieces
    const int item = tid + kThreads * q, r = item >> 5, c4 = item & 31;
    if (r < rows && 4 * c4 < k.nv)
      cp_async16(slot + (cunit ? kRawC : kRawB) + r * kRawPitch + 4 * c4,
                 bc + (long long)r * p.g * p.n + 4 * c4, true);
  }
  if (cunit) return;
  const float* xs = p.x + (tok0 * p.h + k.hh) * p.p + k.c0;
  const long long xrow = (long long)p.h * p.p;
  if (p.p % 4 == 0) {  // x: 16-byte pieces
#pragma unroll
    for (int q = 0; q < kTS * 32 / kThreads; ++q) {
      const int item = tid + kThreads * q, r = item >> 5, c4 = item & 31;
      if (r < rows && 4 * c4 < k.pw)
        cp_async16(slot + kRawX + r * kRawPitch + 4 * c4, xs + r * xrow + 4 * c4, true);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kTS * kPW / kThreads; ++q) {
      const int item = tid + kThreads * q, r = item >> 7, e = item & 127;
      if (r < rows && e < k.pw) cp_async4(slot + kRawX + r * kRawPitch + e, xs + r * xrow + e);
    }
  }
  const float* sc = p.scal + (cb * p.h + k.hh) * 4 * Q;
  if (tid < kTS / 4 && 4 * tid < Q - tin0)
    cp_async16(slot + kRawW + 4 * tid, sc + 2 * Q + tin0 + 4 * tid, true);
  if (j == k.U1) {  // the chunk's first slab: the block's Gram rows, dtb, ai and ec
    const int GP = Q + 4;
    const float* G = p.gram + (cb * p.g + k.grp) * Q * GP + (long long)k.i0 * GP;
#pragma unroll
    for (int q = 0; q < kIS * 32 / kThreads; ++q) {
      const int item = tid + kThreads * q, r = item >> 5, c4 = item & 31;
      if (r < k.qs && 4 * c4 < Q)
        cp_async16(raw + kRawG + r * kRawPitch + 4 * c4, G + r * GP + 4 * c4, true);
    }
    if (tid < 3 * (Q / 4)) {
      const int which = tid / (Q / 4), q4 = tid % (Q / 4);  // dtb, ai, ec
      cp_async16(raw + kRawD + which * kQmax + 4 * q4,
                 sc + (which == 0 ? Q : which == 1 ? 0 : 3 * Q) + 4 * q4, true);
    }
  }
}

// ---- the split: raw tiles into the hi / lo operand tiles, wgmma's K-major
// layout (every operand split once); each thread loads all it splits first
// a C unit: the B operand of C.S, 16 k-steps of 32 token rows, hi at ops,
// lo at ops + kCLo; the 8 columns of a k-step permuted (slot t: column 2t,
// slot t + 4: 2t + 1), the order in which S^T's accumulator reads as A
__device__ __forceinline__ void split_c(const Params& p, const Block& k, int ch, int u,
                                        const float* __restrict__ slot, float* __restrict__ ops) {
  constexpr int kItems = kTU * (kNS / 8) / kThreads;
  float4 v[kItems][2];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kTU, ks = item / kTU;
    const float4* src = reinterpret_cast<const float4*>(slot + kRawC + r * kRawPitch + 8 * ks);
    v[q][0] = src[0];
    v[q][1] = src[1];
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kTU, ks = item / kTU;
    const int tin = u * kTU + r;
    if (!(tin < p.Q && ch * p.Q + tin < p.s && 8 * ks < k.nv))
      v[q][0] = v[q][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    float* hi = ops + kofs(r, 2 * ks, kTU);
    put4(hi, hi + kCLo, v[q][0].x, v[q][0].z, v[q][1].x, v[q][1].z);
    put4(hi + 32, hi + kCLo + 32, v[q][0].y, v[q][0].w, v[q][1].y, v[q][1].w);
  }
}

// a slab: x^T (the strip's 128 p rows) and (wj B)^T (the slice's 128 n
// rows), K = tokens, 4 k-steps of 128 rows each: x hi, x lo, wB hi, wB lo
// at ops + 0, 1, 2, 3 quarters of a stage.  x rows past the strip are not
// written (they only feed output rows past it); wB rows past the slice are
// zero (their state rows meet C's zero columns in C.S)
__device__ __forceinline__ void split_xw(const Params& p, const Block& k, int ch, int sl,
                                         const float* __restrict__ slot,
                                         float* __restrict__ ops) {
  const int valid = min(kTS, min(p.Q - sl * kTS, p.s - ch * p.Q - sl * kTS));
#pragma unroll
  for (int q = 0; q < kPW * kTS / 4 / kThreads; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kPW, kc = item / kPW;
    float v[4], w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = 4 * kc + e;
      const bool in = tt < valid;
      v[e] = in && r < k.pw ? slot[kRawX + tt * kRawPitch + r] : 0.f;
      w[e] = in && r < k.nv ? slot[kRawB + tt * kRawPitch + r] * slot[kRawW + tt] : 0.f;
    }
    float* hi = ops + kofs(r, kc, kPW);
    if (r < k.pw) put4(hi, hi + kStage / 4, v[0], v[1], v[2], v[3]);
    put4(hi + kStage / 2, hi + 3 * kStage / 4, w[0], w[1], w[2], w[3]);
  }
}

// the block's rows of G diag(dtb) for the chunk: 16 rows i (i0 .. i0 + qs -
// 1, the rest zero), K = j over the chunk's slabs, zero past the diagonal
// (the prep writes only up to it) and past Q: the B operand of the
// in-chunk term, hi at gd, lo at gd + kGd
__device__ __forceinline__ void split_gd(const Params& p, const Block& k,
                                         const float* __restrict__ raw, float* __restrict__ gd) {
  constexpr int kItems = kIS * kQmax / 4 / kThreads;
  float4 gv[kItems], d[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kIS, kc = item / kIS;
    gv[q] = *reinterpret_cast<const float4*>(raw + kRawG + r * kRawPitch + 4 * kc);
    d[q] = *reinterpret_cast<const float4*>(raw + kRawD + 4 * kc);
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kIS, kc = item / kIS;
    const int i = k.i0 + r;
    const bool ok = r < k.qs && 4 * kc < p.Q;
    float* hi = gd + kofs(r, kc, kIS);
    put4(hi, hi + kGd, ok && 4 * kc <= i ? gv[q].x * d[q].x : 0.f,
         ok && 4 * kc + 1 <= i ? gv[q].y * d[q].y : 0.f,
         ok && 4 * kc + 2 <= i ? gv[q].z * d[q].z : 0.f,
         ok && 4 * kc + 3 <= i ? gv[q].w * d[q].w : 0.f);
  }
}

// A cluster of 8 blocks per (strip of 128 p columns, cluster group of n,
// head, batch row); block rank r holds S^T for state rows n0 = 128 (8 cgrp
// + r) .. n0 + 127 of the strip in registers (warpgroup w: p rows 64 w ..
// 64 w + 63, its accumulator layout) over the whole sweep.  The steps of a
// chunk: its C units (C.S_in into the partials), then its x / wB slabs
// (the state update and the in-chunk term).  A step: its raw tiles (copied
// two steps ahead) are split into the operands, the copies of the step
// after the next are issued, then the products run with nothing else
// between a wgmma and its wait (ptxas serialises them otherwise).
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1) wide_scan(Params p) {
  extern __shared__ __align__(128) float ssm[];
  float* const ops = ssm;
  float* const raw = ops + kStage;
  float* const gd = raw + kRaw;
  float* const part = gd + 2 * kGd;
  const int Q = p.Q;
  Block k;
  k.rank = blockIdx.x % kCL;  // the cluster's rank (its 8 blocks are consecutive in x)
  k.cgrp = (blockIdx.x / kCL) % p.ncl;
  const int strip = blockIdx.x / (kCL * p.ncl);
  k.hh = blockIdx.y;
  k.bb = blockIdx.z;
  k.grp = group_of(k.hh, p.h, p.g);
  k.n0 = (k.cgrp * kCL + k.rank) * kNS;
  k.nv = max(0, min(kNS, p.n - k.n0));
  k.c0 = strip * kPW;
  k.pw = min(kPW, p.p - k.c0);
  k.qs = Q / kCL;
  k.i0 = k.rank * k.qs;
  k.U1 = (Q + kTU - 1) / kTU;
  k.U2 = (Q + kTS - 1) / kTS;
  k.spc = k.U1 + k.U2;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3, row0 = wg * 64 + warp * 16 + gq;  // + 8 for e >= 2
  const bool mine = wg * 64 < k.pw;    // the warpgroup has a p row in the strip
  const bool prod = mine && k.nv > 0;  // ... and a state row
  const int nsteps = p.nch * k.spc;
  const long long ysize = (long long)p.b * p.s * p.h * p.p;
  // the cluster's blocks that hold state rows (their partials are summed)
  const int nranks = min(kCL, (p.n - k.cgrp * kCL * kNS + kNS - 1) / kNS);

  float S[64], yi[8], ai[4], ec[4], et = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) S[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) yi[e] = 0.f;

  issue_raw(p, k, 0, raw);
  cp_async_commit();
  issue_raw(p, k, 1, raw);
  cp_async_commit();
  cluster_arrive();  // nobody reads the partials yet

  for (int step = 0; step < nsteps; ++step) {
    const int ch = step / k.spc, j = step % k.spc;
    cp_async_wait_one();
    __syncthreads();  // this step's raw tiles have landed; the last step's products are done
    const float* slot = raw + (step & 1) * kSlot;
    if (j < k.U1) {
      if (k.nv > 0) split_c(p, k, ch, j, slot, ops);
    } else {
      split_xw(p, k, ch, j - k.U1, slot, ops);
      if (j == k.U1) {  // the chunk's G dtb, and the scalars this thread's rows need
        split_gd(p, k, raw, gd);
        et = raw[kRawD + 2 * kQmax + Q - 1];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tin = min(k.i0 + 8 * c + 2 * t + e, Q - 1);
            ai[2 * c + e] = raw[kRawD + kQmax + tin];
            ec[2 * c + e] = raw[kRawD + 2 * kQmax + tin];
          }
      }
    }
    fence_async_smem();  // the operands, written by every thread, are seen by wgmma
    __syncthreads();     // ... and the slot is free
    issue_raw(p, k, step + 2, raw);
    cp_async_commit();
    if (j == 0 && p.states != nullptr && prod) {  // the state entering chunk ch
      float* so = p.states + (((long long)k.bb * p.nch + ch) * p.h + k.hh) * p.n * p.p;
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * c + 2 * t + (e & 1), pr = row0 + 8 * (e >> 1);
          if (col < k.nv && pr < k.pw) so[(long long)(k.n0 + col) * p.p + k.c0 + pr] = S[4 * c + e];
        }
    }
    if (j < k.U1) {
      // ---- C.S_in for tokens 32 j .. 32 j + 31: the block's partial, in
      // k-groups of 16 state rows (2 k-steps: 32 registers of A fragments
      // would spill), each summed from zero and added by FADD
      float acc[16];
      if (prod) {
#pragma unroll
        for (int kg = 0; kg < 8; ++kg) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c = 2 * kg + q;  // k-step: state rows 8 c .. 8 c + 7
            split(S[4 * c + 0], ah[q][0], al[q][0]);
            split(S[4 * c + 2], ah[q][1], al[q][1]);
            split(S[4 * c + 1], ah[q][2], al[q][2]);
            split(S[4 * c + 3], ah[q][3], al[q][3]);
          }
          float tmp[16];
          wg_fence();
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* bh = ops + (2 * kg + q) * kTU * 8;
            const uint64_t dh = kdesc(bh), dl = kdesc(bh + kCLo);
            wgmma_rs32(tmp, al[q], dh, q > 0);
            wgmma_rs32(tmp, ah[q], dl, 1);
            wgmma_rs32(tmp, ah[q], dh, 1);
          }
          wg_commit();
          wg_wait0();
          pin(tmp);
          pin(ah);
          pin(al);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = kg == 0 ? tmp[e] : acc[e] + tmp[e];
        }
      }
      if (j == 0) cluster_wait();  // every block is done reading the last chunk's partials
      if (prod) {
#pragma unroll
        for (int c = 0; c < kTU / 8; ++c)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int col = j * kTU + 8 * c + 2 * t;
            if (col < Q)
              *reinterpret_cast<float2*>(part + (row0 + 8 * hf) * kPartPitch + col) =
                  make_float2(acc[4 * c + 2 * hf], acc[4 * c + 2 * hf + 1]);
          }
      }
      if (j == k.U1 - 1) cluster_arrive();  // this chunk's partials are written
    } else {
      // ---- S^T <- exp(total) S^T + x^T (wj B) and the in-chunk term, tokens 32 sl ..
      const int sl = j - k.U1;
      if (sl == 0 && prod) {
#pragma unroll
        for (int e = 0; e < 64; ++e) S[e] *= et;
      }
      const bool intra = mine && k.cgrp == 0 && sl * kTS < k.i0 + k.qs;
      float tmp[64], itmp[8];
      wg_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* xh = ops + q * kPW * 8 + wg * 8 * 64;
        const float* xl = xh + kStage / 4;
        const float* wh = ops + kStage / 2 + q * kNS * 8;
        const float* wl = wh + kStage / 4;
        if (prod) {
          wgmma_ss128(tmp, kdesc(xl), kdesc(wh), q > 0);
          wgmma_ss128(tmp, kdesc(xh), kdesc(wl), 1);
          wgmma_ss128(tmp, kdesc(xh), kdesc(wh), 1);
        }
        if (intra) {
          const float* gh = gd + (4 * sl + q) * kIS * 8;
          wgmma_ss16(itmp, kdesc(xl), kdesc(gh), q > 0);
          wgmma_ss16(itmp, kdesc(xh), kdesc(gh + kGd), 1);
          wgmma_ss16(itmp, kdesc(xh), kdesc(gh), 1);
        }
      }
      wg_commit();
      wg_wait0();
      pin(tmp);
      pin(itmp);
      if (prod) {
#pragma unroll
        for (int e = 0; e < 64; ++e) S[e] += tmp[e];
      }
      if (intra) {
#pragma unroll
        for (int e = 0; e < 8; ++e) yi[e] = sl == 0 ? itmp[e] : yi[e] + itmp[e];
      }
      if (sl == k.U2 - 1) {
        // ---- y for the block's rows: the partials summed in rank order
        cluster_wait();  // every block's partials of this chunk are written
        if (mine) {
          float* yo = p.ncl > 1 ? p.ypart + k.cgrp * ysize : p.y;
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int ic = 8 * c + 2 * t, pr = row0 + 8 * hf;
              const uint32_t la =
                  smem_u32(part + (row0 + 8 * hf) * kPartPitch + k.i0 + min(ic, k.qs - 2));
              float2 v[kCL];  // the ranks' loads in flight, then the sum in rank order
#pragma unroll
              for (int r = 0; r < kCL; ++r)
                v[r] = r < nranks ? ld_cluster2(la, r) : make_float2(0.f, 0.f);
              float2 sum = v[0];
#pragma unroll
              for (int r = 1; r < kCL; ++r)
                if (r < nranks) {
                  sum.x += v[r].x;
                  sum.y += v[r].y;
                }
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int tok = ch * Q + k.i0 + ic + e;
                if (ic >= k.qs || pr >= k.pw || tok >= p.s) continue;
                const float inter = ec[2 * c + e] * (e ? sum.y : sum.x);
                const float val = k.cgrp == 0 ? ai[2 * c + e] * yi[4 * c + 2 * hf + e] + inter
                                              : inter;
                yo[(((long long)k.bb * p.s + tok) * p.h + k.hh) * p.p + k.c0 + pr] = val;
              }
            }
        }
        cluster_arrive();  // done reading the partials
      }
    }
  }
  cluster_wait();  // no block leaves while another may read its partials
}

// ---------------------------------------------------------------- 2b. narrow
// p up to kNarrowP (the mLSTM's normaliser, p = 1) in f32 FMA: its products
// are matrix-vector ones, too thin for a 64-row wgmma, and its time is the
// stream of B and C.  A cluster of 8 blocks per (cluster group of n, head,
// batch row), block rank r holding state rows n0 = 128 (8 cgrp + r) .. n0 +
// 127, a thread a row, over the sweep.  The in-chunk term in prefix form:
//   ai_i sum_{j<=i} (C_i.B_j) dtb_j x_j = ai_i C_i . R_i,  R_i = sum_{j<=i} dtb_j x_j B_j
// (the same function, no Gram needed).  Per token the block's partial of
// ai C.R + ec C.S_in is summed over its rows (a warp's lanes by a
// reduce-scatter of shuffles, then the 4 warps in order), then over the
// cluster in rank order as in the scan.  B and C stream through a ring of
// kNSlots steps of 32 tokens by cp.async.
constexpr int kNarrowP = 4;
constexpr int kNThreads = 128;
constexpr int kNSlots = 5;
constexpr int kNB = kTS * kNS, kNX = 2 * kTS * kNS;  // C at 0, B, x (32 x 4), then
constexpr int kNSc = kNX + kTS * kNarrowP;           // dtb, wj, ai, ec (32 each)
constexpr int kNSlot = kNSc + 4 * kTS;
constexpr int kNWarpPart = kNSlots * kNSlot;          // the warps' sums (4 x 32 x p)
constexpr int kNPart = kNWarpPart + 4 * kTS * kNarrowP;  // the block's partials (Q x p)
constexpr int kNarrowSmem = (kNPart + kQmax * kNarrowP) * 4;

__device__ __forceinline__ void narrow_issue(const Params& p, const Block& k, int step,
                                             float* raw) {
  if (step >= p.nch * k.spc) return;
  const int tid = threadIdx.x, Q = p.Q, ch = step / k.spc, tin0 = (step % k.spc) * kTS;
  float* slot = raw + (step % kNSlots) * kNSlot;
  const int rows = min(kTS, min(Q - tin0, p.s - ch * Q - tin0));
  const long long tok0 = (long long)k.bb * p.s + ch * Q + tin0;
  const float* bsrc = p.B + (tok0 * p.g + k.grp) * p.n + k.n0;
  const float* csrc = p.C + (tok0 * p.g + k.grp) * p.n + k.n0;
#pragma unroll 4
  for (int q = 0; q < kTS * 32 / kNThreads; ++q) {
    const int item = tid + kNThreads * q, r = item >> 5, c4 = item & 31;
    if (r < rows && 4 * c4 < k.nv) {
      const long long off = (long long)r * p.g * p.n + 4 * c4;
      cp_async16(slot + r * kNS + 4 * c4, csrc + off, true);
      cp_async16(slot + kNB + r * kNS + 4 * c4, bsrc + off, true);
    }
  }
  const float* xs = p.x + (tok0 * p.h + k.hh) * p.p;
  if (tid < rows * p.p) {
    const int r = tid / p.p, e = tid % p.p;
    cp_async4(slot + kNX + r * kNarrowP + e, xs + (long long)r * p.h * p.p + e);
  }
  const float* sc = p.scal + (((long long)k.bb * p.nch + ch) * p.h + k.hh) * 4 * Q;
  const int pieces = min(kTS, Q - tin0) / 4;
  if (tid < 4 * pieces) {  // dtb, wj, ai, ec
    const int which = tid / pieces, q4 = tid % pieces;
    const int row = which == 0 ? 1 : which == 1 ? 2 : which == 2 ? 0 : 3;
    cp_async16(slot + kNSc + which * kTS + 4 * q4, sc + row * Q + tin0 + 4 * q4, true);
  }
}

// NP: the p this instantiation holds a row (1, 2 or 4; p <= NP)
template <int NP>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kNThreads, 1)
    wide_narrow(Params p) {
  extern __shared__ __align__(128) float nsm[];
  float* const raw = nsm;
  float* const wpart = nsm + kNWarpPart;
  float* const part = nsm + kNPart;
  const int Q = p.Q;
  Block k;
  k.rank = blockIdx.x % kCL;
  k.cgrp = blockIdx.x / kCL;
  k.hh = blockIdx.y;
  k.bb = blockIdx.z;
  k.grp = group_of(k.hh, p.h, p.g);
  k.n0 = (k.cgrp * kCL + k.rank) * kNS;
  k.nv = max(0, min(kNS, p.n - k.n0));
  k.c0 = 0;
  k.pw = p.p;
  k.qs = Q / kCL;
  k.i0 = k.rank * k.qs;
  k.U1 = 0;
  k.U2 = k.spc = (Q + kTS - 1) / kTS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, P = p.p;
  const bool row_ok = tid < k.nv;
  const int nsteps = p.nch * k.spc;
  const long long ysize = (long long)p.b * p.s * p.h * p.p;
  const int nranks = min(kCL, (p.n - k.cgrp * kCL * kNS + kNS - 1) / kNS);

  float S[NP], R[NP], dS[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) S[c] = R[c] = dS[c] = 0.f;
#pragma unroll
  for (int st = 0; st < kNSlots - 1; ++st) {
    narrow_issue(p, k, st, raw);
    cp_async_commit();
  }
  cluster_arrive();  // nobody reads the partials yet

  for (int step = 0; step < nsteps; ++step) {
    const int ch = step / k.spc, sl = step % k.spc, tin0 = sl * kTS;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kNSlots - 2) : "memory");
    __syncthreads();  // this step's tiles have landed
    const float* slot = raw + (step % kNSlots) * kNSlot;
    const float* sc = slot + kNSc;
    const int valid = min(kTS, min(Q - tin0, p.s - ch * Q - tin0));
    if (sl == 0) {
      if (p.states != nullptr && row_ok) {  // the state entering chunk ch
        float* so =
            p.states + ((((long long)k.bb * p.nch + ch) * p.h + k.hh) * p.n + k.n0 + tid) * P;
        for (int c = 0; c < P; ++c) so[c] = S[c];
      }
#pragma unroll
      for (int c = 0; c < NP; ++c) R[c] = dS[c] = 0.f;
    }
    // each token's contribution of this row, then its sum over the warp's
    // rows by a reduce-scatter (lane l ends with token l's sum)
    float v[NP][kTS];
#pragma unroll
    for (int i = 0; i < kTS; ++i) {
      const bool in = i < valid && row_ok;  // (nothing out of range is read)
      const float b = in ? slot[kNB + i * kNS + tid] : 0.f, cc = in ? slot[i * kNS + tid] : 0.f;
      const float dtb = in ? sc[i] : 0.f, wj = in ? sc[kTS + i] : 0.f;
      const float ai = in ? sc[2 * kTS + i] : 0.f, ec = in ? sc[3 * kTS + i] : 0.f;
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        const float xv = in && c < P ? slot[kNX + i * kNarrowP + c] : 0.f;
        R[c] = fmaf(dtb * xv, b, R[c]);
        dS[c] = fmaf(wj * xv, b, dS[c]);
        v[c][i] = ai * (cc * R[c]) + ec * (cc * S[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (c >= P) break;
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) {
        const bool up = lane & w;
#pragma unroll
        for (int i = 0; i < w; ++i) {
          const float send = up ? v[c][i] : v[c][i + w];
          const float keep = up ? v[c][i + w] : v[c][i];
          v[c][i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      wpart[(warp * kTS + lane) * kNarrowP + c] = v[c][0];
    }
    if (sl == 0) cluster_wait();  // every block is done reading the last chunk's partials
    __syncthreads();
    if (tid < kTS * P) {  // the block's partial of token tin0 + i: its 4 warps in order
      const int i = tid / P, c = tid % P;
      float sum = wpart[i * kNarrowP + c];
      for (int w = 1; w < 4; ++w) sum += wpart[(w * kTS + i) * kNarrowP + c];
      if (tin0 + i < Q) part[(tin0 + i) * kNarrowP + c] = sum;
    }
    if (sl == k.spc - 1) {
      // S <- exp(total) S + the chunk's own state; then y for the block's rows
      const float et = sc[3 * kTS + (Q - 1 - tin0)];
#pragma unroll
      for (int c = 0; c < NP; ++c) S[c] = et * S[c] + dS[c];
      cluster_arrive();  // this chunk's partials are written
      cluster_wait();
      if (tid < k.qs * P) {
        const int i = tid / P, c = tid % P, tok = ch * Q + k.i0 + i;
        const uint32_t la = smem_u32(part + (k.i0 + i) * kNarrowP + c);
        float vr[kCL];
#pragma unroll
        for (int r = 0; r < kCL; ++r) {
          vr[r] = 0.f;
          if (r < nranks) {
            uint32_t remote;
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(la), "r"(r));
            asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                         : "=f"(vr[r])
                         : "r"(remote)
                         : "memory");
          }
        }
        float sum = vr[0];
#pragma unroll
        for (int r = 1; r < kCL; ++r)
          if (r < nranks) sum += vr[r];
        float* yo = p.ncl > 1 ? p.ypart + k.cgrp * ysize : p.y;
        if (tok < p.s) yo[(((long long)k.bb * p.s + tok) * p.h + k.hh) * P + c] = sum;
      }
      cluster_arrive();  // done reading the partials
    }
    __syncthreads();  // the slot and the warps' sums are free
    narrow_issue(p, k, step + kNSlots - 1, raw);
    cp_async_commit();
  }
  cluster_wait();  // no block leaves while another may read its partials
}

// ---------------------------------------------------------------- 3. sum
// y = the clusters' partial y in cluster order (n > 1024 only)
__global__ void __launch_bounds__(256) wide_sum(const float* part, float* y, long long total,
                                                int ncl) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += 256LL * gridDim.x) {
    float v = part[i];
    for (int c = 1; c < ncl; ++c) v += part[c * total + i];
    y[i] = v;
  }
}

bool shape_ok(int b, int s, int h, int g, int p, int n, int Q) {
  return b >= 1 && s >= 1 && h >= 1 && g >= 1 && h % g == 0 && p >= 1 && n >= 16 &&
         n % 16 == 0 && Q >= 16 && Q <= kQmax && Q % 16 == 0 &&
         (long long)b * ((s + Q - 1) / Q) <= 65535 && (long long)b * g <= 65535 && h <= 65535;
}

int clusters_of(int n) { return (n + kCL * kNS - 1) / (kCL * kNS); }

long long states_floats(int b, int nch, int h, int n, int p) {
  return (long long)b * nch * h * n * p;
}
// the narrow path (p <= kNarrowP) needs no Gram
long long gram_floats(int b, int nch, int g, int p, int Q) {
  return p <= kNarrowP ? 0 : (long long)b * nch * g * Q * (Q + 4);
}
long long scal_floats(int b, int nch, int h, int Q) { return (long long)b * nch * h * 4 * Q; }
long long ypart_floats(int b, int s, int h, int p, int n) {
  return clusters_of(n) > 1 ? (long long)clusters_of(n) * b * s * h * p : 0;
}

int prep_smem(int Q) { return 2 * 2 * Q * kKP * 4; }

// The shared-memory limits, set once a device (not a stream operation, and
// outside any capture after the first call)
cudaError_t prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(wide_prep),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, prep_smem(kQmax));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(wide_scan),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
  if (e != cudaSuccess) return e;
  const void* narrow[3] = {reinterpret_cast<const void*>(wide_narrow<1>),
                           reinterpret_cast<const void*>(wide_narrow<2>),
                           reinterpret_cast<const void*>(wide_narrow<4>)};
  for (const void* fn : narrow) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kNarrowSmem);
    if (e != cudaSuccess) return e;
  }
  if (dev < 64) ready[dev] = true;
  return cudaSuccess;
}

}  // namespace

// Bytes of the scratch buffer mamba_ssd_wide_fwd needs: with `states`, the
// states entering each chunk (b, chunks, h, n, p) first; then each chunk's
// Gram per group (past p = kNarrowP), the scalars per head and, past n =
// 1024, each cluster's partial y.
extern "C" long long mamba_ssd_wide_scratch_bytes(int b, int s, int h, int g, int p, int n,
                                                  int chunk, int states) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return 0;
  const int nch = (s + chunk - 1) / chunk;
  return 4 * ((states ? states_floats(b, nch, h, n, p) : 0) + gram_floats(b, nch, g, p, chunk) +
              scal_floats(b, nch, h, chunk) + ypart_floats(b, s, h, p, n));
}

// All tensors f32 and contiguous, 16-byte aligned; scratch holds
// mamba_ssd_wide_scratch_bytes(..., states).  Two launches on `stream`
// (three past n = 1024): the prep, then the scan (p > kNarrowP) or the
// narrow path; `states` writes the state entering each chunk at
// the head of the scratch.  Returns cudaGetLastError() after them, or -1
// for a shape this kernel does not take (g | h; n a multiple of 16; chunk a
// multiple of 16 in [16, 128]).
extern "C" int mamba_ssd_wide_fwd(const void* x, const void* a, const void* dt, const void* B,
                                  const void* C, void* y, void* scratch, int b, int s, int h,
                                  int g, int p, int n, int chunk, int states, void* stream) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return -1;
  const int Q = chunk, nch = (s + Q - 1) / Q, ncl = clusters_of(n);
  float* sc = static_cast<float*>(scratch);
  float* st_ptr = states ? sc : nullptr;
  float* gram = sc + (states ? states_floats(b, nch, h, n, p) : 0);
  float* scal = gram + gram_floats(b, nch, g, p, Q);
  float* ypart = ncl > 1 ? scal + scal_floats(b, nch, h, Q) : nullptr;
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<float*>(y), st_ptr,
             p <= kNarrowP ? nullptr : gram, scal, ypart, b, s, h, g, p, n, Q, nch, ncl};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);

  wide_prep<<<dim3(nch, b * g), 32 * (Q / 16), prep_smem(Q), st>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  if (p > kNarrowP) {
    const int strips = (p + kPW - 1) / kPW;
    wide_scan<<<dim3(kCL * ncl * strips, h, b), kThreads, kScanSmem, st>>>(prm);
  } else if (p == 1) {
    wide_narrow<1><<<dim3(kCL * ncl, h, b), kNThreads, kNarrowSmem, st>>>(prm);
  } else if (p == 2) {
    wide_narrow<2><<<dim3(kCL * ncl, h, b), kNThreads, kNarrowSmem, st>>>(prm);
  } else {
    wide_narrow<4><<<dim3(kCL * ncl, h, b), kNThreads, kNarrowSmem, st>>>(prm);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || ncl == 1) return static_cast<int>(e);

  const long long total = (long long)b * s * h * p;
  const long long blocks = std::min<long long>((total + 255) / 256, 4096);
  wide_sum<<<static_cast<unsigned>(blocks), 256, 0, st>>>(ypart, static_cast<float*>(y), total,
                                                          ncl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_ssd_wide_error_string(int code) {
  if (code < 0) return "unsupported shape (g | h; n a multiple of 16; chunk a multiple of 16 "
                       "in [16, 128]; batch x chunks <= 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
