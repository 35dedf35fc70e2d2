// Backward of the grouped, wide-head chunked SSD scan (mamba_ssd_wide.cu)
// for Hopper, sm_90a: f32 in and out, every product on the tensor cores in
// 3xTF32, deterministic.
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
// adds dS (the states' size, 537 MB, written once by the sweep and read
// once by dbc) and the states read once more.
//
// Design, five launches (six past n = 1024):
// 1. prep, a block per (chunk, batch x group): the causal Gram (as the
//    forward's) and, a warp per head, the decay scalars (the prefix sum and
//    the centre in double, as the forward's), the tie weights of the centre
//    and exp(total).
// 2. qq, a block per (batch, chunk, head), a warp per 16-row strip: M = dy
//    x^T (K = p through shared memory, mma.sync), then dG (to the scratch
//    buffer, zero above the diagonal) and the row and column sums dai and
//    du, the columns summed over the strips in order; and, with dx wanted,
//    the in-chunk term A2^T dy written to dx: A2 (from the Gram and the
//    scalars alone) split once into shared memory, its product taken with
//    each p slab of dy that M reads (strip w's rows j meet K = i >= j, so
//    the strips' two products balance).
// 3. sweep, the forward's scan run backwards (mamba_ssd_wide.cu wide_scan
//    with dS for S, B dS for C.S_in, dy^T (ec C) for the update x^T (wj B)):
//    a cluster of ceil(n / 128) blocks (at most 8; past n = 1024 several
//    clusters) per (batch, head, 128-column strip of p), sized at launch
//    (cudaLaunchKernelEx), block r holding the 128 x 128 slice of dS^T for
//    state rows 128 r .. 128 r + 127 in registers, 64 p rows a warpgroup,
//    over the chunks in reverse.  Per chunk:
//    a. dS leaving the chunk is written once (for dbc) and its slice's share
//       of <dS, S> taken from the states, read once;
//    b. with dx wanted, (B dS)^T on wgmma with dS^T as the register A
//       operand: the block's partial over its n slice, in units of 32
//       tokens, into its shared memory; then each block sums the cluster's
//       partials of its Q / cluster rows through distributed shared memory
//       in rank order and adds z (B dS) to the in-chunk term qq wrote;
//    c. dS^T <- exp(total) dS^T + dy^T (ec C) on wgmma (both operands from
//       shared memory), in slabs of 32 tokens.
//    A step (a unit or a slab): its raw f32 tiles, copied by cp.async two
//    steps ahead, are split once into wgmma's K-major hi / lo operands,
//    then the products run with nothing else between a wgmma and its wait.
//    For p <= 4 (the normaliser) the narrow launch instead: f32 FMA, a
//    thread a state row, the partials of B dS reduced over the rows and the
//    cluster, as the forward's narrow launch.  Past n = 1024 each cluster's
//    z (B dS) goes to the scratch and
// 3b. sum adds them to dx in cluster order.
// 4. dbc, a block per (64 columns of n and dC or dB, group, batch x chunk),
//    two warpgroups of 64 token rows: for each head of the group in order,
//    E = dy S^T (dC) or F = x dS^T (dB) over K = p in steps of 32, then dG
//    B or dG^T C over K = Q, on wgmma (m64n64k8) from operands split once a
//    block from cp.async raw tiles two steps ahead (transposed as they are
//    split where the source is not K-major), each step's products summed
//    from zero and added in f32; the head's ec E or z F joins the group's
//    sum, and its dec or dz per row over the tile's columns.
// 5. chain, a warp per (batch, chunk, head): the scalars' chain to dscale
//    and dlog_decay (the reverse cumulative sum in the chunk), the partial
//    sums of launches 2, 3 and 4 summed in a fixed order.
// Every operand is split as hi = tf32(v), lo = tf32(v - hi) and each
// product issued as lo.hi + hi.lo + hi.hi, a k-group's three summed from
// zero and added to the f32 accumulator by FADD (the tensor core's own
// additions do not round to nearest).  Each output element has one owner
// and each sum a fixed order: no atomics, two calls bit-equal.  Its
// arithmetic on the CPU: kernels/ref.py mamba_ssd_wide_bwd_tf32.
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
using ssd::kClip;
using ssd::kdesc;
using ssd::kofs;
using ssd::ld_cluster1;
using ssd::ld_cluster4;
using ssd::load_a;
using ssd::load_b;
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
using ssd::wgmma_ss64;

constexpr int kSlabN = 32;         // K columns a slab of the prep and qq
constexpr int kKP = kSlabN + 4;    // their pitch (floats)
constexpr int kQmax = 128;
constexpr int kScal = 10;          // scalars a token
enum { kAI, kBJ, kU, kZ, kW, kEC, kDT, kMA, kMB, kTW };

struct Params {
  const float* x;       // (b, s, h, p)
  const float* a;       // (b, s, h)  log decay
  const float* dt;      // (b, s, h)  input scale
  const float* B;       // (b, s, g, n)
  const float* C;       // (b, s, g, n)
  const float* dy;      // (b, s, h, p)
  const float* states;  // (b, chunks, h, n, p): the state entering each chunk
  float* dx;            // (b, s, h, p), or null without dx
  float* da;            // (b, s, h)
  float* ddt;           // (b, s, h)
  float* dB;            // (b, s, g, n)
  float* dC;            // (b, s, g, n)
  float* dS;            // (b, chunks, h, n, p): dS leaving each chunk (the last's not written)
  float* gram;          // (b, chunks, g, Q, Q + 4): the causal Gram
  float* scal;          // (b, chunks, h, kScal, Q): the scalars
  float* et;            // (b, chunks, h): exp(total)
  float* dg;            // (b, chunks, h, Q, Q + 4): dG (0 above the diagonal)
  float* rowsum;        // (b, chunks, h, Q): dai
  float* colsum;        // (b, chunks, h, Q): du
  float* decp;          // (b, chunks, h, ntn, Q): dec per 64 columns of n
  float* dzp;           // (b, chunks, h, ntn, Q): dz per 64 columns of n
  float* detp;          // (b, chunks, h, ndet): <dS, S> per sweep block
  float* dxpart;        // (ncl, b, s, h, p): each cluster's z (B dS) where ncl > 1
  int b, s, h, g, p, n, Q, nch;
  int ntn, ndet;        // dbc's column tiles; the sweep's blocks a (batch, head)
  int csize, ncl;       // blocks of a sweep cluster; clusters over n
  int need_dx;
};

__device__ __forceinline__ int group_of(int hh, int h, int g) { return hh / (h / g); }

// (batch, chunk, head) -> its index in the per-head scratch arrays
__device__ __forceinline__ long long bch(const Params& p, int bb, int ch, int hh) {
  return ((long long)bb * p.nch + ch) * p.h + hh;
}

// 1 where clip60 passes its argument's gradient (torch.clamp's inclusive range)
__device__ __forceinline__ float in_clip(float v) { return (v >= -kClip && v <= kClip) ? 1.f : 0.f; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
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
    float* so = p.scal + bch(p, bb, ch, hh) * kScal * Q;
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

// ------------------------------------------------------------------- 2. qq
// Blocks of two roles per (chunk, head, batch row), a warp per 16-row strip
// of the chunk (with dx wanted both roles run side by side: small shapes
// fill twice the SMs):
// 0. M = dy x^T on the strip's 8-column tiles up to the diagonal (K = p in
//    slabs of kSlabN, dy and x double-buffered), then with G (the prep's,
//    from L2): dG = ai_i u_j M on j <= i (0 elsewhere, where ai_i u_j may
//    overflow and is never formed), dai_i (the strip's own rows) and the
//    strip's shares of du_j, summed over the strips in order;
// 1. dx's in-chunk term A2^T dy: A2 = ai_i u_j G on j <= i (the Gram and
//    the scalars alone) split once into shared memory as A2^T (hi, lo),
//    then each slab of dy adds its columns, written to dx (warp w: rows j
//    of its strip, K = i from the strip on).
__host__ __device__ inline int qq_smem_floats(int Q, int need_dx) {
  const int sums = 2 * 2 * Q * kKP + (2 + Q / 16) * Q;      // role 0
  const int intra = 2 * Q * kKP + 2 * Q + 2 * Q * (Q + 4);  // role 1
  return need_dx && intra > sums ? intra : sums;
}

__global__ void __launch_bounds__(256) mamba_ssd_wide_bwd_qq(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, GP = Q + 4;
  const int roles = p.need_dx ? 2 : 1, role = blockIdx.x % roles;
  const int ch = blockIdx.x / roles, hh = blockIdx.y, bb = blockIdx.z, t0 = ch * Q;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5, gq = lane >> 2, t = lane & 3;
  const bool vec = p.p % 4 == 0;
  // role 0: dy and x a stage; role 1: dy a stage
  const int stage = (role == 0 ? 2 : 1) * Q * kKP;
  float* ai = sm + 2 * stage;
  float* u = ai + Q;
  const long long me = bch(p, bb, ch, hh);
  const float* so = p.scal + me * kScal * Q;
  const float* G = p.gram + (((long long)bb * p.nch + ch) * p.g + group_of(hh, p.h, p.g)) * Q * GP;
  for (int i = tid; i < Q / 4; i += nthr) {
    cp_async16(ai + 4 * i, so + kAI * Q + 4 * i, true);
    cp_async16(u + 4 * i, so + kU * Q + 4 * i, true);
  }
  cp_async_commit();
  auto issue = [&](int sl, int st) {
    float* ds = sm + st * stage;
    float* xs = ds + Q * kKP;
    const int k0 = sl * kSlabN, w = min(kSlabN, p.p - k0);
    copy_tile(ds, kKP, Q, kSlabN / 8, w, vec, [&](int r) -> const float* {
      if (r < 0) return p.dy;
      const int tok = t0 + r;
      return tok < p.s ? p.dy + (((long long)bb * p.s + tok) * p.h + hh) * p.p + k0 : nullptr;
    }, tid, nthr);
    if (role == 0)
      copy_tile(xs, kKP, Q, kSlabN / 8, w, vec, [&](int r) -> const float* {
        if (r < 0) return p.x;
        const int tok = t0 + r;
        return tok < p.s ? p.x + (((long long)bb * p.s + tok) * p.h + hh) * p.p + k0 : nullptr;
      }, tid, nthr);
    cp_async_commit();
  };

  const int r0 = warp * 16, nct = 2 * warp + 2, nsl = (p.p + kSlabN - 1) / kSlabN;
  issue(0, 0);
  if (role == 1) {
    uint32_t* a2h = reinterpret_cast<uint32_t*>(u + Q);  // A2^T [j][i], pitch GP
    uint32_t* a2l = a2h + Q * GP;
    cp_async_wait_one();
    __syncthreads();  // ai and u have landed
#pragma unroll 8
    for (int idx = tid; idx < Q * Q; idx += nthr) {  // (8 loads of G in flight)
      const int i = idx / Q, j = idx % Q;
      const float v = j <= i ? ai[i] * u[j] * __ldg(G + i * GP + j) : 0.f;
      split(v, a2h[j * GP + i], a2l[j * GP + i]);
    }
    for (int sl = 0; sl < nsl; ++sl) {
      if (sl + 1 < nsl) {
        issue(sl + 1, (sl + 1) & 1);
        cp_async_wait_one();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      const float* ds = sm + (sl & 1) * stage;
      const int kw = min(kSlabN, p.p - sl * kSlabN);
      // (j, i) = A2[i][j], (i, k) = dy[i][k]
      float ia[4][4] = {};
      for (int k0 = r0; k0 < Q; k0 += 8) {
        const int ra = (r0 + gq) * GP + k0 + t;
        const uint32_t ah[4] = {a2h[ra], a2h[ra + 8 * GP], a2h[ra + 4], a2h[ra + 8 * GP + 4]};
        const uint32_t al[4] = {a2l[ra], a2l[ra + 8 * GP], a2l[ra + 4], a2l[ra + 8 * GP + 4]};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c * 8 < kw) {
            uint32_t bh[2], bl[2];
            load_b(ds, kKP, k0, c * 8, gq, t, bh, bl);
            mma3x(ia[c], ah, al, bh, bl);
          }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tok = t0 + r0 + gq + 8 * half;
        if (tok >= p.s) continue;
        float* row = p.dx + (((long long)bb * p.s + tok) * p.h + hh) * p.p + sl * kSlabN;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c * 8 + 2 * t + e;
            if (col < kw) row[col] = ia[c][2 * half + e];
          }
      }
      __syncthreads();
    }
    return;
  }
  float* colp = u + Q;  // [nwarps][Q]
  float acc[16][4] = {};
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

  float* dgo = p.dg + me * Q * GP;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int ct = 0; ct < 16; ++ct)
    if (ct < nct) {
      float cl[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + gq + 8 * half;
        const float aii = ai[i];
        float dgv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = ct * 8 + 2 * t + e;
          const float Gv = __ldg(G + i * GP + j), Mv = acc[ct][2 * half + e];
          dgv[e] = 0.f;
          if (j <= i) {
            const float uj = u[j];
            dgv[e] = aii * uj * Mv;
            rs[half] = fmaf(Gv * uj, Mv, rs[half]);
            cl[e] = fmaf(Gv * aii, Mv, cl[e]);
          }
        }
        *reinterpret_cast<float2*>(dgo + i * GP + ct * 8 + 2 * t) = make_float2(dgv[0], dgv[1]);
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
  for (int idx = lane; idx < 16 * (Q - nct * 8); idx += 32) {  // dG above the strip's diagonal
    const int w = Q - nct * 8;
    dgo[(r0 + idx / w) * GP + nct * 8 + idx % w] = 0.f;
  }
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

// ---------------------------------------------------------------- 3. sweep
constexpr int kThreads = 256;          // two warpgroups
constexpr int kPW = 128;               // p columns of a block's strip, 64 a warpgroup
constexpr int kSL = 128;               // state rows of a block's slice of n
constexpr int kCLmax = 8;              // most blocks of a cluster, one slice of n each
constexpr int kTU = 32;                // tokens of a B unit (the N of B dS)
constexpr int kTS = 32;                // tokens of a dy / C slab (one k-group)
constexpr int kPartPitch = kPW + 4;   // floats: the partials' token rows, conflict-free
constexpr int kStgPitch = kPW + 4;    // a staged group of dS: 32 n rows of the strip's p
constexpr int kStgFloats = 32 * kStgPitch;
// shared memory (floats): the operands of a step (B hi, lo; or dy hi, lo,
// ec C hi, lo; a unit leaves the second half free, where dS is staged);
// two slots of raw tiles, for the next two steps (B; or dy, C and ec); the
// partials (Q x p; where no dx is wanted, dS is staged there); the warps'
// <dS, S> of two chunks
constexpr int kStage = 4 * kTS * kPW;
constexpr int kBLo = kTU * kSL;       // B lo's offset in the operands
constexpr int kRawPitch = 128 + 4;    // a lane a row: conflict-free reads
constexpr int kRawB = 0, kRawY = 0;   // a step has B, or dy and C (32 rows each)
constexpr int kRawC = kRawY + kTS * kRawPitch;
constexpr int kRawE = kRawC + kTS * kRawPitch;
constexpr int kSlot = kRawE + kTS;    // one slot of raw tiles
constexpr int kSweepFloats = kStage + 2 * kSlot + kQmax * kPartPitch + 2 * (kThreads / 32);
static_assert(kStgFloats <= kStage / 2 && 4 * kStgFloats <= kQmax * kPartPitch,
              "a staged group fits the free half of the operands, four fit the partials");
constexpr int kSweepSmem = kSweepFloats * 4;

// rows of the chunk each block of a cluster of `cs` owns (even: float2 reads)
__host__ __device__ inline int owner_rows(int Q, int cs) { return ((Q + cs - 1) / cs + 1) & ~1; }

struct Sweep {
  int rank, cgrp, hh, bb, grp, n0, nv, c0, pw, i0, rows, nranks, tile;
  int U1, U2, spc;  // B units and dy / C slabs a chunk, steps a chunk
};

__device__ __forceinline__ Sweep sweep_block(const Params& p, int strip_width) {
  Sweep k;
  const int cs = p.csize;
  k.rank = blockIdx.x % cs;  // the cluster's rank (its blocks are consecutive in x)
  k.cgrp = (blockIdx.x / cs) % p.ncl;
  const int strip = blockIdx.x / (cs * p.ncl), slice = k.cgrp * cs + k.rank;
  k.hh = blockIdx.y;
  k.bb = blockIdx.z;
  k.grp = group_of(k.hh, p.h, p.g);
  k.n0 = slice * kSL;
  k.nv = max(0, min(kSL, p.n - k.n0));
  k.c0 = strip * strip_width;
  k.pw = min(strip_width, p.p - k.c0);
  const int qs = owner_rows(p.Q, cs);
  k.i0 = k.rank * qs;
  k.rows = max(0, min(qs, p.Q - k.i0));
  k.nranks = min(cs, (p.n - k.cgrp * cs * kSL + kSL - 1) / kSL);
  k.tile = strip * cs * p.ncl + slice;
  k.U2 = (p.Q + kTS - 1) / kTS;
  return k;
}

// the chunk a step of the reverse sweep belongs to
__device__ __forceinline__ int chunk_of(const Params& p, const Sweep& k, int step) {
  return p.nch - 1 - step / k.spc;
}

// <dS, S> of chunk ch for this block: the warps' shares in order
__device__ __forceinline__ void write_det(const Params& p, const Sweep& k, int ch,
                                          const float* red, int nwarps) {
  float sum = red[(ch & 1) * nwarps];
  for (int w = 1; w < nwarps; ++w) sum += red[(ch & 1) * nwarps + w];
  p.detp[bch(p, k.bb, ch, k.hh) * p.ndet + k.tile] = sum;
}

// ---- the raw tiles of step `step` into its slot by cp.async, two steps
// ahead, in fixed trip counts; only what is in range is copied (the split
// zeroes the rest)
__device__ __forceinline__ void issue_raw(const Params& p, const Sweep& k, int step, float* raw) {
  if (step >= p.nch * k.spc) return;
  const int tid = threadIdx.x, Q = p.Q, ch = chunk_of(p, k, step), j = step % k.spc;
  float* slot = raw + (step & 1) * kSlot;
  const bool unit = j < k.U1;
  if (unit ? ch == p.nch - 1 : ch == 0) return;  // steps the sweep skips
  const int tin0 = (unit ? j : j - k.U1) * kTS;
  const int rows = min(kTS, min(Q - tin0, p.s - ch * Q - tin0));  // tokens in range
  const long long tok0 = (long long)k.bb * p.s + ch * Q + tin0;
  const float* bc = (unit ? p.B : p.C) + (tok0 * p.g + k.grp) * p.n + k.n0;
#pragma unroll
  for (int q = 0; q < kTS * 32 / kThreads; ++q) {  // B, or C: 16-byte pieces
    const int item = tid + kThreads * q, r = item >> 5, c4 = item & 31;
    if (r < rows && 4 * c4 < k.nv)
      cp_async16(slot + (unit ? kRawB : kRawC) + r * kRawPitch + 4 * c4,
                 bc + (long long)r * p.g * p.n + 4 * c4, true);
  }
  if (unit) return;
  const float* ys = p.dy + (tok0 * p.h + k.hh) * p.p + k.c0;
  const long long yrow = (long long)p.h * p.p;
  if (p.p % 4 == 0) {  // dy: 16-byte pieces
#pragma unroll
    for (int q = 0; q < kTS * 32 / kThreads; ++q) {
      const int item = tid + kThreads * q, r = item >> 5, c4 = item & 31;
      if (r < rows && 4 * c4 < k.pw)
        cp_async16(slot + kRawY + r * kRawPitch + 4 * c4, ys + r * yrow + 4 * c4, true);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kTS * kPW / kThreads; ++q) {
      const int item = tid + kThreads * q, r = item >> 7, e = item & 127;
      if (r < rows && e < k.pw) cp_async4(slot + kRawY + r * kRawPitch + e, ys + r * yrow + e, true);
    }
  }
  const float* ec = p.scal + bch(p, k.bb, ch, k.hh) * kScal * Q + kEC * Q;
  if (tid < kTS / 4 && 4 * tid < Q - tin0)
    cp_async16(slot + kRawE + 4 * tid, ec + tin0 + 4 * tid, true);
}

// ---- the split: raw tiles into the hi / lo operand tiles, wgmma's K-major
// layout (every operand split once); each thread loads all it splits first
// a B unit: the B operand of B dS, 16 k-steps of 32 token rows, hi at ops,
// lo at ops + kBLo; the 8 columns of a k-step permuted (slot t: column 2t,
// slot t + 4: 2t + 1), the order in which dS^T's accumulator reads as A
__device__ __forceinline__ void split_b(const Params& p, const Sweep& k, int ch, int u,
                                        const float* __restrict__ slot, float* __restrict__ ops) {
  constexpr int kItems = kTU * (kSL / 8) / kThreads;
  float4 v[kItems][2];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kTU, ks = item / kTU;
    const float4* src = reinterpret_cast<const float4*>(slot + kRawB + r * kRawPitch + 8 * ks);
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
    put4(hi, hi + kBLo, v[q][0].x, v[q][0].z, v[q][1].x, v[q][1].z);
    put4(hi + 32, hi + kBLo + 32, v[q][0].y, v[q][0].w, v[q][1].y, v[q][1].w);
  }
}

// a slab: dy^T (the strip's 128 p rows) and (ec C)^T (the slice's 128 n
// rows), K = tokens, 4 k-steps of 128 rows each: dy hi, dy lo, eC hi, eC
// lo at ops + 0, 1, 2, 3 quarters of a stage.  dy rows past the strip and
// eC rows past the slice are zero: the dS rows and columns they feed stay
// zero (no stale shared memory reaches a product)
__device__ __forceinline__ void split_yc(const Params& p, const Sweep& k, int ch, int sl,
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
      v[e] = in && r < k.pw ? slot[kRawY + tt * kRawPitch + r] : 0.f;
      w[e] = in && r < k.nv ? slot[kRawC + tt * kRawPitch + r] * slot[kRawE + tt] : 0.f;
    }
    float* hi = ops + kofs(r, kc, kPW);
    put4(hi, hi + kStage / 4, v[0], v[1], v[2], v[3]);
    put4(hi + kStage / 2, hi + 3 * kStage / 4, w[0], w[1], w[2], w[3]);
  }
}

// A cluster of p.csize blocks per (strip of 128 p columns, cluster group of
// n, head, batch row); block rank r holds dS^T for state rows n0 = 128
// (csize cgrp + r) .. n0 + 127 of the strip in registers (warpgroup w: p
// rows 64 w .. 64 w + 63, its accumulator layout) over the whole sweep, the
// chunks in reverse.  The steps of a chunk: its B units (B dS into the
// partials; none without dx), then its dy / eC slabs (the update).  A step:
// its raw tiles (copied two steps ahead) are split into the operands, the
// copies of the step after the next are issued, then the products run with
// nothing else between a wgmma and its wait (ptxas serialises them
// otherwise).
__global__ void __launch_bounds__(kThreads, 1) mamba_ssd_wide_bwd_sweep(Params p) {
  extern __shared__ __align__(128) float ssm[];
  float* const ops = ssm;
  float* const raw = ops + kStage;
  float* const part = raw + 2 * kSlot;
  float* const red = part + kQmax * kPartPitch;
  const int Q = p.Q;
  Sweep k = sweep_block(p, kPW);
  k.U1 = p.need_dx ? (Q + kTU - 1) / kTU : 0;
  k.spc = k.U1 + k.U2;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3, row0 = wg * 64 + warp * 16 + gq;  // + 8 for e >= 2
  const bool mine = wg * 64 < k.pw;    // the warpgroup has a p row in the strip
  const bool prod = mine && k.nv > 0;  // ... and a state row
  const int nsteps = p.nch * k.spc;
  // the steps that move dS out, a group of 32 of the slice's state rows at a
  // time: the units, or without units the first slab; dS is staged in the
  // operands' free half (a unit's) or, without units, in the partials
  const int nio = k.U1 > 0 ? k.U1 : 1;
  float* const stg = k.U1 > 0 ? ops + kStage / 2 : part;
  const bool vec = p.p % 4 == 0;

  float S[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) S[e] = 0.f;
  float dot = 0.f;

  // dS^T's state rows 32 cg .. 32 cg + 31 of the slice into `buf`, a row a
  // state row (stg layout: the strip's p contiguous)
  auto ds_stage = [&](int cg, float* buf) {
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c >> 2 == cg)
          buf[(8 * (c & 3) + 2 * t + (e & 1)) * kStgPitch + row0 + 8 * (e >> 1)] = S[4 * c + e];
  };
  // a staged group written to dS leaving chunk ch (for dbc) and the states
  // there loaded, 16 bytes a thread and item
  auto ds_move = [&](int ch, int cg, const float* buf, float4 (&dsv)[4], float4 (&stv)[4]) {
    const long long base = (bch(p, k.bb, ch, k.hh) * p.n + k.n0 + 32 * cg) * p.p + k.c0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int item = tid + kThreads * q, lr = item >> 5, p0 = 4 * (item & 31);
      const bool row_ok = 32 * cg + lr < k.nv;
      const long long o = base + (long long)lr * p.p + p0;
      float4 d = *reinterpret_cast<const float4*>(buf + lr * kStgPitch + p0);
      if (row_ok && vec && p0 + 3 < k.pw) {
        stv[q] = __ldg(reinterpret_cast<const float4*>(p.states + o));
        *reinterpret_cast<float4*>(p.dS + o) = d;
      } else {
        float* dv = &d.x;
        float* sv = &stv[q].x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = row_ok && p0 + i < k.pw;
          sv[i] = ok ? __ldg(p.states + o + i) : 0.f;
          if (ok) p.dS[o + i] = dv[i];
          dv[i] = ok ? dv[i] : 0.f;
        }
      }
      dsv[q] = d;
    }
  };
  auto ds_dot = [&](const float4 (&dsv)[4], const float4 (&stv)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dot = fmaf(dsv[q].x, stv[q].x, dot);
      dot = fmaf(dsv[q].y, stv[q].y, dot);
      dot = fmaf(dsv[q].z, stv[q].z, dot);
      dot = fmaf(dsv[q].w, stv[q].w, dot);
    }
  };

  issue_raw(p, k, 0, raw);
  cp_async_commit();
  issue_raw(p, k, 1, raw);
  cp_async_commit();
  cluster_arrive();  // nobody reads the partials yet
  int pending = -1;  // the chunk whose <dS, S> the warps left in red

  for (int step = 0; step < nsteps; ++step) {
    const int ch = chunk_of(p, k, step), j = step % k.spc;
    // dS leaving the last chunk is zero (B dS vanishes, nothing to move);
    // dS leaving the state that enters the first is not needed
    const bool live = ch < p.nch - 1, update = ch > 0;
    cp_async_wait_one();
    __syncthreads();  // this step's raw tiles have landed; the last step's products are done
    if (pending >= 0) {
      if (tid == 0) write_det(p, k, pending, red, kThreads / 32);
      pending = -1;
    }
    const float* slot = raw + (step & 1) * kSlot;
    if (j < k.U1) {
      if (k.nv > 0 && live) split_b(p, k, ch, j, slot, ops);
    } else if (update) {
      split_yc(p, k, ch, j - k.U1, slot, ops);
    }
    // dS leaving chunk ch (for dbc) and the slice's share of <dS, S>: this
    // step's groups; a unit's last one is staged now and moved after the
    // barrier, its loads in flight over the unit's products; the others
    // (short chunks, or no units) are moved here
    const int g0 = j * 4 / nio, g1 = (j + 1) * 4 / nio;
    const bool io = j < nio && live, overlap = io && k.U1 > 0;
    float4 dsv[4], stv[4];  // a group's staged dS and the states there
    if (j == 0) dot = 0.f;
    if (io) {
      for (int cg = g0; cg < g1 - (overlap ? 1 : 0); ++cg) {
        ds_stage(cg, stg);
        __syncthreads();
        ds_move(ch, cg, stg, dsv, stv);
        ds_dot(dsv, stv);
        __syncthreads();
      }
      if (overlap) ds_stage(g1 - 1, stg);
    }
    fence_async_smem();  // the operands, written by every thread, are seen by wgmma
    __syncthreads();     // ... and the slot is free
    issue_raw(p, k, step + 2, raw);
    cp_async_commit();
    if (overlap) ds_move(ch, g1 - 1, stg, dsv, stv);
    if (j < k.U1) {
      // ---- (B dS)^T for tokens 32 j .. 32 j + 31: the block's partial, in
      // k-groups of 16 state rows (2 k-steps), each summed from zero and
      // added by FADD
      float acc[16];
      if (prod && live) {
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
            const uint64_t dh = kdesc(bh), dl = kdesc(bh + kBLo);
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
      if (overlap) ds_dot(dsv, stv);
      if (j == 0) cluster_wait();  // every block is done reading the last chunk's partials
      if (prod && live) {  // the partial's tokens a row (p contiguous)
#pragma unroll
        for (int c = 0; c < kTU / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * kTU + 8 * c + 2 * t + (e & 1);
            if (col < Q) part[col * kPartPitch + row0 + 8 * (e >> 1)] = acc[4 * c + e];
          }
      }
      if (j == k.U1 - 1) cluster_arrive();  // this chunk's partials are written
    } else {
      // ---- dS^T <- exp(total) dS^T + dy^T (ec C), tokens 32 sl ..
      const int sl = j - k.U1;
      const bool upd = prod && update;
      if (sl == 0 && upd) {
        const float et = __ldg(p.et + bch(p, k.bb, ch, k.hh));
#pragma unroll
        for (int e = 0; e < 64; ++e) S[e] *= et;
      }
      // in two halves of the slice's 128 state columns: 32 accumulators a
      // window beside the 64 of dS
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float tmp[32];
        wg_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* yh = ops + q * kPW * 8 + wg * 8 * 64;
          const float* yl = yh + kStage / 4;
          const float* eh = ops + kStage / 2 + q * kSL * 8 + hf * 8 * 64;
          const float* el = eh + kStage / 4;
          if (upd) {
            wgmma_ss64(tmp, kdesc(yl), kdesc(eh), q > 0);
            wgmma_ss64(tmp, kdesc(yh), kdesc(el), 1);
            wgmma_ss64(tmp, kdesc(yh), kdesc(eh), 1);
          }
        }
        wg_commit();
        wg_wait0();
        pin(tmp);
        if (upd) {
#pragma unroll
          for (int e = 0; e < 32; ++e) S[32 * hf + e] += tmp[e];
        }
      }
      if (sl == k.U2 - 1 && k.U1 > 0) {
        // ---- dx for the block's rows: the partials summed in rank order,
        // times z, added to the in-chunk term (or, past one cluster, the
        // cluster's share into the scratch); nothing to add at the last
        // chunk.  Items of 4 p columns of a token: the in-chunk term and z
        // of the first items read before the wait, an item batch's remote
        // loads in flight together
        const long long xrow = (long long)p.h * p.p;
        const float* z = p.scal + bch(p, k.bb, ch, k.hh) * kScal * Q + kZ * Q + k.i0;
        float* out = p.ncl > 1 ? p.dxpart + (long long)k.cgrp * p.b * p.s * xrow : p.dx;
        float* row_base = out + ((long long)k.bb * p.s + ch * Q + k.i0) * xrow + k.hh * p.p + k.c0;
        const int pw4 = (k.pw + 3) / 4;
        const int rows = min(k.rows, p.s - (ch * Q + k.i0));  // the share's tokens in range
        // (past one cluster the scratch takes the last chunk's zeros too)
        const int items = live || p.ncl > 1 ? pw4 * max(rows, 0) : 0;
        constexpr int kBatch = 1;  // (2 spills)
        float4 own[kBatch];
        float zz[kBatch];
        auto load_own = [&](int it0) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int it = it0 + u * kThreads + tid, ii = it / pw4, p0 = 4 * (it % pw4);
            own[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            zz[u] = 0.f;
            if (it >= items) continue;
            zz[u] = __ldg(z + ii);
            if (p.ncl > 1) continue;
            const float* o = row_base + ii * xrow + p0;
            float* ov = &own[u].x;
#pragma unroll
            for (int i = 0; i < 4; ++i) ov[i] = p0 + i < k.pw ? o[i] : 0.f;
          }
        };
        load_own(0);
        cluster_wait();  // every block's partials of this chunk are written
        for (int it0 = 0; it0 < items; it0 += kBatch * kThreads) {
          if (it0 > 0) load_own(it0);
          float4 v[kBatch][kCLmax];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int it = it0 + u * kThreads + tid, ii = it / pw4, p0 = 4 * (it % pw4);
            const uint32_t la = smem_u32(part + (k.i0 + ii) * kPartPitch + p0);
#pragma unroll
            for (int r = 0; r < kCLmax; ++r)
              v[u][r] = live && it < items && r < k.nranks ? ld_cluster4(la, r)
                                                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int it = it0 + u * kThreads + tid, ii = it / pw4, p0 = 4 * (it % pw4);
            if (it >= items) continue;
            float4 sum = v[u][0];  // the ranks' partials in rank order
#pragma unroll
            for (int r = 1; r < kCLmax; ++r)
              if (r < k.nranks) {
                sum.x += v[u][r].x;
                sum.y += v[u][r].y;
                sum.z += v[u][r].z;
                sum.w += v[u][r].w;
              }
            float* o = row_base + ii * xrow + p0;
            const float* sv = &sum.x;
            const float* ov = &own[u].x;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (p0 + i < k.pw) o[i] = fmaf(zz[u], sv[i], ov[i]);
          }
        }
        cluster_arrive();  // done reading the partials
      }
    }
    if (j == nio - 1) {  // the slice's <dS, S>: its warps' shares, summed at the next step
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) red[(ch & 1) * (kThreads / 32) + (tid >> 5)] = dot;
      pending = ch;
    }
  }
  __syncthreads();
  if (pending >= 0 && tid == 0) write_det(p, k, pending, red, kThreads / 32);
  cluster_wait();  // no block leaves while another may read its partials
}

// --------------------------------------------------------------- 3. narrow
// p up to kNarrowP (the mLSTM's normaliser, p = 1) in f32 FMA: its products
// are matrix-vector ones, too thin for a 64-row wgmma, and its time is the
// stream of B and C.  A cluster of p.csize blocks per (cluster group of n,
// head, batch row), block rank r holding state rows n0 = 128 (csize cgrp +
// r) .. n0 + 127, a thread a row, over the chunks in reverse.  Per token the
// block's partial of B dS is summed over its rows (a warp's lanes by a
// reduce-scatter of shuffles, then the 4 warps in order), then over the
// cluster in rank order as in the sweep; the update dS <- exp(total) dS +
// sum_j (ec_j dy_j) C_j in token order.  C, B and dy stream through a ring
// of kNSlots steps of 32 tokens by cp.async.
constexpr int kNarrowP = 4;
constexpr int kNThreads = 128;
constexpr int kNSlots = 5;
constexpr int kNB = kTS * kSL, kNY = 2 * kTS * kSL;  // C at 0, B, dy (32 x 4), then
constexpr int kNE = kNY + kTS * kNarrowP;            // ec (32)
constexpr int kNSlot = kNE + kTS;
constexpr int kNWarpPart = kNSlots * kNSlot;           // the warps' sums (4 x 32 x p)
constexpr int kNPart = kNWarpPart + 4 * kTS * kNarrowP;  // the block's partials (Q x p)
constexpr int kNRed = kNPart + kQmax * kNarrowP;       // the warps' <dS, S> of two chunks
constexpr int kNarrowSmem = (kNRed + 2 * (kNThreads / 32)) * 4;

__device__ __forceinline__ void narrow_issue(const Params& p, const Sweep& k, int step,
                                             float* raw) {
  if (step >= p.nch * k.spc) return;
  const int tid = threadIdx.x, Q = p.Q, ch = chunk_of(p, k, step), tin0 = (step % k.spc) * kTS;
  float* slot = raw + (step % kNSlots) * kNSlot;
  const int rows = min(kTS, min(Q - tin0, p.s - ch * Q - tin0));
  const long long tok0 = (long long)k.bb * p.s + ch * Q + tin0;
  const float* csrc = p.C + (tok0 * p.g + k.grp) * p.n + k.n0;
  const float* bsrc = p.B + (tok0 * p.g + k.grp) * p.n + k.n0;
  const bool live = p.need_dx && ch < p.nch - 1, update = ch > 0;  // as the sweep skips
  if (!update && !live) return;
#pragma unroll 4
  for (int q = 0; q < kTS * 32 / kNThreads; ++q) {
    const int item = tid + kNThreads * q, r = item >> 5, c4 = item & 31;
    if (r < rows && 4 * c4 < k.nv) {
      const long long off = (long long)r * p.g * p.n + 4 * c4;
      if (update) cp_async16(slot + r * kSL + 4 * c4, csrc + off, true);
      if (live) cp_async16(slot + kNB + r * kSL + 4 * c4, bsrc + off, true);
    }
  }
  if (!update) return;
  const float* ys = p.dy + (tok0 * p.h + k.hh) * p.p;
  if (tid < rows * p.p) {
    const int r = tid / p.p, e = tid % p.p;
    cp_async4(slot + kNY + r * kNarrowP + e, ys + (long long)r * p.h * p.p + e, true);
  }
  const float* ec = p.scal + bch(p, k.bb, ch, k.hh) * kScal * Q + kEC * Q;
  if (4 * tid < min(kTS, Q - tin0)) cp_async16(slot + kNE + 4 * tid, ec + tin0 + 4 * tid, true);
}

// NP: the p this instantiation holds a row (1, 2 or 4; p <= NP)
template <int NP>
__global__ void __launch_bounds__(kNThreads, 1) mamba_ssd_wide_bwd_narrow(Params p) {
  extern __shared__ __align__(128) float nsm[];
  float* const raw = nsm;
  float* const wpart = nsm + kNWarpPart;
  float* const part = nsm + kNPart;
  float* const red = nsm + kNRed;
  const int Q = p.Q;
  Sweep k = sweep_block(p, kNarrowP);
  k.U1 = 0;
  k.spc = k.U2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, P = p.p;
  const bool row_ok = tid < k.nv;
  const int nsteps = p.nch * k.spc;

  float dS[NP], U[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) dS[c] = U[c] = 0.f;
#pragma unroll
  for (int st = 0; st < kNSlots - 1; ++st) {
    narrow_issue(p, k, st, raw);
    cp_async_commit();
  }
  cluster_arrive();  // nobody reads the partials yet
  int pending = -1;

  for (int step = 0; step < nsteps; ++step) {
    const int ch = chunk_of(p, k, step), sl = step % k.spc, tin0 = sl * kTS;
    // dS leaving the last chunk is zero (B dS vanishes); dS leaving the
    // state that enters the first is not needed
    const bool live = p.need_dx && ch < p.nch - 1, update = ch > 0;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kNSlots - 2) : "memory");
    __syncthreads();  // this step's tiles have landed
    if (pending >= 0) {
      if (tid == 0) write_det(p, k, pending, red, kNThreads / 32);
      pending = -1;
    }
    const float* slot = raw + (step % kNSlots) * kNSlot;
    const int valid = min(kTS, min(Q - tin0, p.s - ch * Q - tin0));
    if (sl == 0) {  // dS leaving chunk ch (for dbc), and the slice's share of <dS, S>
      float dot = 0.f;
      if (ch < p.nch - 1 && row_ok) {
        const long long o = (bch(p, k.bb, ch, k.hh) * p.n + k.n0 + tid) * P;
        for (int c = 0; c < P; ++c) {
          p.dS[o + c] = dS[c];
          dot = fmaf(dS[c], __ldg(p.states + o + c), dot);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) red[(ch & 1) * (kNThreads / 32) + warp] = dot;
      pending = ch;
#pragma unroll
      for (int c = 0; c < NP; ++c) U[c] = 0.f;
    }
    // each token's update of this row, and its share of B dS, then that
    // share's sum over the warp's rows by a reduce-scatter (lane l ends
    // with token l's sum)
    float v[NP][kTS];
#pragma unroll
    for (int i = 0; i < kTS; ++i) {
      const bool in = i < valid && row_ok;  // (nothing out of range is read)
      const float cc = in && update ? slot[i * kSL + tid] : 0.f;
      const float e = in && update ? slot[kNE + i] : 0.f;
      const float b = in && live ? slot[kNB + i * kSL + tid] : 0.f;
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        const float yv = in && update && c < P ? slot[kNY + i * kNarrowP + c] : 0.f;
        U[c] = fmaf(e * yv, cc, U[c]);
        v[c][i] = b * dS[c];
      }
    }
    if (live) {
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
    }
    if (sl == k.spc - 1) {
      // dS <- exp(total) dS + the chunk's own term; then dx for the block's rows
      const float et = __ldg(p.et + bch(p, k.bb, ch, k.hh));
#pragma unroll
      for (int c = 0; c < NP; ++c) dS[c] = et * dS[c] + U[c];
      if (live) {  // (at the last chunk dx is the in-chunk term alone)
        cluster_arrive();  // this chunk's partials are written
        cluster_wait();
        const float* z = p.scal + bch(p, k.bb, ch, k.hh) * kScal * Q + kZ * Q + k.i0;
        float* out = p.ncl > 1 ? p.dxpart + (long long)k.cgrp * p.b * p.s * p.h * P : p.dx;
        for (int idx = tid; idx < k.rows * P; idx += kNThreads) {
          const int i = idx / P, c = idx % P, tok = ch * Q + k.i0 + i;
          const uint32_t la = smem_u32(part + (k.i0 + i) * kNarrowP + c);
          float vr[kCLmax];
#pragma unroll
          for (int r = 0; r < kCLmax; ++r) vr[r] = r < k.nranks ? ld_cluster1(la, r) : 0.f;
          float sum = vr[0];
#pragma unroll
          for (int r = 1; r < kCLmax; ++r)
            if (r < k.nranks) sum += vr[r];
          if (tok < p.s) {
            const long long o = (((long long)k.bb * p.s + tok) * p.h + k.hh) * P + c;
            const float val = __ldg(z + i) * sum;
            if (p.ncl > 1) {
              out[o] = val;
            } else {
              out[o] += val;
            }
          }
        }
        cluster_arrive();  // done reading the partials
      } else if (p.need_dx && p.ncl > 1) {  // the scratch takes the last chunk's zeros
        float* out = p.dxpart + (long long)k.cgrp * p.b * p.s * p.h * P;
        for (int idx = tid; idx < k.rows * P; idx += kNThreads) {
          const int i = idx / P, c = idx % P, tok = ch * Q + k.i0 + i;
          if (tok < p.s) out[(((long long)k.bb * p.s + tok) * p.h + k.hh) * P + c] = 0.f;
        }
      }
    }
    __syncthreads();  // the slot and the warps' sums are free
    narrow_issue(p, k, step + kNSlots - 1, raw);
    cp_async_commit();
  }
  __syncthreads();
  if (pending >= 0 && tid == 0) write_det(p, k, pending, red, kNThreads / 32);
  cluster_wait();  // no block leaves while another may read its partials
}

// ------------------------------------------------------------------ 3b. sum
// dx += the clusters' z (B dS) in cluster order (n > 1024 only)
__global__ void __launch_bounds__(256) mamba_ssd_wide_bwd_sum(const float* part, float* dx,
                                                              long long total, int ncl) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += 256LL * gridDim.x) {
    float v = dx[i];
    for (int c = 0; c < ncl; ++c) v += part[c * total + i];
    dx[i] = v;
  }
}

// ------------------------------------------------------------------ 4. dbc
// Tiles of NT columns of n: 128 where a group has one head (h = g, the
// xLSTM's), 64 otherwise (a sum over the group's heads needs a third
// accumulator)
constexpr int kDK = 32;                  // K of a step
constexpr int kDRows = 128;              // token rows (two warpgroups of 64)
constexpr int kDAP = kDK + 4;            // pitch of a raw tile whose rows are K-major
constexpr int kDAT = kQmax + 4;          // pitch of a raw dG tile read transposed
constexpr int kDRawA = kDRows * kDAP;    // >= kDK * kDAT
constexpr int kDOpsA = kDRows * kDK;     // A hi (lo after it)
static_assert(kDK * kDAT <= kDRawA, "a transposed raw dG tile fits");
template <int NT>
struct DbcTile {
  static constexpr int kBT = NT + 4;          // pitch of a raw B / C tile read transposed
  static constexpr int kRawB = NT * kDAP;     // >= kDK * kBT
  static constexpr int kSlot = kDRawA + kRawB;
  static constexpr int kOpsB = NT * kDK;      // B hi (lo after it)
  // the operands, two slots of raw tiles, the tile's C (dC) or B (dB) for dec (dz)
  static constexpr int kSmem = (2 * kDOpsA + 2 * kOpsB + 2 * kSlot + kDRows * kBT) * 4;
  static_assert(kDK * kBT <= kRawB, "a transposed raw B / C tile fits");
};

struct Dbc {
  int kind, tn, grp, bb, ch, t0, n0, nw, rep, nE, nG, per, nsteps;
};

// ---- the raw tiles of step `step` (head step / per; E or F over p, then
// dG over Q) into its slot by cp.async, two steps ahead
template <int NT>
__device__ __forceinline__ void dbc_issue(const Params& p, const Dbc& k, int step, float* raw) {
  using T = DbcTile<NT>;
  if (step >= k.nsteps) return;
  const int tid = threadIdx.x, Q = p.Q, GP = Q + 4, e = step % k.per;
  const int hh = k.grp * k.rep + step / k.per;
  const long long me = bch(p, k.bb, k.ch, hh);
  float* ra = raw + (step & 1) * T::kSlot;
  float* rb = ra + kDRawA;
  if (e < k.nE) {  // dy (x) rows of tokens, the states' (dS's) rows of n; K = p
    const int k0 = e * kDK, w = min(kDK, p.p - k0);
    const bool vec = p.p % 4 == 0;
    const float* ain = k.kind ? p.x : p.dy;
    const float* srows = (k.kind ? p.dS : p.states) + (me * p.n + k.n0) * p.p + k0;
    copy_tile(ra, kDAP, kDRows, kDK / 8, w, vec, [&](int r) -> const float* {
      if (r < 0) return ain;
      const int tok = k.t0 + r;
      return r < Q && tok < p.s ? ain + (((long long)k.bb * p.s + tok) * p.h + hh) * p.p + k0
                                : nullptr;
    }, tid, kThreads);
    copy_tile(rb, kDAP, NT, kDK / 8, w, vec, [&](int r) -> const float* {
      if (r < 0) return p.states;
      return r < k.nw ? srows + (long long)r * p.p : nullptr;
    }, tid, kThreads);
  } else {  // dG (rows i, columns j0.. for dC; rows i0.., every column for dB), B or C rows
    const int j0 = (e - k.nE) * kDK;
    const float* dg = p.dg + me * Q * GP;
    if (k.kind == 0) {
      copy_tile(ra, kDAP, kDRows, kDK / 8, min(kDK, Q - j0), true, [&](int r) -> const float* {
        if (r < 0) return dg;
        return r < Q ? dg + r * GP + j0 : nullptr;
      }, tid, kThreads);
    } else {
      copy_tile(ra, kDAT, kDK, kQmax / 8, Q, true, [&](int r) -> const float* {
        if (r < 0) return dg;
        return j0 + r < Q ? dg + (j0 + r) * GP : nullptr;
      }, tid, kThreads);
    }
    const float* m = k.kind ? p.C : p.B;
    copy_tile(rb, T::kBT, kDK, NT / 8, k.nw, true, [&](int r) -> const float* {
      if (r < 0) return m;
      const int tok = k.t0 + j0 + r;
      return j0 + r < Q && tok < p.s
                 ? m + (((long long)k.bb * p.s + tok) * p.g + k.grp) * p.n + k.n0
                 : nullptr;
    }, tid, kThreads);
  }
}

// ---- the split of a step's raw tiles into the K-major hi / lo operands: A
// (128 token rows x 32), B (NT n rows x 32); rows read straight (K-major
// sources: dy, x, dG for dC, the states, dS) or transposed (dG for dB, B,
// C); each thread loads all of A it splits first, then all of B
template <int NT>
__device__ __forceinline__ void dbc_split(bool a_t, bool b_t, const float* __restrict__ ra,
                                          float* __restrict__ ops) {
  using T = DbcTile<NT>;
  const float* rb = ra + kDRawA;
  float* const oa = ops;
  float* const ob = ops + 2 * kDOpsA;
  constexpr int kA = kDRows * kDK / 4 / kThreads, kB = NT * kDK / 4 / kThreads;
  float4 va[kA], vb[kB];
#pragma unroll
  for (int q = 0; q < kA; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kDRows, kc = item / kDRows;
    if (a_t) {
      const float* s = ra + 4 * kc * kDAT + r;
      va[q] = make_float4(s[0], s[kDAT], s[2 * kDAT], s[3 * kDAT]);
    } else {
      va[q] = *reinterpret_cast<const float4*>(ra + r * kDAP + 4 * kc);
    }
  }
#pragma unroll
  for (int q = 0; q < kA; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % kDRows, kc = item / kDRows;
    float* hi = oa + kofs(r, kc, kDRows);
    put4(hi, hi + kDOpsA, va[q].x, va[q].y, va[q].z, va[q].w);
  }
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % NT, kc = item / NT;
    if (b_t) {
      const float* s = rb + 4 * kc * T::kBT + r;
      vb[q] = make_float4(s[0], s[T::kBT], s[2 * T::kBT], s[3 * T::kBT]);
    } else {
      vb[q] = *reinterpret_cast<const float4*>(rb + r * kDAP + 4 * kc);
    }
  }
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    const int item = threadIdx.x + kThreads * q, r = item % NT, kc = item / NT;
    float* hi = ob + kofs(r, kc, NT);
    put4(hi, hi + T::kOpsB, vb[q].x, vb[q].y, vb[q].z, vb[q].w);
  }
}

// d (+)= A B, 64 x NT x 8 TF32, both K-major in shared memory
template <int NT>
__device__ __forceinline__ void wgmma_ss(float (&d)[NT / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (NT == 128) {
    wgmma_ss128(d, da, db, acc);
  } else {
    wgmma_ss64(d, da, db, acc);
  }
}

// A block per (NT columns of n and dC or dB, group, batch x chunk), two
// warpgroups of 64 token rows (rows i of dC, j of dB): for each head of the
// group in order, E = dy S^T (dC) or F = x dS^T (dB) over K = p (skipped
// where the state entering the first chunk, or dS leaving the last, is
// zero); then the head's ec_i E (z_j F) joins the group's sum, with its
// dec_i = sum C E (dz_j = sum B F) over the tile's columns; then dG B
// (dG^T C) over K = Q, a warpgroup taking only the steps its causal rows
// meet.  Each step's products are summed from zero and added in f32.  With
// one head a group (NT = 128) the sum is E itself, scaled in place.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1) mamba_ssd_wide_bwd_dbc(Params p) {
  using T = DbcTile<NT>;
  constexpr bool kOne = NT == 128;  // one head a group
  constexpr int kAcc = NT / 2;      // accumulator registers of a 64 x NT tile
  extern __shared__ __align__(128) float dsm[];
  float* const ops = dsm;
  float* const raw = dsm + 2 * kDOpsA + 2 * T::kOpsB;
  float* const mat = raw + 2 * T::kSlot;  // C (dC) or B (dB) rows of the tile, for dec (dz)
  const int Q = p.Q;
  Dbc k;
  k.kind = blockIdx.x & 1;
  k.tn = blockIdx.x >> 1;
  k.grp = blockIdx.y;
  k.bb = blockIdx.z / p.nch;
  k.ch = blockIdx.z % p.nch;
  k.t0 = k.ch * Q;
  k.n0 = k.tn * NT;
  k.nw = min(NT, p.n - k.n0);
  const int rep = p.h / p.g;
  k.rep = rep;
  k.nE = (k.kind ? k.ch == p.nch - 1 : k.ch == 0) ? 0 : (p.p + kDK - 1) / kDK;
  k.nG = (Q + kDK - 1) / kDK;
  k.per = k.nE + k.nG;
  k.nsteps = rep * k.per;
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + gq;  // + 8 for the second half
  const bool rows = wg * 64 < Q;

  // sum: the group's sum; E: the head's E (F); with one head a group E is
  // kept in sum until the fold scales it there
  float sum[kAcc], E[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) sum[e] = E[e] = 0.f;
  const float* msrc = k.kind ? p.B : p.C;
  copy_tile(mat, T::kBT, kDRows, NT / 8, k.nw, true, [&](int r) -> const float* {
    if (r < 0) return msrc;
    const int tok = k.t0 + r;
    return r < Q && tok < p.s
               ? msrc + (((long long)k.bb * p.s + tok) * p.g + k.grp) * p.n + k.n0
               : nullptr;
  }, tid, kThreads);
  dbc_issue<NT>(p, k, 0, raw);  // (in the first group, with the tile above)
  cp_async_commit();
  dbc_issue<NT>(p, k, 1, raw);
  cp_async_commit();
  for (int step = 0; step < k.nsteps; ++step) {
    const int e = step % k.per, hh = k.grp * rep + step / k.per;
    cp_async_wait_one();
    __syncthreads();  // this step's raw tiles have landed; the last step's products are done
    dbc_split<NT>(e >= k.nE && k.kind == 1, e >= k.nE, raw + (step & 1) * T::kSlot, ops);
    fence_async_smem();
    __syncthreads();
    dbc_issue<NT>(p, k, step + 2, raw);
    cp_async_commit();
    if (e == k.nE) {  // the head's E (F) is complete: ec E (z F) into the sum, dec (dz)
      const long long me = bch(p, k.bb, k.ch, hh);
      const float* sv = p.scal + me * kScal * Q + (k.kind ? kZ : kEC) * Q;
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = row0 + 8 * half, tok = k.t0 + i;
        const bool in = i < Q && tok < p.s;
        const float si = in ? __ldg(sv + i) : 0.f;
        const float* mr = mat + min(i, kDRows - 1) * T::kBT + 2 * t;  // (zero past the tile)
#pragma unroll
        for (int c = 0; c < NT / 8; ++c) {
          const int x0 = 4 * c + 2 * half;
          const float e0 = kOne ? sum[x0] : E[x0], e1 = kOne ? sum[x0 + 1] : E[x0 + 1];
          const float2 mv = *reinterpret_cast<const float2*>(mr + 8 * c);
          dot[half] = fmaf(mv.y, e1, fmaf(mv.x, e0, dot[half]));
          if constexpr (kOne) {
            sum[x0] = si * e0;
            sum[x0 + 1] = si * e1;
          } else {
            sum[x0] = fmaf(si, e0, sum[x0]);
            sum[x0 + 1] = fmaf(si, e1, sum[x0 + 1]);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 1);
        dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 2);
        const int i = row0 + 8 * half;
        if (t == 0 && i < Q) (k.kind ? p.dzp : p.decp)[(me * p.ntn + k.tn) * Q + i] = dot[half];
      }
#pragma unroll
      for (int c = 0; c < kAcc; ++c) E[c] = 0.f;
    }
    // the warpgroup's rows meet this step: any row for E / F; dG's causal
    // band (dC: rows i >= columns j; dB: rows j <= columns i)
    const int k0 = (e - k.nE) * kDK;
    const bool on = rows && (e < k.nE || (k.kind == 0 ? k0 <= wg * 64 + 63 : k0 + kDK > wg * 64));
    float tmp[kAcc];
    wg_fence();
#pragma unroll
    for (int q = 0; q < kDK / 8; ++q) {
      const float* ah = ops + q * kDRows * 8 + wg * 8 * 64;
      const float* bh = ops + 2 * kDOpsA + q * NT * 8;
      if (on) {
        wgmma_ss<NT>(tmp, kdesc(ah + kDOpsA), kdesc(bh), q > 0);
        wgmma_ss<NT>(tmp, kdesc(ah), kdesc(bh + T::kOpsB), 1);
        wgmma_ss<NT>(tmp, kdesc(ah), kdesc(bh), 1);
      }
    }
    wg_commit();
    wg_wait0();
    pin(tmp);
    if (on) {
      if (e < k.nE && !kOne) {
#pragma unroll
        for (int c = 0; c < kAcc; ++c) E[c] += tmp[c];
      } else {
#pragma unroll
        for (int c = 0; c < kAcc; ++c) sum[c] += tmp[c];
      }
    }
  }
  float* out = k.kind ? p.dB : p.dC;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + 8 * half, tok = k.t0 + i;
    if (i >= Q || tok >= p.s) continue;
    float* row = out + (((long long)k.bb * p.s + tok) * p.g + k.grp) * p.n + k.n0;
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
      if (8 * c < k.nw)
        *reinterpret_cast<float2*>(row + 8 * c + 2 * t) =
            make_float2(sum[4 * c + 2 * half], sum[4 * c + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------- 5. chain
// A warp per (chunk, head, batch row): the scalars' chain to dt and cum
// (kernels/ref.py: ssd_scan_bwd; mamba_ssd_bwd.cu's warp 0), from dai and du
// (qq), dec and dz (dbc, its n tiles summed in order) and <dS, S> (the
// sweep, its blocks summed in order); dlog_decay is the reverse cumulative
// sum of dcum in the chunk.
__global__ void __launch_bounds__(32) mamba_ssd_wide_bwd_chain(Params p) {
  const int Q = p.Q, ch = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z, t0 = ch * Q;
  const int lane = threadIdx.x, E = (Q + 31) / 32, j0 = lane * E;
  const long long me = bch(p, bb, ch, hh);
  const float* sc = p.scal + me * kScal * Q;
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
  for (int i = 0; i < p.ndet; ++i) det += p.detp[me * p.ndet + i];
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
         n % 16 == 0 && Q >= 16 && Q <= kQmax && Q % 16 == 0 &&
         (long long)b * ((s + Q - 1) / Q) <= 65535 && (long long)b * g <= 65535 && h <= 65535;
}

long long up4(long long v) { return (v + 3) / 4 * 4; }

// The launches' geometry: blocks of a sweep cluster (one per 128 state
// rows, at most 8), clusters over n, strips of p, dbc's column tiles
struct Geometry {
  int csize, ncl, strips, dbc_nt, ntn, ndet;
};

Geometry geometry(int h, int g, int p, int n) {
  Geometry G;
  G.dbc_nt = h == g ? 128 : 64;
  G.csize = std::min(kCLmax, (n + kSL - 1) / kSL);
  G.ncl = (n + G.csize * kSL - 1) / (G.csize * kSL);
  G.strips = p <= kNarrowP ? 1 : (p + kPW - 1) / kPW;
  G.ntn = (n + G.dbc_nt - 1) / G.dbc_nt;
  G.ndet = G.strips * G.csize * G.ncl;
  return G;
}

// The scratch buffer's sections, in floats from its start (each a multiple
// of 4, so every section starts on 16 bytes): dS, the Gram, the scalars,
// exp(total), dG, dai, du, the dec and dz partial sums, <dS, S>'s, and past
// one cluster each cluster's z (B dS).
struct Layout {
  long long dS, gram, scal, et, dg, rowsum, colsum, decp, dzp, detp, dxpart, total;
};

Layout layout(int b, int s, int h, int g, int p, int n, int Q) {
  const long long nch = (s + Q - 1) / Q, bh = (long long)b * nch * h, GP = Q + 4;
  const Geometry G = geometry(h, g, p, n);
  Layout L;
  L.dS = 0;
  L.gram = L.dS + up4(bh * n * p);
  L.scal = L.gram + up4((long long)b * nch * g * Q * GP);
  L.et = L.scal + up4(bh * kScal * Q);
  L.dg = L.et + up4(bh);
  L.rowsum = L.dg + up4(bh * Q * GP);
  L.colsum = L.rowsum + up4(bh * Q);
  L.decp = L.colsum + up4(bh * Q);
  L.dzp = L.decp + up4(bh * G.ntn * Q);
  L.detp = L.dzp + up4(bh * G.ntn * Q);
  L.dxpart = L.detp + up4(bh * G.ndet);
  L.total = L.dxpart + (G.ncl > 1 ? up4((long long)G.ncl * b * s * h * p) : 0);
  return L;
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
  const struct {
    const void* fn;
    int smem;
  } limits[] = {
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_prep), prep_smem(kQmax)},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_qq), qq_smem_floats(kQmax, 1) * 4},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_sweep), kSweepSmem},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_narrow<1>), kNarrowSmem},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_narrow<2>), kNarrowSmem},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_narrow<4>), kNarrowSmem},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_dbc<64>), DbcTile<64>::kSmem},
      {reinterpret_cast<const void*>(mamba_ssd_wide_bwd_dbc<128>), DbcTile<128>::kSmem},
  };
  for (const auto& l : limits) {
    e = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (e != cudaSuccess) return e;
  }
  if (dev < 64) ready[dev] = true;
  return cudaSuccess;
}

// a launch of `kernel` in clusters of `cs` blocks along x (a block alone
// is its own cluster: a plain launch, which starts sooner)
cudaError_t launch_clusters(void (*kernel)(Params), dim3 grid, int threads, int smem, int cs,
                            const Params& prm, cudaStream_t st) {
  if (cs == 1) {
    kernel<<<grid, threads, smem, st>>>(prm);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, prm);
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
// out dx (unless need_dx is 0: dx may be null then and its work is
// skipped; the other gradients are bit-equal either way), dlog_decay,
// dscale, dB, dC in the inputs' shapes; scratch holds
// mamba_ssd_wide_bwd_scratch_bytes.  Five launches on `stream` (six past n
// = 1024 with dx); returns cudaGetLastError() after them, or -1 for a
// shape this kernel does not take (the forward's: g | h; n a multiple of
// 16; chunk a multiple of 16 in [16, 128]).
extern "C" int mamba_ssd_wide_bwd(const void* x, const void* a, const void* dt, const void* B,
                                  const void* C, const void* dy, const void* states, void* dx,
                                  void* da, void* ddt, void* dB, void* dC, void* scratch, int b,
                                  int s, int h, int g, int p, int n, int chunk, int need_dx,
                                  void* stream) {
  if (!shape_ok(b, s, h, g, p, n, chunk)) return -1;
  const int Q = chunk, nch = (s + Q - 1) / Q;
  const Geometry G = geometry(h, g, p, n);
  const Layout L = layout(b, s, h, g, p, n, Q);
  float* f = static_cast<float*>(scratch);
  const int want_dx = need_dx ? 1 : 0;
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<const float*>(dy),
             static_cast<const float*>(states), want_dx ? static_cast<float*>(dx) : nullptr,
             static_cast<float*>(da), static_cast<float*>(ddt), static_cast<float*>(dB),
             static_cast<float*>(dC), f + L.dS, f + L.gram, f + L.scal, f + L.et, f + L.dg,
             f + L.rowsum, f + L.colsum, f + L.decp, f + L.dzp, f + L.detp,
             G.ncl > 1 ? f + L.dxpart : nullptr, b, s, h, g, p, n, Q, nch, G.ntn, G.ndet,
             G.csize, G.ncl, want_dx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int warps = Q / 16;
  mamba_ssd_wide_bwd_prep<<<dim3(nch, b * g), 32 * warps, prep_smem(Q), st>>>(prm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  mamba_ssd_wide_bwd_qq<<<dim3(nch * (want_dx ? 2 : 1), h, b), 32 * warps,
                          qq_smem_floats(Q, want_dx) * 4, st>>>(prm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (p > kNarrowP) {
    e = launch_clusters(mamba_ssd_wide_bwd_sweep, dim3(G.csize * G.ncl * G.strips, h, b),
                        kThreads, kSweepSmem, G.csize, prm, st);
  } else {
    void (*narrow)(Params) = p == 1   ? &mamba_ssd_wide_bwd_narrow<1>
                             : p == 2 ? &mamba_ssd_wide_bwd_narrow<2>
                                      : &mamba_ssd_wide_bwd_narrow<4>;
    e = launch_clusters(narrow, dim3(G.csize * G.ncl, h, b), kNThreads, kNarrowSmem, G.csize,
                        prm, st);
  }
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (G.ncl > 1 && want_dx) {
    const long long total = (long long)b * s * h * p;
    const long long blocks = std::min<long long>((total + 255) / 256, 4096);
    mamba_ssd_wide_bwd_sum<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        f + L.dxpart, static_cast<float*>(dx), total, G.ncl);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  void (*dbc)(Params) =
      G.dbc_nt == 128 ? &mamba_ssd_wide_bwd_dbc<128> : &mamba_ssd_wide_bwd_dbc<64>;
  const int dbc_smem = G.dbc_nt == 128 ? DbcTile<128>::kSmem : DbcTile<64>::kSmem;
  dbc<<<dim3(2 * G.ntn, g, b * nch), kThreads, dbc_smem, st>>>(prm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  mamba_ssd_wide_bwd_chain<<<dim3(nch, h, b), 32, 0, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_ssd_wide_bwd_error_string(int code) {
  if (code < 0) return "unsupported shape (g | h; n a multiple of 16; chunk a multiple of 16 "
                       "in [16, 128]; batch x chunks <= 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
