// Backward of the chunked Mamba2 / SSD scan (mamba_ssd.cu) for Hopper,
// sm_90a: f32 in and out, every product on the tensor cores in 3xTF32,
// deterministic.
//
// Replaces no TPU kernel: the reference trains the hybrid LM through
// XLA's gradient of the jnp gated_linear_scan (src/repro/models/ssm.py),
// and its Pallas mamba_ssd (src/repro/kernels/mamba_ssd.py) has no
// backward.  It is the gradient of kernels/ref.py:ssd_scan(factorized=
// True) for ssm_groups == 1 (autograd's: the clip passes no gradient where
// +-60 bites, the centre (max cum + min cum) / 2 passes its gradient to the
// tied extremes in equal shares, the padding of a ragged chunk takes
// none).  Per (batch, chunk, head), with ai = exp(clip(cum - c)), bj =
// exp(clip(c - cum)), u = dt bj, w = exp(total - cum), z = w dt, ec =
// exp(cum), S the state entering the chunk (written by the forward's
// state-writing entry, mamba_ssd_fwd_states) and dS the gradient of the
// state leaving it, in the passes kernels/ref.py:mamba_ssd_bwd_tf32
// mirrors on the CPU:
//  (a) mamba_ssd_bwd_local: L = C^T (ec dy), and exp(total);
//  (b) mamba_ssd_bwd_carry: dS_c = exp(total_{c+1}) dS_{c+1} + L_{c+1},
//      swept over the chunks in reverse (dS = 0 leaving the last), in
//      place of L;
//  (c) mamba_ssd_bwd_chunk: M = dy x^T and G = C B^T on j <= i, dG = ai_i
//      u_j M, A2 = ai_i u_j G; dx = A2^T dy + z (B dS); E = dy S^T, F =
//      x dS^T; each head's dC = dG B + ec E and dB = dG^T C + z F; the
//      scalars' sums dai = sum_j G u M, du = sum_i G ai M, dec = sum C E,
//      dz = sum B F and <dS, S>; then the chain to dt and to cum (through
//      ai, bj, w, ec, exp(total) and the centre), and dlog_decay, the
//      reverse cumulative sum of dcum in the chunk;
//  then mamba_ssd_bwd_heads sums the head groups' shares of dB and dC in
//  order.  Tokens past s read as zeros and are not written.
//
// What bounds it.  At Zamba2's training microbatch (b 2, s 2048, h 80, p =
// n = chunk = 64) the bytes it must move (x, dy, the states and dx, f32,
// with the decays, B, C and their gradients) take 0.103 ms at 3.35 TB/s;
// its products, 8.1 G multiply-adds (chip_smoke.py: ssd_bwd_work), take
// 0.098 ms in 3xTF32 at the 495 TFLOP/s TF32 rate.  So bytes bound it, by
// a little.  The passes add L / dS (84 MB written by (a), read and written
// by (b), read by (c)) and the head groups' shares of dB and dC: ~0.8 GB
// in all, ~0.24 ms; and mma.sync reaches ~314 of the 495 TFLOP/s
// (tools/tf32_mma_rate.py), so ~0.16 ms of products.
//
// Design, against what held the f32-FMA kernel (4.34 ms at that shape:
// one 256-thread block per (head, batch row), 160 blocks on 132 SMs, each
// sweeping its 32 chunks in reverse through ~10 dependent shared-memory FMA
// products between ~11 barriers a chunk, ~7% of the f32 FMA rate):
// 1. The sequential dependency is only dS, an n x p matrix per (batch,
//    head): pass (b) carries it elementwise (a thread per 4 of its
//    elements), so (a) and (c) run every (batch, chunk, head) at once:
//    5,120 items at Zamba2's microbatch, where the FMA kernel had 160.
// 2. Products on the tensor cores: mma.sync m16n8k8 TF32 with the
//    forward's hi / lo split issued as 3xTF32 (ssd_common.cuh); one pass
//    misses the tolerance by 2-5x (ref.mamba_ssd_bwd_tf32, passes=1).  The
//    reductions the FMA kernel ran as two more products each (dy . G (u x),
//    dy . C S, x . G^T (ai dy), x . B dS) come from products it needs
//    anyway: G and M give dai and du elementwise, E and F give dec and dz.
//    The causal products skip the 16-row strips past the diagonal.
// 3. Enough warps to hide the latency of mma.sync chains fed from shared
//    memory (8 warps an SM left pass (c) at 0.92 ms, 16 take 0.61 at the
//    shape above).  A block of (c) takes one (batch, chunk) and kHeads
//    heads in turn, 16 warps: the chunk's C and B and its Gram G (in the
//    registers of the warps that use it) are shared by the heads; each
//    head's x, dy, S and dS are copied with cp.async into the other half of
//    a double buffer while the block works on the head before (205 KB at p
//    = n = chunk = 64).  dG and A2 are stored as lower triangles of 16-row
//    strips.  The products go out in units of a 16-row strip and 16
//    columns, one of dx's, dC's and dB's a warp at that shape.  Pass (a)
//    gives a head 4 warps, 4 heads a block, 2 blocks an SM; the carry
//    loads the next 8 chunks' L before it stores these 8.
// 4. Determinism: each warp owns fixed output tiles, so the heads' shares
//    of dB and dC are summed in head order in the group's slot of a
//    scratch buffer (the group's sum so far fetched before the unit's
//    products), and a last launch sums the groups in order: no atomics on
//    a result, two calls bit-equal.  dx, dscale and dlog_decay have one
//    owner each.
// Shapes too large for two stages run one; the launcher refuses a shape
// whose one stage exceeds 227 KB (every (p, n, chunk) the FMA kernel took
// runs).  p = n = chunk = 64 (Zamba2's) is compiled with fixed loop counts.
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
using ssd::load_b;
using ssd::mma3;
using ssd::split;

constexpr int kWarps = 16;               // pass (c)
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 8;                // heads a block of pass (c) takes in turn
constexpr int kLocalHeads = 4;           // pass (a): heads a block, 4 warps each
constexpr int kCarryThreads = 256;
constexpr int kMaxTiles = 5;             // lower 16 x 8 tiles a warp holds (chunk 128)
constexpr long long kSmemMax = 232448;   // bytes of shared memory a block may use

struct Params {
  const float* x;       // (b, s, h, p)
  const float* a;       // (b, s, h)  log decay
  const float* dt;      // (b, s, h)  input scale
  const float* B;       // (b, s, n)
  const float* C;       // (b, s, n)
  const float* dy;      // (b, s, h, p)
  const float* states;  // (b, chunks, h, n, p): the state entering each chunk
  float* dx;            // (b, s, h, p)
  float* da;            // (b, s, h)
  float* ddt;           // (b, s, h)
  float* dsl;           // (b, chunks, h, n, p): L, then dS leaving each chunk
  float* et;            // (b, chunks, h): exp(total)
  float* dBp;           // (b, groups, s, n): each head group's share of dB
  float* dCp;           // (b, groups, s, n): each head group's share of dC
  int b, s, h, p, n, Q, nch;
  int groups;           // head groups of kHeads
  int stages;           // 2: the next head loads while this one runs; 1: not
};

// 1 where clip60 passes its argument's gradient (torch.clamp's inclusive range)
__device__ __forceinline__ float in_clip(float v) { return (v >= -kClip && v <= kClip) ? 1.f : 0.f; }

// a 4-byte copy (a head's strided decays): zero-filled when ``valid`` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// A lower triangle of a Q x Q matrix, in 16-row strips: strip r holds
// columns 0 .. 16 r + 15 with a pitch of 16 (r + 1) + 4 floats (4 or 20 mod
// 32: ldmatrix rows on distinct banks)
__host__ __device__ __forceinline__ int tri_off(int r) { return 128 * r * (r + 1) + 64 * r; }
__host__ __device__ __forceinline__ int tri_pitch(int r) { return 16 * (r + 1) + 4; }

// A (16 x 8) from a [k][rows] array: element (r, k) at m[k * ld + r]
__device__ __forceinline__ void load_at(const float* m, int ld, int r0, int k0, int g, int t,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* q = m + (k0 + t) * ld + r0 + g;
  split(q[0], hi[0], lo[0]);
  split(q[8], hi[1], lo[1]);
  split(q[4 * ld], hi[2], lo[2]);
  split(q[4 * ld + 8], hi[3], lo[3]);
}

// B (8 x 8) from a [n][k] array: element (k, c) at m[c * ld + k]
__device__ __forceinline__ void load_bt(const float* m, int ld, int k0, int c0, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* q = m + (c0 + g) * ld + k0 + t;
  split(q[0], hi[0], lo[0]);
  split(q[4], hi[1], lo[1]);
}

// the A fragment of rows r0.. (a 16-row strip), columns k0.. of a row-major
// array, split
__device__ __forceinline__ void lda_split(const float* m, int ld, int r0, int k0, int lane,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  float v[4];
  ldsm_a(m, ld, r0, k0, lane, v);
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
}

// The chunk's cumulative decays across a warp: lane holds tokens lane * E
// + e (e < E = ceil(Q / 32)) of the Q log decays av (zero past s); returns
// cum and the chunk's max, min and total in every lane.
__device__ __forceinline__ void warp_cum(const float* av, int Q, int lane, float (&cum)[4],
                                         float& mx, float& mn, float& total) {
  const int E = (Q + 31) / 32, j0 = lane * E;
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run += (e < E && j0 + e < Q) ? av[j0 + e] : 0.f;
    cum[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float off = incl - run;
  mx = -INFINITY;
  mn = INFINITY;
  float last = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < E && j0 + e < Q) {
      cum[e] += off;
      mx = fmaxf(mx, cum[e]);
      mn = fminf(mn, cum[e]);
      if (j0 + e == Q - 1) last = cum[e];
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  total = __shfl_sync(0xffffffffu, last, (Q - 1) / E);
}

// --------------------------------------------------- (a) the local term
// Block (chunk, batch row, group of lheads heads), 4 warps a head: L = C^T
// (ec dy) (n x p) into dsl, exp(total) into et.  Shared memory: C [Q][n +
// 4], then per head dy [Q][p + 4] and ec [Q].
__global__ void __launch_bounds__(128 * kLocalHeads, 2) mamba_ssd_bwd_local(Params p, int lheads) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, N = p.n, PD = p.p, NP = N + 4, XP = PD + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int hl = warp >> 2, hw = warp & 3;  // the warp's head in the block, its quarter
  const int ch = blockIdx.x, bb = blockIdx.y, hh = blockIdx.z * lheads + hl, t0 = ch * Q;
  float* cs = sm;
  float* dys = sm + Q * NP + hl * (Q * XP + Q);
  float* ec = dys + Q * XP;
  for (int i = threadIdx.x; i < Q * (N / 4); i += blockDim.x) {
    const int r = i / (N / 4), q4 = i % (N / 4) * 4, tok = t0 + r;
    cp_async16(cs + r * NP + q4, p.C + ((long long)bb * p.s + min(tok, p.s - 1)) * N + q4,
               tok < p.s);
  }
  const bool active = hh < p.h;
  const long long xrow = (long long)p.h * PD;
  if (active)
    for (int i = threadIdx.x & 127; i < Q * (PD / 4); i += 128) {
      const int r = i / (PD / 4), q4 = i % (PD / 4) * 4, tok = t0 + r;
      cp_async16(dys + r * XP + q4,
                 p.dy + ((long long)bb * p.s + min(tok, p.s - 1)) * xrow + hh * PD + q4,
                 tok < p.s);
    }
  cp_async_commit();
  if (active && hw == 0) {  // the decays, straight from global memory, into ec
    for (int j = lane; j < Q; j += 32) {
      const int tok = t0 + j;
      ec[j] = tok < p.s ? __ldg(p.a + ((long long)bb * p.s + tok) * p.h + hh) : 0.f;
    }
    __syncwarp();
    float cum[4], mx, mn, total;
    warp_cum(ec, Q, lane, cum, mx, mn, total);
    __syncwarp();
    const int E = (Q + 31) / 32, j0 = lane * E;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) ec[j0 + e] = expf(cum[e]);
    if (lane == 0) p.et[((long long)bb * p.nch + ch) * p.h + hh] = expf(total);
  }
  cp_async_wait_all();
  __syncthreads();  // C, every head's dy and ec
  if (!active) return;
  float* out = p.dsl + (((long long)bb * p.nch + ch) * p.h + hh) * N * PD;
  // output units: a 16-row strip of n and up to 4 column tiles of p, the
  // head's 4 warps taking every fourth
  const int cgroups = (PD + 31) / 32;
  for (int u = hw; u < (N / 16) * cgroups; u += 4) {
    const int r0 = u / cgroups * 16, c0 = u % cgroups * 32, nt = min(4, (PD - c0) / 8);
    float acc[4][2][4] = {};
    for (int k0 = 0; k0 < Q; k0 += 8) {
      uint32_t ah[4], al[4];
      load_at(cs, NP, r0, k0, g, t, ah, al);  // (kk, i) = C[i][kk]
      const float e0 = ec[k0 + t], e1 = ec[k0 + t + 4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nt) {
          uint32_t bh[2], bl[2];
          const float* q = dys + (k0 + t) * XP + c0 + 8 * c + g;
          split(q[0] * e0, bh[0], bl[0]);
          split(q[4 * XP] * e1, bh[1], bl[1]);
          mma3(acc[c][0], acc[c][1], ah, al, bh, bl);
        }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(out + (r0 + g + 8 * half) * PD + c0 + 8 * c + 2 * t) =
              make_float2(acc[c][1][2 * half] + acc[c][0][2 * half],
                          acc[c][1][2 * half + 1] + acc[c][0][2 * half + 1]);
  }
}

// ---------------------------------------------------------- (b) the carry
// the chunk that step j of the carry visits: the sweep runs from the last
// chunk to the first
__device__ __forceinline__ int sweep_chunk(int j, int nch) { return nch - 1 - j; }

// A thread per 4 elements of one (batch, head)'s n x p state gradient:
// over the chunks in reverse, dsl[c] (L_c) becomes dS leaving chunk c and
// the carry becomes exp(total_c) dS + L_c.  The L of 8 chunks are in
// registers at a time, the next 8 loaded before these are stored.
__global__ void __launch_bounds__(kCarryThreads) mamba_ssd_bwd_carry(Params p) {
  const long long per = (long long)p.n * p.p / 4;  // float4s of one state
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= (long long)p.b * p.h * per) return;
  const long long bh = i / per, e4 = i % per;
  const int bb = (int)(bh / p.h), hh = (int)(bh % p.h);
  const long long cstride = (long long)p.h * per;  // float4s between chunks
  float4* base = reinterpret_cast<float4*>(p.dsl) + ((long long)bb * p.nch * p.h + hh) * per + e4;
  const float* et = p.et + (long long)bb * p.nch * p.h + hh;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f), l[8], ln[8];
  float e[8], en[8];
  auto load = [&](int j0, float4 (&lv)[8], float (&ev)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j0 + k < p.nch) {
        const int c = sweep_chunk(j0 + k, p.nch);
        lv[k] = base[c * cstride];
        ev[k] = __ldg(et + (long long)c * p.h);
      }
  };
  load(0, l, e);
  for (int j0 = 0; j0 < p.nch; j0 += 8) {
    if (j0 + 8 < p.nch) load(j0 + 8, ln, en);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j0 + k < p.nch) {
        base[sweep_chunk(j0 + k, p.nch) * cstride] = run;
        run.x = e[k] * run.x + l[k].x;
        run.y = e[k] * run.y + l[k].y;
        run.z = e[k] * run.z + l[k].z;
        run.w = e[k] * run.w + l[k].w;
      }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      l[k] = ln[k];
      e[k] = en[k];
    }
  }
}

// ------------------------------------------------------ (c) the chunk
// Shared memory of pass (c), in floats: C and B [Q][n + 4]; the stages,
// each x and dy [Q][p + 4], S and dS [n][p + 4], the head's log decays and
// scales [Q]; dG and A2 as lower triangles (tri_off); the scalars [10][Q]
// and exp(total); the partial sums of dai [Q / 8][Q], du [Q / 16][Q], dec
// and dz [n / 16][Q]; <dS, S> [kWarps].
struct ChunkSmem {
  int c, b, stage, stage_floats, x, dy, S, dS, av, dtv, dg, a2, sc, rowp, colp, decp, dzp, detp,
      total;
};

__host__ __device__ inline ChunkSmem chunk_layout(int Q, int n, int pd, int stages) {
  ChunkSmem m;
  const int np = n + 4, xp = pd + 4;
  m.c = 0;
  m.b = Q * np;
  m.stage = 2 * Q * np;
  m.x = 0;
  m.dy = Q * xp;
  m.S = 2 * Q * xp;
  m.dS = m.S + n * xp;
  m.av = m.dS + n * xp;
  m.dtv = m.av + Q;
  m.stage_floats = m.dtv + Q;
  m.dg = m.stage + stages * m.stage_floats;
  m.a2 = m.dg + tri_off(Q / 16);
  m.sc = m.a2 + tri_off(Q / 16);
  m.rowp = m.sc + 10 * Q + 4;
  m.colp = m.rowp + (Q / 8) * Q;
  m.decp = m.colp + (Q / 16) * Q;
  m.dzp = m.decp + (n / 16) * Q;
  m.detp = m.dzp + (n / 16) * Q;
  m.total = m.detp + kWarps;
  return m;
}

// the scalars' arrays in sc
enum { kAI, kBJ, kU, kZ, kW, kEC, kDT, kMA, kMB, kTW };

// lower 16 x 8 tile k of a Q x Q matrix: 16-row strip rt, 8-column tile ct
// (ct <= 2 rt + 1)
__device__ __forceinline__ void tile_of(int k, int& rt, int& ct) {
  rt = 0;
  while ((rt + 1) * (rt + 2) <= k) ++rt;
  ct = k - rt * (rt + 1);
}

// QN: p = n = chunk = QN known when compiling (64, Zamba2's), or 0
template <int QN>
__global__ void __launch_bounds__(kThreads, 1) mamba_ssd_bwd_chunk(Params p) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TW = QN ? (QN / 16) * (QN / 16 + 1) / kWarps + 1 : kMaxTiles;
  const int Q = QN ? QN : p.Q, N = QN ? QN : p.n, PD = QN ? QN : p.p, R = Q / 16;
  const ChunkSmem L = chunk_layout(Q, N, PD, p.stages);
  const int NP = N + 4, XP = PD + 4, ntiles = R * (R + 1), CGP = PD / 16, CGN = N / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int ch = blockIdx.x, bb = blockIdx.y, grp = blockIdx.z, t0 = ch * Q;
  const int h0 = grp * kHeads, nh = min(kHeads, p.h - h0);
  const long long xrow = (long long)p.h * PD;
  const float* cs = sm + L.c;
  const float* bs = sm + L.b;
  float* dg = sm + L.dg;
  float* a2 = sm + L.a2;
  float* sc = sm + L.sc;
  float* rowp = sm + L.rowp;
  float* colp = sm + L.colp;
  float* decp = sm + L.decp;
  float* dzp = sm + L.dzp;
  float* detp = sm + L.detp;
  float* dBp = p.dBp + ((long long)bb * p.groups + grp) * p.s * N;
  float* dCp = p.dCp + ((long long)bb * p.groups + grp) * p.s * N;

  // copy head hl's x, dy, S, dS, decays and scales into stage st (16 bytes
  // a copy but the strided decays; tokens past s zero: the reference's
  // padding)
  auto issue = [&](int hl, int st) {
    float* base = sm + L.stage + st * L.stage_floats;
    const int hh = h0 + hl;
    for (int i = tid; i < Q * (PD / 4); i += kThreads) {
      const int r = i / (PD / 4), q4 = i % (PD / 4) * 4, tok = t0 + r;
      const long long off = ((long long)bb * p.s + min(tok, p.s - 1)) * xrow + hh * PD + q4;
      cp_async16(base + L.x + r * XP + q4, p.x + off, tok < p.s);
      cp_async16(base + L.dy + r * XP + q4, p.dy + off, tok < p.s);
    }
    const long long so = (((long long)bb * p.nch + ch) * p.h + hh) * N * PD;
    for (int i = tid; i < N * (PD / 4); i += kThreads) {
      const int r = i / (PD / 4), q4 = i % (PD / 4) * 4;
      cp_async16(base + L.S + r * XP + q4, p.states + so + r * PD + q4, true);
      cp_async16(base + L.dS + r * XP + q4, p.dsl + so + r * PD + q4, true);
    }
    for (int j = tid; j < Q; j += kThreads) {
      const int tok = t0 + j;
      const long long off = ((long long)bb * p.s + min(tok, p.s - 1)) * p.h + hh;
      cp_async4(base + L.av + j, p.a + off, tok < p.s);
      cp_async4(base + L.dtv + j, p.dt + off, tok < p.s);
    }
    cp_async_commit();
  };

  // the chunk's C and B, in the first group of copies
  for (int i = tid; i < Q * (N / 4); i += kThreads) {
    const int r = i / (N / 4), q4 = i % (N / 4) * 4, tok = t0 + r;
    const long long off = ((long long)bb * p.s + min(tok, p.s - 1)) * N + q4;
    cp_async16(sm + L.c + r * NP + q4, p.C + off, tok < p.s);
    cp_async16(sm + L.b + r * NP + q4, p.B + off, tok < p.s);
  }
  issue(0, 0);
  float gt[TW][4];  // this warp's lower tiles of the Gram C B^T, for every head

  for (int hl = 0; hl < nh; ++hl) {
    const int hh = h0 + hl;
    if (p.stages == 1 && hl > 0) {
      __syncthreads();  // head hl - 1 is done with the stage
      issue(hl, 0);
    }
    cp_async_wait_all();
    __syncthreads();  // head hl has landed; head hl - 1 is done everywhere
    if (p.stages == 2 && hl + 1 < nh) issue(hl + 1, (hl + 1) & 1);
    const float* stg = sm + L.stage + (p.stages == 2 ? (hl & 1) : 0) * L.stage_floats;
    const float* xs = stg + L.x;
    const float* dys = stg + L.dy;
    const float* ss = stg + L.S;
    const float* dss = stg + L.dS;

    // ---- warp 0: the head's scalars
    if (warp == 0) {
      float cum[4], mx, mn, total;
      warp_cum(stg + L.av, Q, lane, cum, mx, mn, total);
      const int E = (Q + 31) / 32, j0 = lane * E;
      int nmx = 0, nmn = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < E && j0 + e < Q) {
          nmx += cum[e] == mx;
          nmn += cum[e] == mn;
        }
      nmx = __reduce_add_sync(0xffffffffu, nmx);
      nmn = __reduce_add_sync(0xffffffffu, nmn);
      const float center = 0.5f * (mx + mn);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < E && j0 + e < Q) {
          const int j = j0 + e;
          const float ci = cum[e], ea = ci - center, eb = center - ci, dtj = stg[L.dtv + j];
          const float ai = expf(clip60(ea)), bj = expf(clip60(eb)), w = expf(total - ci);
          sc[kAI * Q + j] = ai;
          sc[kBJ * Q + j] = bj;
          sc[kU * Q + j] = dtj * bj;
          sc[kZ * Q + j] = w * dtj;
          sc[kW * Q + j] = w;
          sc[kEC * Q + j] = expf(ci);
          sc[kDT * Q + j] = dtj;
          sc[kMA * Q + j] = in_clip(ea);
          sc[kMB * Q + j] = in_clip(eb);
          sc[kTW * Q + j] = (ci == mx ? 0.5f / nmx : 0.f) + (ci == mn ? 0.5f / nmn : 0.f);
        }
      if (lane == 0) sc[10 * Q] = expf(total);
    }

    __syncthreads();  // the scalars

    // ---- per lower tile m of this warp: the Gram (first head only) and M =
    // dy x^T, then dG = ai_i u_j M and A2 = ai_i u_j G on j <= i (ai_i u_j is
    // never formed above the diagonal, where it may overflow), and the
    // tile's shares of dai_i = sum_j G u M and du_j = sum_i G ai M
#pragma unroll
    for (int m = 0; m < TW; ++m) {
      const int k = warp + kWarps * m;
      if (k >= ntiles) break;
      int rt, ct;
      tile_of(k, rt, ct);
      float acc[2][2][4] = {};  // [M, G][big, small]
      for (int k0 = 0; k0 < PD; k0 += 8) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        lda_split(dys, XP, 16 * rt, k0, lane, ah, al);
        load_bt(xs, XP, k0, 8 * ct, g, t, bh, bl);  // (c, j) = x[j][c]
        mma3(acc[0][0], acc[0][1], ah, al, bh, bl);
      }
      if (hl == 0) {
        for (int k0 = 0; k0 < N; k0 += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          lda_split(cs, NP, 16 * rt, k0, lane, ah, al);
          load_bt(bs, NP, k0, 8 * ct, g, t, bh, bl);  // (k, j) = B[j][k]
          mma3(acc[1][0], acc[1][1], ah, al, bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[m][e] = acc[1][1][e] + acc[1][0][e];
      }
      float mv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) mv[e] = acc[0][1][e] + acc[0][0][e];
      float rs[2] = {0.f, 0.f}, cl[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * rt + g + 8 * half;
        const float ai = sc[kAI * Q + i];
        float dgv[2], a2v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * ct + 2 * t + e;
          const float G = gt[m][2 * half + e], Mv = mv[2 * half + e];
          dgv[e] = a2v[e] = 0.f;
          if (j <= i) {
            const float uj = sc[kU * Q + j], au = ai * uj;
            dgv[e] = au * Mv;
            a2v[e] = au * G;
            rs[half] = fmaf(G * uj, Mv, rs[half]);
            cl[e] = fmaf(G * ai, Mv, cl[e]);
          }
        }
        const int off = tri_off(rt) + (g + 8 * half) * tri_pitch(rt) + 8 * ct + 2 * t;
        *reinterpret_cast<float2*>(dg + off) = make_float2(dgv[0], dgv[1]);
        *reinterpret_cast<float2*>(a2 + off) = make_float2(a2v[0], a2v[1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows: over the 4 lanes of a quad
        rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 1);
        rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 2);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // columns: over the 8 quads
        cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], 4);
        cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], 8);
        cl[e] += __shfl_xor_sync(0xffffffffu, cl[e], 16);
      }
      if (t == 0) {
        rowp[ct * Q + 16 * rt + g] = rs[0];
        rowp[ct * Q + 16 * rt + g + 8] = rs[1];
      }
      if (g == 0) {
        colp[rt * Q + 8 * ct + 2 * t] = cl[0];
        colp[rt * Q + 8 * ct + 2 * t + 1] = cl[1];
      }
    }
    __syncthreads();  // dG, A2

    // ---- the products, by units of a 16-row strip and 16 columns: dx's
    // (R x CGP units), dC's and dB's (R x CGN each); at p = n = chunk = 64
    // each warp takes one of each kind in the same strip
    const float* zv = sc + kZ * Q;
    const float* ecv = sc + kEC * Q;
    for (int u = warp; u < R * (CGP + 2 * CGN); u += kWarps) {
      const int kind = u < R * CGP ? 0 : u < R * (CGP + CGN) ? 1 : 2;
      const int v = kind == 0 ? u : kind == 1 ? u - R * CGP : u - R * (CGP + CGN);
      const int cg = kind == 0 ? CGP : CGN, r = v / cg, c0 = v % cg * 16, r0 = 16 * r;
      float acc[2][2][2][4] = {};  // [product][column tile][big, small]
      if (kind == 0) {
        // u P = A2^T dy (i from r0: A2 is 0 above the diagonal), R = B dS
        for (int k0 = r0; k0 < Q; k0 += 8) {
          uint32_t ah[4], al[4];
          load_at(a2 + tri_off(k0 >> 4), tri_pitch(k0 >> 4), r0, k0 & 15, g, t, ah, al);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t bh[2], bl[2];
            load_b(dys, XP, k0, c0 + 8 * c, g, t, bh, bl);
            mma3(acc[0][c][0], acc[0][c][1], ah, al, bh, bl);
          }
        }
        for (int k0 = 0; k0 < N; k0 += 8) {
          uint32_t ah[4], al[4];
          lda_split(bs, NP, r0, k0, lane, ah, al);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t bh[2], bl[2];
            load_b(dss, XP, k0, c0 + 8 * c, g, t, bh, bl);
            mma3(acc[1][c][0], acc[1][c][1], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = r0 + g + 8 * half, tok = t0 + j;
          if (tok >= p.s) continue;
          const float zj = zv[j];
          float* row = p.dx + ((long long)bb * p.s + tok) * xrow + hh * PD;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float o[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              o[e] = (acc[0][c][1][2 * half + e] + acc[0][c][0][2 * half + e]) +
                     zj * (acc[1][c][1][2 * half + e] + acc[1][c][0][2 * half + e]);
            *reinterpret_cast<float2*>(row + c0 + 8 * c + 2 * t) = make_float2(o[0], o[1]);
          }
        }
        continue;
      }
      // this group's share of dC (kind 1) or dB (kind 2) so far, fetched
      // before the products so that its latency hides behind them
      float* part = kind == 1 ? dCp : dBp;
      float2 prev[2][2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int tok = t0 + r0 + g + 8 * half;
          prev[half][c] = hl > 0 && tok < p.s
              ? *reinterpret_cast<const float2*>(part + (long long)tok * N + c0 + 8 * c + 2 * t)
              : make_float2(0.f, 0.f);
        }
      const float* mine = kind == 1 ? cs : bs;  // the dot partner of E or F
      if (kind == 1) {
        // dC = dG B (j < r0 + 16) + ec E, E = dy S^T
        for (int k0 = 0; k0 < PD; k0 += 8) {
          uint32_t ah[4], al[4];
          lda_split(dys, XP, r0, k0, lane, ah, al);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t bh[2], bl[2];
            load_bt(ss, XP, k0, c0 + 8 * c, g, t, bh, bl);  // (c', k) = S[k][c']
            mma3(acc[0][c][0], acc[0][c][1], ah, al, bh, bl);
          }
        }
        for (int k0 = 0; k0 < r0 + 16; k0 += 8) {
          uint32_t ah[4], al[4];
          lda_split(dg + tri_off(r), tri_pitch(r), 0, k0, lane, ah, al);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t bh[2], bl[2];
            load_b(bs, NP, k0, c0 + 8 * c, g, t, bh, bl);
            mma3(acc[1][c][0], acc[1][c][1], ah, al, bh, bl);
          }
        }
      } else {
        // dB = dG^T C (i from r0) + z F, F = x dS^T
        for (int k0 = 0; k0 < PD; k0 += 8) {
          uint32_t ah[4], al[4];
          lda_split(xs, XP, r0, k0, lane, ah, al);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t bh[2], bl[2];
            load_bt(dss, XP, k0, c0 + 8 * c, g, t, bh, bl);  // (c', k) = dS[k][c']
            mma3(acc[0][c][0], acc[0][c][1], ah, al, bh, bl);
          }
        }
        for (int k0 = r0; k0 < Q; k0 += 8) {
          uint32_t ah[4], al[4];
          load_at(dg + tri_off(k0 >> 4), tri_pitch(k0 >> 4), r0, k0 & 15, g, t, ah, al);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t bh[2], bl[2];
            load_b(cs, NP, k0, c0 + 8 * c, g, t, bh, bl);
            mma3(acc[1][c][0], acc[1][c][1], ah, al, bh, bl);
          }
        }
      }
      // the share = (dG B or dG^T C) + (ec_i E or z_j F), added to the
      // group's; dec_i = sum C E, dz_j = sum B F over the unit's columns
      const float* scale = kind == 1 ? ecv : zv;
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half, tok = t0 + i;
        const float si = scale[i];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = c0 + 8 * c + 2 * t + e;
            const float Ev = acc[0][c][1][2 * half + e] + acc[0][c][0][2 * half + e];
            dot[half] = fmaf(mine[i * NP + kk], Ev, dot[half]);
            o[e] = (acc[1][c][1][2 * half + e] + acc[1][c][0][2 * half + e]) + si * Ev;
          }
          if (tok < p.s)
            *reinterpret_cast<float2*>(part + (long long)tok * N + c0 + 8 * c + 2 * t) =
                make_float2(o[0] + prev[half][c].x, o[1] + prev[half][c].y);
        }
      }
      float* dotp = kind == 1 ? decp : dzp;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 1);
        dot[half] += __shfl_xor_sync(0xffffffffu, dot[half], 2);
        if (t == 0) dotp[(c0 / 16) * Q + r0 + g + 8 * half] = dot[half];
      }
    }
    // <dS, S>: a share a thread, summed over the warp, then the warps in order
    {
      float part = 0.f;
      for (int i = tid; i < N * PD; i += kThreads)
        part = fmaf(dss[i / PD * XP + i % PD], ss[i / PD * XP + i % PD], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) detp[warp] = part;
    }
    __syncthreads();  // every partial sum

    // ---- warp 0: the scalars' chain to dt and dlog_decay
    if (warp == 0) {
      const int E = (Q + 31) / 32, j0 = lane * E;
      float dcum[4], cen = 0.f, tot = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dcum[e] = 0.f;
        const int j = j0 + e;
        if (e >= E || j >= Q) continue;
        float dai = 0.f, du = 0.f, dec = 0.f, dz = 0.f;
        for (int ct = 0; ct <= 2 * (j >> 4) + 1; ++ct) dai += rowp[ct * Q + j];
        for (int rt = j >> 4; rt < R; ++rt) du += colp[rt * Q + j];
        for (int c = 0; c < CGN; ++c) {
          dec += decp[c * Q + j];
          dz += dzp[c * Q + j];
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
      for (int w = 0; w < kWarps; ++w) det += detp[w];
      tot += det * sc[10 * Q];
      // dcum += the centre's and total's shares; dlog_decay = its reverse
      // cumulative sum: within the lane, then over the lanes above
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
  }
}

// dB and dC: the head groups' shares summed in order (y 0: dB, 1: dC)
__global__ void __launch_bounds__(256) mamba_ssd_bwd_heads(const float* dBp, const float* dCp,
                                                          float* dB, float* dC, int b,
                                                          int groups, long long sn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * sn) return;
  const float* part = blockIdx.y ? dCp : dBp;
  const long long bb = i / sn, e = i % sn;
  float acc = 0.f;
  for (int gr = 0; gr < groups; ++gr) acc += part[(bb * groups + gr) * sn + e];
  (blockIdx.y ? dC : dB)[i] = acc;
}

bool shape_ok(int v) { return v >= 16 && v <= 128 && v % 16 == 0; }

// exp(total)'s floats in the scratch, a multiple of 4: the head groups'
// shares after it are read and written as float2 (and L / dS before it as
// float4)
long long et_floats(int b, int nch, int h) { return ((long long)b * nch * h + 3) / 4 * 4; }

long long chunk_bytes(int Q, int n, int pd, int stages) {
  return chunk_layout(Q, n, pd, stages).total * 4LL;
}

long long local_bytes(int Q, int n, int pd, int heads) {
  return 4LL * (Q * (n + 4) + heads * (Q * (pd + 4) + Q));
}

}  // namespace

// Bytes of the scratch buffer mamba_ssd_bwd needs: L / dS (b, chunks, h, n,
// p), exp(total) (b, chunks, h; padded to 16 bytes), and each head group's
// share of dB and of dC, (b, ceil(h / 8), s, n) each; all f32.
extern "C" long long mamba_ssd_bwd_scratch_bytes(int b, int s, int h, int p, int n, int chunk) {
  if (chunk < 1) return 0;
  const long long nch = (s + chunk - 1) / chunk, groups = (h + kHeads - 1) / kHeads;
  return 4LL * (b * nch * h * (long long)n * p + et_floats(b, nch, h) +
                2LL * b * groups * s * n);
}

// Bytes of shared memory the widest block takes at (n, p, chunk) with one
// stage; above 232448 the launcher refuses the shape.
extern "C" long long mamba_ssd_bwd_smem_bytes(int n, int p, int chunk) {
  return std::max(chunk_bytes(chunk, n, p, 1), local_bytes(chunk, n, p, 1));
}

// All tensors f32 and contiguous: the forward's inputs, dy (b, s, h, p),
// the states its state-writing entry wrote (b, ceil(s / chunk), h, n, p);
// out dx, dlog_decay, dscale, dB, dC in the inputs' shapes; scratch holds
// mamba_ssd_bwd_scratch_bytes.  Returns cudaGetLastError() after the
// launches, or -1 for a shape this kernel does not take (p, n and chunk
// multiples of 16 in [16, 128] whose tiles fit 227 KB).
extern "C" int mamba_ssd_bwd(const void* x, const void* a, const void* dt, const void* B,
                             const void* C, const void* dy, const void* states, void* dx,
                             void* da, void* ddt, void* dB, void* dC, void* scratch, int b, int s,
                             int h, int p, int n, int chunk, void* stream) {
  if (!shape_ok(p) || !shape_ok(n) || !shape_ok(chunk) || b < 1 || s < 1 || h < 1) return -1;
  if (mamba_ssd_bwd_smem_bytes(n, p, chunk) > kSmemMax) return -1;
  const int nch = (s + chunk - 1) / chunk, groups = (h + kHeads - 1) / kHeads;
  float* f = static_cast<float*>(scratch);
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<const float*>(dy),
             static_cast<const float*>(states), static_cast<float*>(dx),
             static_cast<float*>(da), static_cast<float*>(ddt), f,
             f + (long long)b * nch * h * n * p, nullptr, nullptr, b, s, h, p, n, chunk, nch,
             groups, chunk_bytes(chunk, n, p, 2) <= kSmemMax ? 2 : 1};
  prm.dBp = prm.et + et_floats(b, nch, h);
  prm.dCp = prm.dBp + (long long)b * groups * s * n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  // (a): as many heads a block as fit
  int lh = kLocalHeads;
  while (lh > 1 && local_bytes(chunk, n, p, lh) > kSmemMax) --lh;
  const int lsmem = (int)local_bytes(chunk, n, p, lh);
  cudaError_t e =
      cudaFuncSetAttribute(mamba_ssd_bwd_local, cudaFuncAttributeMaxDynamicSharedMemorySize, lsmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mamba_ssd_bwd_local<<<dim3(nch, b, (h + lh - 1) / lh), 128 * lh, lsmem, st>>>(prm, lh);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  // (b)
  const long long carry = (long long)b * h * n * p / 4;
  mamba_ssd_bwd_carry<<<(unsigned)((carry + kCarryThreads - 1) / kCarryThreads), kCarryThreads,
                        0, st>>>(prm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  // (c)
  auto kernel = (chunk == 64 && n == 64 && p == 64) ? mamba_ssd_bwd_chunk<64>
                                                    : mamba_ssd_bwd_chunk<0>;
  const int csmem = (int)chunk_bytes(chunk, n, p, prm.stages);
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, csmem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  kernel<<<dim3(nch, b, groups), kThreads, csmem, st>>>(prm);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const long long sn = (long long)s * n;
  mamba_ssd_bwd_heads<<<dim3((unsigned)((b * sn + 255) / 256), 2), 256, 0, st>>>(
      prm.dBp, prm.dCp, static_cast<float*>(dB), static_cast<float*>(dC), b, groups, sn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_ssd_bwd_error_string(int code) {
  if (code < 0) return "unsupported shape (p, n, chunk multiples of 16 in [16, 128] whose "
                       "tiles fit 227 KB of shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
