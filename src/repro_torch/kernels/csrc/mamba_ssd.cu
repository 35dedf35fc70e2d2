// Chunked Mamba2 / SSD scan for Hopper, sm_90a: f32 in and out, every
// product on the tensor cores in 3xTF32.
//
// Replaces: src/repro/kernels/mamba_ssd.py:mamba_ssd, the Pallas TPU
// kernel (grid (batch, head blocks, chunks) with the chunk axis run in
// order and the state S (hb, n, p) carried in VMEM scratch).
//
// Same function (gated_linear_scan(factorized=True) for ssm_groups == 1):
// per (batch, head) and chunk of Q tokens, with cum the in-chunk
// cumulative sum of log_decay, total = cum[Q-1] and the centre
// c = (max cum + min cum) / 2,
//   y[i]  = exp(clip(cum_i - c)) * sum_{j<=i} (C_i.B_j) dt_j exp(clip(c - cum_j)) x_j
//         + exp(cum_i) * C_i . S
//   S    <- exp(total) S + sum_j exp(total - cum_j) dt_j B_j (x) x_j
// with clip to [-60, 60] and S = 0 at the first chunk.  A ragged last
// chunk is padded with zero decay and zero input, as the reference pads.
//
// What bounds it.  At Zamba2's prefill (b 2, s 4096, h 80, p = n = 64,
// Q 64) the scan needs 6.75 G multiply-adds (the causal Gram once per
// (batch, chunk); the causal G.x, C.S and the state update per head):
// 13.5 GFLOP, issued three times over in 3xTF32, is 0.082 ms at the 495
// TFLOP/s TF32 rate.  It must move ~345 MB (x and y f32, B, C, decays and
// scales once each): 0.103 ms at 3.35 TB/s.  So bytes bound it, by a
// little.
//
// Design, against what held the f32-FMA kernel (1.41 ms) back
// (tools/mamba_ssd_variants.py times each choice):
// 1. Products on the tensor cores: mma.sync m16n8k8 TF32 with f32
//    accumulators, A fragments by ldmatrix, B fragments by 4-byte loads,
//    from shared memory.  Each operand is split as hi = tf32(v),
//    lo = tf32(v - hi), rounded to nearest with ties away (split(); the
//    PTX cvt.rna costs four instructions, this two), and each product is
//    issued as lo.hi + hi.lo + hi.hi (3xTF32; one pass leaves the
//    5e-4 + 5e-4 |y| tolerance), into two accumulators so that chains of
//    dependent products stay short (ssd_common.cuh: split, mma3 and the
//    fragment loads, shared with the backward, mamba_ssd_bwd.cu).  The causal Gram C.B^T does not
//    depend on the head (ssm_groups == 1): a pre-pass kernel computes it
//    once per (batch, chunk), with B^T and each head's decay scalars
//    (the prefix scan and the exps, one warp per head), into a scratch
//    buffer the wrapper allocates.  G.x skips the key tiles past each
//    16-row strip.
// 2. Every SM loaded.  The p columns of S and y never interact, so a work
//    unit is one (batch, head, slice of kSlice columns): 640 units at the
//    prefill.  A block holds up to kMaxUnits units of one batch row, four
//    warps each, which share the chunk's C, B^T and Gram in shared memory;
//    the launcher gives each batch row ~SMs / b blocks and spreads the
//    units evenly (4 or 5 a block at the prefill: 132 blocks, one per SM).
//    Each unit's state S (n x kSlice f32) stays on chip for the whole
//    sweep: in the registers of the warps that update it, and in shared
//    memory for C.S.
// 3. Loads overlapped.  Each chunk's C, B^T, Gram, x slices and scalars
//    are copied with cp.async (16 bytes a copy; tokens past s zero-filled)
//    into the other half of a double buffer while the block works on the
//    chunk before.  A chunk has one block barrier (its data has landed)
//    and one per unit (C.S has read S before the update writes it).
// Shapes too large for two stages run one (the copies then wait at the
// chunk's start); the launcher picks the units and stages that fit in
// 227 KB, so every (p, n, chunk) the FMA kernel took still runs.  Chunk
// and state 64 (Zamba2's) are compiled with fixed loop counts.
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
using ssd::mma3;
using ssd::split;

constexpr int kSlice = 16;  // columns of x, y and S per work unit
// units (4 warps each) per block: 5 x 16 columns cover the prefill's 640
// units on 132 SMs in one wave
constexpr int kMaxUnits = kSlice == 16 ? 5 : 3;
constexpr int kUnitThreads = 128;
constexpr int kPrepThreads = 256;
constexpr long long kSmemMax = 232448;  // bytes of shared memory a block may use

struct Params {
  const float* x;    // (b, s, h, p)
  const float* a;    // (b, s, h)  log decay
  const float* dt;   // (b, s, h)  input scale
  const float* B;    // (b, s, n)
  const float* C;    // (b, s, n)
  float* y;          // (b, s, h, p)
  float* gram;       // (b, chunks, Q, Q + 4): the causal Gram of each chunk
  float* bt;         // (b, chunks, n, Q + 4): B of each chunk, transposed
  float* scal;       // (b, chunks, h, 4, Q): ai, dtb, wj, ec of each chunk and head
  int b, s, h, p, n, Q;
  int slices;        // ceil(p / kSlice) column slices per head
  int units;         // units per batch row: h * slices
  int per_b;         // blocks' tasks per batch row
  int tasks;         // b * per_b
  int umax;          // unit slots per block (blockDim.x / 128)
  int stages;        // 2: the next chunk loads while this one runs; 1: not
  float* states;     // (b, chunks, h, n, p): the state entering each chunk
                     // (the state-writing entry only; last, so the serving
                     // kernel's parameters keep their offsets)
};

// Shared memory of the scan, in floats.  Rows read as A fragments
// (g * ld + tig) have a pitch of 4 mod 32, rows read as B fragments
// (tig * ld + g) 8 mod 32, so a warp's fragment loads hit 32 banks.
struct Smem {
  int kp, gp, xp;        // pitches of C (n + 4), B^T and the Gram (Q + 4), x and S
  int c, g, x, xu, stage;  // a stage: B^T [n][gp] at 0, C [Q][kp], the Gram [Q][gp],
                           // per unit x [Q][xp] and the scalars [4][Q]
  int s, total;          // per unit S [n][xp], after the stages
};

__host__ __device__ inline Smem smem_layout(int Q, int n, int units, int stages) {
  Smem m;
  m.kp = n + 4;
  m.gp = Q + 4;
  m.xp = kSlice + 8;
  m.c = n * m.gp;
  m.g = m.c + Q * m.kp;
  m.x = m.g + Q * m.gp;
  m.xu = Q * m.xp + 4 * Q;
  m.stage = m.x + units * m.xu;
  m.s = stages * m.stage;
  m.total = m.s + units * n * m.xp;
  return m;
}

// floats of the scratch's Gram and B^T parts (the scalars follow)
__host__ __device__ inline long long gram_floats(int b, int nch, int Q) {
  return (long long)b * nch * Q * (Q + 4);
}
__host__ __device__ inline long long bt_floats(int b, int nch, int Q, int n) {
  return (long long)b * nch * n * (Q + 4);
}

__device__ __forceinline__ void unit_barrier(int unit) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(unit + 1), "r"(kUnitThreads) : "memory");
}

// ---------------------------------------------------------------- pre-pass
// One block per (chunk, batch row): the chunk's causal Gram
// G[i][j] = (j <= i) C_i.B_j in 16 x 8 tiles on or below the diagonal
// (3xTF32, spread over the warps), and, one warp per head, the cumulative
// decays and their scalars ai = exp(clip(cum - c)), dtb = dt exp(clip(c -
// cum)), wj = exp(total - cum) dt and ec = exp(cum) (ec[Q-1] = exp(total)).
template <int QN>
__global__ void __launch_bounds__(kPrepThreads) mamba_ssd_prep(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = QN ? QN : p.Q, N = QN ? QN : p.n, R = Q / 16, KP = N + 4, GP = Q + 4;
  const int ch = blockIdx.x, bb = blockIdx.y, nch = gridDim.x, t0 = ch * Q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = kPrepThreads / 32;
  const int g = lane >> 2, t = lane & 3;
  float* bs = sm;
  float* cs = sm + Q * KP;
  if (lane < N / 4)
    for (int r = warp; r < 2 * Q; r += nwarps) {
      const int which = r >= Q, rr = r - which * Q, tok = t0 + rr;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // tokens past s: the reference's padding
      if (tok < p.s)
        v = *reinterpret_cast<const float4*>((which ? p.C : p.B) +
                                             ((long long)bb * p.s + tok) * N + 4 * lane);
      *reinterpret_cast<float4*>((which ? cs : bs) + rr * KP + 4 * lane) = v;
    }
  __syncthreads();
  float* btout = p.bt + ((long long)bb * nch + ch) * N * GP;
  for (int i = threadIdx.x; i < N * Q; i += kPrepThreads)
    btout[i / Q * GP + i % Q] = bs[i % Q * KP + i / Q];
  float* gout = p.gram + ((long long)bb * nch + ch) * Q * GP;
  for (int tile = warp; tile < R * (R + 1); tile += nwarps) {
    int rt = 0;
    while ((rt + 1) * (rt + 2) <= tile) ++rt;
    const int ct = tile - rt * (rt + 1);
    float acc[2][2][4] = {};  // even and odd k steps, each big and small
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        load_a(cs, KP, rt * 16, k0 + 8 * h2, g, t, ah, al);
        const float* pb = bs + (ct * 8 + g) * KP + k0 + 8 * h2 + t;  // (k, j) = B[j][k]
        split(pb[0], bh[0], bl[0]);
        split(pb[4], bh[1], bl[1]);
        mma3(acc[h2][0], acc[h2][1], ah, al, bh, bl);
      }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (acc[0][1][e] + acc[1][1][e]) + (acc[0][0][e] + acc[1][0][e]);
    const int i = rt * 16 + g, j = ct * 8 + 2 * t;
    *reinterpret_cast<float2*>(gout + i * GP + j) =
        make_float2(j <= i ? v[0] : 0.f, j + 1 <= i ? v[1] : 0.f);
    *reinterpret_cast<float2*>(gout + (i + 8) * GP + j) =
        make_float2(j <= i + 8 ? v[2] : 0.f, j + 1 <= i + 8 ? v[3] : 0.f);
  }
  // the decays: lane holds tokens j0 .. j0 + E - 1 of the chunk
  const int E = (Q + 31) / 32, j0 = lane * E;
  for (int hh = warp; hh < p.h; hh += nwarps) {
    float cum[4], dts[4];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = t0 + j0 + e;
      const bool in = e < E && j0 + e < Q && tok < p.s;
      const long long off = ((long long)bb * p.s + tok) * p.h + hh;
      run += in ? p.a[off] : 0.f;
      dts[e] = in ? p.dt[off] : 0.f;
      cum[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const float off = incl - run;
    float mx = -INFINITY, mn = INFINITY, last = 0.f;
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
    const float center = 0.5f * (mx + mn);
    const float total = __shfl_sync(0xffffffffu, last, (Q - 1) / E);
    float* so = p.scal + (((long long)bb * nch + ch) * p.h + hh) * 4 * Q;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < E && j0 + e < Q) {
        const int j = j0 + e;
        const float cj = cum[e];
        so[j] = expf(clip60(cj - center));
        so[Q + j] = dts[e] * expf(clip60(center - cj));
        so[2 * Q + j] = expf(total - cj) * dts[e];
        so[3 * Q + j] = expf(cj);
      }
  }
}

// ---------------------------------------------------------------- the scan
// QN: chunk and state size known when compiling (64, Zamba2's), or 0.
// kStates: also write the state entering each chunk (for the backward,
// mamba_ssd_bwd.cu); the serving instantiation has no such store.
template <int QN, bool kStates>
__global__ void __launch_bounds__(kMaxUnits * kUnitThreads) mamba_ssd_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  constexpr int PS = kSlice, NT = PS / 8;  // 8-column tiles of a slice
  const int Q = QN ? QN : p.Q, N = QN ? QN : p.n, R = Q / 16;
  const Smem L = smem_layout(Q, N, p.umax, p.stages);
  const int KP = L.kp, GP = L.gp, XP = L.xp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int unit = warp >> 2, uw = warp & 3, ut = tid & (kUnitThreads - 1);
  const int nch = (p.s + Q - 1) / Q;
  const long long xrow = (long long)p.h * p.p;  // floats of x / y per token
  float* ss = sm + L.s + unit * N * XP;         // this unit's S, f32
  float sreg[2][NT][4];  // S in the registers of the warp that updates its 16-row strips

  for (int task = blockIdx.x; task < p.tasks; task += gridDim.x) {
    const int bb = task / p.per_b, k = task % p.per_b;
    const int u0 = (int)((long long)k * p.units / p.per_b);
    const int nu = (int)((long long)(k + 1) * p.units / p.per_b) - u0;
    const bool active = unit < nu;
    int hh = 0, c0 = 0, nct = 0;
    if (active) {
      hh = (u0 + unit) / p.slices;
      c0 = (u0 + unit) % p.slices * PS;
      nct = min(PS, p.p - c0) / 8;
    }
    __syncthreads();  // the previous task is done with shared memory
    if (active) for (int i = ut; i < N * XP; i += kUnitThreads) ss[i] = 0.f;  // S = 0 for every (batch, head, slice)
#pragma unroll
    for (int j = 0; j < 2 * NT * 4; ++j) sreg[j / (4 * NT)][j / 4 % NT][j % 4] = 0.f;

    // copy chunk ch into stage st (16 bytes a copy, tokens past s zero: the
    // reference's padding): a warp copies rows of C; every thread a share
    // of the chunk's B^T and Gram; a unit's threads its x slice (xpr pieces
    // a row) and its head's scalars
    const int xpr = active ? 2 * nct : 1, xr0 = ut / xpr, xq4 = ut % xpr * 4;
    const float* xsrc = p.x + (long long)bb * p.s * xrow + (long long)hh * p.p + c0 + xq4;
    auto issue = [&](int ch, int st) {
      float* base = sm + st * L.stage;
      if (lane < N / 4)
        for (int r = warp; r < Q; r += nwarps) {
          const int tok = ch * Q + r;
          const float* src = p.C + ((long long)bb * p.s + min(tok, p.s - 1)) * N;
          cp_async16(base + L.c + r * KP + 4 * lane, src + 4 * lane, tok < p.s);
        }
      const float* btsrc = p.bt + ((long long)bb * nch + ch) * N * GP;
      for (int i = tid; i < N * GP / 4; i += blockDim.x)
        cp_async16(base + 4 * i, btsrc + 4 * i, true);
      const float* gsrc = p.gram + ((long long)bb * nch + ch) * Q * GP;
      for (int i = tid; i < Q * GP / 4; i += blockDim.x)
        cp_async16(base + L.g + 4 * i, gsrc + 4 * i, true);
      if (active) {
        float* xb = base + L.x + unit * L.xu;
        for (int r = xr0; r < Q; r += kUnitThreads / xpr) {
          const int tok = ch * Q + r;
          cp_async16(xb + r * XP + xq4, xsrc + min(tok, p.s - 1) * xrow, tok < p.s);
        }
        const float* ssrc = p.scal + (((long long)bb * nch + ch) * p.h + hh) * 4 * Q;
        for (int i = ut; i < Q; i += kUnitThreads) cp_async16(xb + Q * XP + 4 * i, ssrc + 4 * i, true);
      }
      cp_async_commit();
    };

    if (p.stages == 2) issue(0, 0);
    for (int ch = 0; ch < nch; ++ch) {
      if (p.stages == 1) {
        __syncthreads();  // the previous chunk's readers are done
        issue(ch, 0);
      }
      cp_async_wait_all();
      __syncthreads();  // chunk ch has landed; chunk ch - 1 is done everywhere
      if (p.stages == 2 && ch + 1 < nch) issue(ch + 1, (ch + 1) & 1);
      if (!active) continue;
      const float* stg = sm + (p.stages == 2 ? ch & 1 : 0) * L.stage;
      const float* bts = stg;
      const float* cs = stg + L.c;
      const float* gs = stg + L.g;
      const float* xs = stg + L.x + unit * L.xu;
      const float* ai = xs + Q * XP;
      const float* dtb = ai + Q;
      const float* wj = ai + 2 * Q;
      const float* ec = ai + 3 * Q;
      const float et = ec[Q - 1];  // exp(total)

      // -------- y = ai * (G dtb) x + ec * C S, one 16-row strip per warp
      for (int rt = uw; rt < R; rt += 4) {
        const int r0 = rt * 16, kg = r0 + 16;  // gs[i][j] = 0 for j > i: G.x stops at kg
        float yi[2][NT][4] = {}, ys[2][NT][4] = {};  // [0] hi.hi, [1] the lo terms
#pragma unroll
        for (int k0 = 0; k0 < (Q == N ? N : max(kg, N)); k0 += 8) {  // G.x and C.S interleaved
          if (k0 < kg) {
            uint32_t ah[4], al[4];
            float v[4];
            ldsm_a(gs, GP, r0, k0, lane, v);
            const float d0 = dtb[k0 + t], d1 = dtb[k0 + t + 4];
            split(v[0] * d0, ah[0], al[0]);
            split(v[1] * d0, ah[1], al[1]);
            split(v[2] * d1, ah[2], al[2]);
            split(v[3] * d1, ah[3], al[3]);
#pragma unroll
            for (int c = 0; c < NT; ++c)
              if (c < nct) {
                uint32_t bh[2], bl[2];
                load_b(xs, XP, k0, c * 8, g, t, bh, bl);
                mma3(yi[0][c], yi[1][c], ah, al, bh, bl);
              }
          }
          if (k0 < N) {
            uint32_t ah[4], al[4];
            float v[4];
            ldsm_a(cs, KP, r0, k0, lane, v);
#pragma unroll
            for (int e = 0; e < 4; ++e) split(v[e], ah[e], al[e]);
#pragma unroll
            for (int c = 0; c < NT; ++c)
              if (c < nct) {
                uint32_t bh[2], bl[2];
                load_b(ss, XP, k0, c * 8, g, t, bh, bl);
                mma3(ys[0][c], ys[1][c], ah, al, bh, bl);
              }
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r0 + g + 8 * half, tok = ch * Q + i;
          if (tok < p.s) {
            const float A_ = ai[i], E_ = ec[i];
            float* yrow = p.y + ((long long)bb * p.s + tok) * xrow + (long long)hh * p.p + c0;
#pragma unroll
            for (int c = 0; c < NT; ++c)
              if (c < nct)
                *reinterpret_cast<float2*>(yrow + c * 8 + 2 * t) = make_float2(
                    A_ * (yi[1][c][2 * half] + yi[0][c][2 * half]) +
                        E_ * (ys[1][c][2 * half] + ys[0][c][2 * half]),
                    A_ * (yi[1][c][2 * half + 1] + yi[0][c][2 * half + 1]) +
                        E_ * (ys[1][c][2 * half + 1] + ys[0][c][2 * half + 1]));
          }
        }
      }
      if constexpr (kStates) {  // the state entering chunk ch, from shared memory
        const int w = nct * 8;
        float* so = p.states + (((long long)bb * nch + ch) * p.h + hh) * N * p.p + c0;
        for (int i = ut; i < N * w; i += kUnitThreads)
          so[(long long)(i / w) * p.p + i % w] = ss[i / w * XP + i % w];
      }
      unit_barrier(unit);  // every strip has read S

      // -------- S = exp(total) S + B^T (wj x), f32 in the registers of the warp
      // that owns its 16-row strip, and in shared memory for the next C.S
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n0 = (uw + 4 * j) * 16;
        if (n0 >= N) break;
        float acc[2][NT][4] = {};  // [0] hi.hi, [1] the lo terms
#pragma unroll
        for (int k0 = 0; k0 < Q; k0 += 8) {
          uint32_t ah[4], al[4];
          float v[4];
          ldsm_a(bts, GP, n0, k0, lane, v);  // (n, j) = B^T[n][j]
#pragma unroll
          for (int e = 0; e < 4; ++e) split(v[e], ah[e], al[e]);
          const float w0 = wj[k0 + t], w1 = wj[k0 + t + 4];
#pragma unroll
          for (int c = 0; c < NT; ++c)
            if (c < nct) {
              uint32_t bh[2], bl[2];
              const float* px = xs + (k0 + t) * XP + c * 8 + g;
              split(px[0] * w0, bh[0], bl[0]);
              split(px[4 * XP] * w1, bh[1], bl[1]);
              mma3(acc[0][c], acc[1][c], ah, al, bh, bl);
            }
        }
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          if (c >= nct) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sreg[j][c][e] = et * sreg[j][c][e] + (acc[1][c][e] + acc[0][c][e]);
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(ss + (n0 + g + 8 * half) * XP + c * 8 + 2 * t) =
                make_float2(sreg[j][c][2 * half], sreg[j][c][2 * half + 1]);
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

bool shape_ok(int v) { return v >= 16 && v <= 128 && v % 16 == 0; }

}  // namespace

// Bytes of the scratch buffer mamba_ssd_fwd needs: each chunk's Gram and
// B^T and, per head, its scalars.
extern "C" long long mamba_ssd_scratch_bytes(int b, int s, int h, int n, int chunk) {
  if (chunk < 1) return 0;
  const int nch = (s + chunk - 1) / chunk;
  return 4 * (gram_floats(b, nch, chunk) + bt_floats(b, nch, chunk, n) +
              (long long)b * nch * h * 4 * chunk);
}

namespace {

int launch(const void* x, const void* a, const void* dt, const void* B, const void* C, void* y,
           void* scratch, float* states, int b, int s, int h, int p, int n, int chunk,
           void* stream) {
  if (!shape_ok(p) || !shape_ok(n) || !shape_ok(chunk) || b < 1 || s < 1 || h < 1) return -1;
  const bool fixed = chunk == 64 && n == 64;
  auto prep = fixed ? mamba_ssd_prep<64> : mamba_ssd_prep<0>;
  auto kernel = states ? (fixed ? mamba_ssd_kernel<64, true> : mamba_ssd_kernel<0, true>)
                       : (fixed ? mamba_ssd_kernel<64, false> : mamba_ssd_kernel<0, false>);
  const int nch = (s + chunk - 1) / chunk;
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<float*>(y),
             static_cast<float*>(scratch),
             static_cast<float*>(scratch) + gram_floats(b, nch, chunk),
             static_cast<float*>(scratch) + gram_floats(b, nch, chunk) + bt_floats(b, nch, chunk, n),
             b, s, h, p, n, chunk};
  prm.states = states;
  prm.slices = (p + kSlice - 1) / kSlice;
  prm.units = h * prm.slices;
  // each batch row gets its share of the SMs, the units spread evenly over
  // its blocks; a block takes at most as many units, double-buffered if
  // that fits, as its shared memory holds (more blocks with fewer units
  // each where it does not)
  const int sms = sm_count();
  const int share = std::min(prm.units, std::max(1, sms / b));
  const int want = std::min(kMaxUnits, (prm.units + share - 1) / share);
  int umax = 0;
  for (int u = want; u >= 1 && umax == 0; --u)
    for (int st = 2; st >= 1 && umax == 0; --st)
      if (smem_layout(chunk, n, u, st).total * 4LL <= kSmemMax) {
        umax = u;
        prm.stages = st;
      }
  if (umax == 0) return -1;
  prm.per_b = std::max((prm.units + umax - 1) / umax, share);
  prm.umax = (prm.units + prm.per_b - 1) / prm.per_b;
  prm.tasks = b * prm.per_b;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int prep_smem = 2 * chunk * (n + 4) * 4;
  cudaError_t e = cudaFuncSetAttribute(prep, cudaFuncAttributeMaxDynamicSharedMemorySize, prep_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  prep<<<dim3(nch, b), kPrepThreads, prep_smem, st>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int threads = prm.umax * kUnitThreads;
  const long long smem = smem_layout(chunk, n, prm.umax, prm.stages).total * 4LL;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long slots = (long long)std::max(per_sm, 1) * sms;
  const int grid = (int)std::min<long long>(prm.tasks, slots);
  kernel<<<grid, threads, smem, st>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors f32 and contiguous; scratch holds mamba_ssd_scratch_bytes.
// Returns cudaGetLastError() after the launches, or -1 for a shape this
// kernel does not take (p, n and chunk multiples of 16 in [16, 128]; one
// unit's shared memory within 227 KB).
extern "C" int mamba_ssd_fwd(const void* x, const void* a, const void* dt, const void* B,
                             const void* C, void* y, void* scratch, int b, int s, int h, int p,
                             int n, int chunk, void* stream) {
  return launch(x, a, dt, B, C, y, scratch, nullptr, b, s, h, p, n, chunk, stream);
}

// mamba_ssd_fwd that also writes the state entering each chunk into
// states, f32 (b, ceil(s / chunk), h, n, p) contiguous: what the backward
// (mamba_ssd_bwd.cu) reads.
extern "C" int mamba_ssd_fwd_states(const void* x, const void* a, const void* dt, const void* B,
                                    const void* C, void* y, void* scratch, void* states, int b,
                                    int s, int h, int p, int n, int chunk, void* stream) {
  return launch(x, a, dt, B, C, y, scratch, static_cast<float*>(states), b, s, h, p, n, chunk,
                stream);
}

extern "C" const char* mamba_ssd_error_string(int code) {
  if (code < 0) return "unsupported shape (p, n, chunk multiples of 16 in [16, 128]; "
                       "shared memory within 227 KB)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
