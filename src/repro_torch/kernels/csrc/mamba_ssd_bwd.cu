// Backward of the chunked Mamba2 / SSD scan (mamba_ssd.cu) for Hopper,
// sm_90a: f32 in and out, deterministic.
//
// Replaces no TPU kernel: the reference trains the hybrid LM through
// XLA's gradient of the jnp gated_linear_scan (src/repro/models/ssm.py),
// and its Pallas mamba_ssd (src/repro/kernels/mamba_ssd.py) has no
// backward.  It is the gradient of kernels/ref.py:ssd_scan(factorized=
// True) for ssm_groups == 1, in the formulas of ref.ssd_scan_bwd: per
// (batch, head) and chunk, with ai = exp(clip(cum - c)), bj = exp(clip(c -
// cum)), u = dt bj, w = exp(total - cum), z = w dt, ec = exp(cum), G the
// causal C.B^T, S the state entering the chunk (written by the forward's
// state-writing entry, mamba_ssd_fwd_states) and dS the gradient of the
// state leaving it,
//   P = G^T (ai dy),  R = B dS,  dx = u P + z R
//   dG = (ai dy)(u x)^T on j <= i
//   dC_h = dG B + ec (dy S^T),  dB_h = dG^T C + z (x dS^T)
//   dS <- exp(total) dS + C^T (ec dy)        (a sweep over the chunks in reverse)
// then the scalars' chain: dt from u and z; cum from ai and bj (zero where
// the +-60 clip bites), w, ec, exp(total) and the centre (max + min) / 2,
// whose gradient goes to the tied maxima and minima in equal shares; and
// dlog_decay the reverse cumulative sum of dcum in the chunk.  Tokens past
// s are the reference's zero padding and take no gradient.
//
// What bounds it.  At Zamba2's training shape (b 2, s 2048, h 80, p = n =
// chunk = 64) the backward must read x, dy and the states and write dx
// (84 MB each in f32), with the decays, B, C and their gradients small:
// ~340 MB, 0.10 ms at 3.35 TB/s.  Its products are ~2x the forward's
// multiply-adds.  So bytes bound it.
//
// Design: the simple kernel first.  One block of 256 threads per (head,
// batch row) sweeps the chunks in reverse with dS in shared memory; every
// product is an f32 FMA loop over shared-memory tiles (4 x 4 outputs a
// thread, strided so neighbouring threads read neighbouring words; odd
// pitches keep strided reads on distinct banks).  No tensor cores, so no
// TF32 split.  Determinism: dx, dt and dlog_decay belong to one block;
// dB and dC sum over the heads, so each block writes its head's share
// into a scratch buffer (b, h, s, n) and a second kernel sums the heads in
// order.  No atomics.  Shapes (p, n, chunk multiples of 16 up to 128)
// whose tiles do not fit 227 KB of shared memory are refused (Zamba2's
// 64 / 64 / 64 takes 155 KB).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemMax = 232448;  // bytes of shared memory a block may use
constexpr float kClip = 60.0f;
constexpr int kScalars = 16;            // per-token arrays of a chunk

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
  float* dBp;           // (b, h, s, n): each head's share of dB
  float* dCp;           // (b, h, s, n): each head's share of dC
  int b, s, h, p, n, Q, nch;
};

// Shared memory of a block, in floats: x and dy [Q][p + 1], B and C
// [Q][n + 1], S and dS [n][p + 1], G (then dG) [Q][Q + 1], two products
// [Q][max(p, n) + 1], the per-token scalars and a reduction buffer.
struct Smem {
  int xp, np, qp, tp;
  int x, dy, B, C, S, dS, G, t1, t2, sc, red, total;
};

__host__ __device__ inline Smem smem_layout(int Q, int n, int p) {
  Smem m;
  m.xp = p + 1;
  m.np = n + 1;
  m.qp = Q + 1;
  m.tp = (p > n ? p : n) + 1;
  m.x = 0;
  m.dy = m.x + Q * m.xp;
  m.B = m.dy + Q * m.xp;
  m.C = m.B + Q * m.np;
  m.S = m.C + Q * m.np;
  m.dS = m.S + n * m.xp;
  m.G = m.dS + n * m.xp;
  m.t1 = m.G + Q * m.qp;
  m.t2 = m.t1 + Q * m.tp;
  m.sc = m.t2 + Q * m.tp;
  m.red = m.sc + kScalars * Q;
  m.total = m.red + kThreads + 8;
  return m;
}

__device__ __forceinline__ float clip60(float v) { return fminf(fmaxf(v, -kClip), kClip); }

// 1 where clip60 passes its argument's gradient (torch.clamp's inclusive range)
__device__ __forceinline__ float in_clip(float v) { return (v >= -kClip && v <= kClip) ? 1.f : 0.f; }

// out(i, j) = sum_k A(i, k) ks[k] Bm(k, j) for i < M, j < N (ks null: 1),
// with A(i, k) = A[i sai + k sak] and Bm(k, j) = Bm[k sbk + j sbj] in
// shared memory; epi(i, j, value) takes each result.  A thread computes
// rows ti + r M/4 and columns tj + c N/4 (r, c < 4).
template <typename Epi>
__device__ __forceinline__ void mm(int M, int N, int K, const float* A, int sai, int sak,
                                   const float* Bm, int sbk, int sbj, const float* ks, Epi epi) {
  const int mt = M / 4, nt = N / 4;
  for (int tile = threadIdx.x; tile < mt * nt; tile += blockDim.x) {
    const int ti = tile / nt, tj = tile % nt;
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      const float sk = ks ? ks[k] : 1.f;
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = A[(ti + r * mt) * sai + k * sak] * sk;
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bm[k * sbk + (tj + c * nt) * sbj];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) epi(ti + r * mt, tj + c * nt, acc[r][c]);
  }
}

__global__ void __launch_bounds__(kThreads) mamba_ssd_bwd_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, N = p.n, PD = p.p, H = p.h, s = p.s;
  const Smem L = smem_layout(Q, N, PD);
  const int XP = L.xp, NP = L.np, QP = L.qp, TP = L.tp;
  float* xs = sm + L.x;
  float* dys = sm + L.dy;
  float* bs = sm + L.B;
  float* cs = sm + L.C;
  float* ss = sm + L.S;
  float* dss = sm + L.dS;
  float* gs = sm + L.G;
  float* t1 = sm + L.t1;
  float* t2 = sm + L.t2;
  float* cum = sm + L.sc;
  float* ai = cum + Q;
  float* bj = cum + 2 * Q;
  float* ec = cum + 3 * Q;
  float* w = cum + 4 * Q;
  float* u = cum + 5 * Q;
  float* z = cum + 6 * Q;
  float* dts = cum + 7 * Q;
  float* ma = cum + 8 * Q;
  float* mb = cum + 9 * Q;
  float* dai = cum + 10 * Q;
  float* dec = cum + 11 * Q;
  float* du = cum + 12 * Q;
  float* dz = cum + 13 * Q;
  float* tw = cum + 14 * Q;
  float* dcum = cum + 15 * Q;
  float* red = sm + L.red;
  const int tid = threadIdx.x, hh = blockIdx.x, bb = blockIdx.y;
  const long long xrow = (long long)H * PD;  // floats of x / dy per token
  float* dBp = p.dBp + ((long long)bb * H + hh) * s * N;
  float* dCp = p.dCp + ((long long)bb * H + hh) * s * N;

  for (int i = tid; i < N * XP; i += kThreads) dss[i] = 0.f;  // nothing leaves the last chunk
  for (int k = 0; k < p.nch; ++k) {
    const int ch = p.nch - 1 - k;  // the sweep runs backwards
    const int t0 = ch * Q;
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < Q * PD; i += kThreads) {
      const int r = i / PD, c = i % PD, tok = t0 + r;
      const long long off = ((long long)bb * s + tok) * xrow + (long long)hh * PD + c;
      xs[r * XP + c] = tok < s ? p.x[off] : 0.f;
      dys[r * XP + c] = tok < s ? p.dy[off] : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, c = i % N, tok = t0 + r;
      const long long off = ((long long)bb * s + tok) * N + c;
      bs[r * NP + c] = tok < s ? p.B[off] : 0.f;
      cs[r * NP + c] = tok < s ? p.C[off] : 0.f;
    }
    const float* sg = p.states + (((long long)bb * p.nch + ch) * H + hh) * N * PD;
    for (int i = tid; i < N * PD; i += kThreads) ss[i / PD * XP + i % PD] = sg[i];
    for (int i = tid; i < Q; i += kThreads) {
      const int tok = t0 + i;
      const long long off = ((long long)bb * s + tok) * H + hh;
      cum[i] = tok < s ? p.a[off] : 0.f;  // the log decays, summed below
      dts[i] = tok < s ? p.dt[off] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // the in-chunk cumulative sum, its max, min and their ties
      float run = 0.f, mx = -INFINITY, mn = INFINITY;
      for (int i = 0; i < Q; ++i) {
        run += cum[i];
        cum[i] = run;
        mx = fmaxf(mx, run);
        mn = fminf(mn, run);
      }
      int nmx = 0, nmn = 0;
      for (int i = 0; i < Q; ++i) {
        nmx += cum[i] == mx;
        nmn += cum[i] == mn;
      }
      red[kThreads] = 0.5f * (mx + mn);
      red[kThreads + 1] = mx;
      red[kThreads + 2] = mn;
      red[kThreads + 3] = 0.5f / nmx;
      red[kThreads + 4] = 0.5f / nmn;
    }
    __syncthreads();
    const float center = red[kThreads], mx = red[kThreads + 1], mn = red[kThreads + 2];
    const float total = cum[Q - 1], et = expf(total);
    for (int i = tid; i < Q; i += kThreads) {
      const float ci = cum[i], ea = ci - center, eb = center - ci;
      ai[i] = expf(clip60(ea));
      bj[i] = expf(clip60(eb));
      ma[i] = in_clip(ea);
      mb[i] = in_clip(eb);
      ec[i] = expf(ci);
      w[i] = expf(total - ci);
      u[i] = dts[i] * bj[i];
      z[i] = w[i] * dts[i];
      tw[i] = (ci == mx ? red[kThreads + 3] : 0.f) + (ci == mn ? red[kThreads + 4] : 0.f);
    }
    // G = C B^T on j <= i
    mm(Q, Q, N, cs, NP, 1, bs, 1, NP, nullptr,
       [&](int i, int j, float v) { gs[i * QP + j] = j <= i ? v : 0.f; });
    __syncthreads();
    // G (u x) and C S: dy . each gives d ai and d ec
    mm(Q, PD, Q, gs, QP, 1, xs, XP, 1, u, [&](int i, int c, float v) { t1[i * TP + c] = v; });
    mm(Q, PD, N, cs, NP, 1, ss, XP, 1, nullptr,
       [&](int i, int c, float v) { t2[i * TP + c] = v; });
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = 0; c < PD; ++c) {
        s1 = fmaf(dys[i * XP + c], t1[i * TP + c], s1);
        s2 = fmaf(dys[i * XP + c], t2[i * TP + c], s2);
      }
      dai[i] = s1;
      dec[i] = s2;
    }
    __syncthreads();
    // P = G^T (ai dy), R = B dS; dx = u P + z R
    mm(Q, PD, Q, gs, 1, QP, dys, XP, 1, ai, [&](int j, int c, float v) { t1[j * TP + c] = v; });
    mm(Q, PD, N, bs, NP, 1, dss, XP, 1, nullptr,
       [&](int j, int c, float v) { t2[j * TP + c] = v; });
    __syncthreads();
    for (int i = tid; i < Q * PD; i += kThreads) {
      const int r = i / PD, c = i % PD, tok = t0 + r;
      if (tok < s)
        p.dx[((long long)bb * s + tok) * xrow + (long long)hh * PD + c] =
            u[r] * t1[r * TP + c] + z[r] * t2[r * TP + c];
    }
    for (int j = tid; j < Q; j += kThreads) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = 0; c < PD; ++c) {
        s1 = fmaf(xs[j * XP + c], t1[j * TP + c], s1);
        s2 = fmaf(xs[j * XP + c], t2[j * TP + c], s2);
      }
      du[j] = s1;
      dz[j] = s2;
    }
    __syncthreads();
    // dG = ai_i u_j (dy_i . x_j) on j <= i, in place of G
    mm(Q, Q, PD, dys, XP, 1, xs, 1, XP, nullptr,
       [&](int i, int j, float v) { gs[i * QP + j] = j <= i ? ai[i] * u[j] * v : 0.f; });
    __syncthreads();
    // this head's dC = dG B + ec (dy S^T) and dB = dG^T C + z (x dS^T)
    mm(Q, N, Q, gs, QP, 1, bs, NP, 1, nullptr, [&](int i, int c, float v) { t1[i * TP + c] = v; });
    mm(Q, N, Q, gs, 1, QP, cs, NP, 1, nullptr, [&](int j, int c, float v) { t2[j * TP + c] = v; });
    __syncthreads();
    mm(Q, N, PD, dys, XP, 1, ss, 1, XP, nullptr, [&](int i, int c, float v) {
      if (t0 + i < s) dCp[(long long)(t0 + i) * N + c] = t1[i * TP + c] + ec[i] * v;
    });
    mm(Q, N, PD, xs, XP, 1, dss, 1, XP, nullptr, [&](int j, int c, float v) {
      if (t0 + j < s) dBp[(long long)(t0 + j) * N + c] = t2[j * TP + c] + z[j] * v;
    });
    // d exp(total) from the carried state: <dS, S>, summed in a fixed order
    float part = 0.f;
    for (int i = tid; i < N * PD; i += kThreads)
      part = fmaf(dss[i / PD * XP + i % PD], ss[i / PD * XP + i % PD], part);
    red[tid] = part;
    __syncthreads();  // every reader of dS above is done
    if (tid == 0) {
      float d = 0.f;
      for (int i = 0; i < kThreads; ++i) d += red[i];
      red[kThreads + 5] = d;
    }
    // dS <- exp(total) dS + C^T (ec dy): the gradient of the state entering the chunk
    mm(N, PD, Q, cs, 1, NP, dys, XP, 1, ec,
       [&](int i, int c, float v) { dss[i * XP + c] = et * dss[i * XP + c] + v; });
    // the scalars: dt, and cum through ai, bj, w and ec
    for (int j = tid; j < Q; j += kThreads) {
      const float dbj = dts[j] * du[j], dw = dts[j] * dz[j];
      const float ga = dai[j] * ai[j] * ma[j], gb = dbj * bj[j] * mb[j];
      if (t0 + j < s) p.ddt[((long long)bb * s + t0 + j) * H + hh] = bj[j] * du[j] + w[j] * dz[j];
      dcum[j] = ga - gb - dw * w[j] + dec[j] * ec[j];
      dai[j] = gb - ga;   // the centre's share
      dec[j] = dw * w[j];  // exp(total - cum)'s share of total
    }
    __syncthreads();
    if (tid == 0) {  // the centre and total, then dlog_decay = reverse cumsum of dcum
      float dcen = 0.f, dtot = 0.f;
      for (int j = 0; j < Q; ++j) {
        dcen += dai[j];
        dtot += dec[j];
      }
      dtot += red[kThreads + 5] * et;
      float run = 0.f;
      for (int j = Q - 1; j >= 0; --j) {
        float d = dcum[j] + (j == Q - 1 ? dtot : 0.f);
        d += dcen * tw[j];
        run += d;
        if (t0 + j < s) p.da[((long long)bb * s + t0 + j) * H + hh] = run;
      }
    }
  }
}

// dB and dC: each head's share summed over the heads in order (y 0: dB, 1: dC)
__global__ void __launch_bounds__(256) mamba_ssd_bwd_heads(const float* dBp, const float* dCp,
                                                          float* dB, float* dC, int b, int h,
                                                          long long sn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * sn) return;
  const float* part = blockIdx.y ? dCp : dBp;
  const long long bb = i / sn, e = i % sn;
  float acc = 0.f;
  for (int hh = 0; hh < h; ++hh) acc += part[(bb * h + hh) * sn + e];
  (blockIdx.y ? dC : dB)[i] = acc;
}

bool shape_ok(int v) { return v >= 16 && v <= 128 && v % 16 == 0; }

}  // namespace

// Bytes of the scratch buffer mamba_ssd_bwd needs: each head's share of dB
// and of dC, (b, h, s, n) f32 each.
extern "C" long long mamba_ssd_bwd_scratch_bytes(int b, int s, int h, int n) {
  return 2LL * 4 * b * h * (long long)s * n;
}

// Bytes of shared memory a block takes at (n, p, chunk); above 232448 the
// launcher refuses the shape.
extern "C" long long mamba_ssd_bwd_smem_bytes(int n, int p, int chunk) {
  return smem_layout(chunk, n, p).total * 4LL;
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
  const long long smem = smem_layout(chunk, n, p).total * 4LL;
  if (smem > kSmemMax) return -1;
  float* part = static_cast<float*>(scratch);
  const long long sn = (long long)s * n;
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<const float*>(dy),
             static_cast<const float*>(states), static_cast<float*>(dx),
             static_cast<float*>(da), static_cast<float*>(ddt), part,
             part + (long long)b * h * sn, b, s, h, p, n, chunk, (s + chunk - 1) / chunk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(mamba_ssd_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mamba_ssd_bwd_kernel<<<dim3(h, b), kThreads, smem, st>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = (long long)b * sn;
  mamba_ssd_bwd_heads<<<dim3((unsigned)((total + 255) / 256), 2), 256, 0, st>>>(
      prm.dBp, prm.dCp, static_cast<float*>(dB), static_cast<float*>(dC), b, h, sn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_ssd_bwd_error_string(int code) {
  if (code < 0) return "unsupported shape (p, n, chunk multiples of 16 in [16, 128] whose "
                       "tiles fit 227 KB of shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
