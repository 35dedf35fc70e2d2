// Chunked Mamba2 / SSD scan for Hopper, sm_90a, in f32.
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
// Design.  GPU blocks run in parallel and in no order, so the TPU's
// sequential chunk axis becomes a loop inside a block: a block owns one
// (batch, head) at a time (blocks stride over b*h items) and keeps S
// (n x p f32, 16 KB at 64 x 64) in shared memory across the whole chunk
// sweep; S never goes to device memory.  Per chunk the block stages x,
// B and C in shared memory (B and C also transposed, so every product
// below reads both operands as float4 rows), one warp scans the decays,
// and the three products (the masked Q x Q Gram C.B^T scaled by
// dt_j exp(c - cum_j); y from it and from C.S; the state update) run as
// 4 x 4 register tiles per thread.  The Gram is the same for every head
// (ssm_groups == 1) but is recomputed per head: it is 1/6 of the work.
//
// What bounds it.  At Zamba2's prefill (b 2, s 4096, h 80, p = n = 64,
// Q 64) the work is ~13.5 GFLOP of f32 FMA (~16 with the Gram recomputed
// per head) against ~0.35 GB of traffic (x and y f32, B, C, decays):
// ~40 operations per byte, above the f32 FMA units' ~20 per byte, so f32
// arithmetic bounds it.  This first
// version runs on the FMA units; tensor-core (tf32 / bf16 mma) products
// are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr float kClip = 60.0f;

struct Params {
  const float* x;    // (b, s, h, p)
  const float* a;    // (b, s, h)  log decay
  const float* dt;   // (b, s, h)  input scale
  const float* B;    // (b, s, n)
  const float* C;    // (b, s, n)
  float* y;          // (b, s, h, p)
  int b, s, h, p, n, Q;
};

__host__ __device__ constexpr int pad_q(int Q) { return Q + 4; }  // transposed row pitch

// floats of shared memory for one block
inline long long smem_floats(int Q, int p, int n) {
  const long long QP = pad_q(Q);
  return (long long)Q * p           // x
         + 2LL * n * QP             // B^T, C^T
         + (long long)Q * n         // B (scaled by w before the state update)
         + (long long)Q * Q         // masked, scaled Gram, transposed
         + (long long)n * p         // S
         + 7LL * Q + 4;             // per-token scalars, the centre
}

__device__ __forceinline__ float clip60(float v) { return fminf(fmaxf(v, -kClip), kClip); }

// acc[r][c] += sum_{k0 <= k < k1} A[k][m0 + r] * Bm[k][c0 + c]
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* A, int lda, int m0,
                                      const float* Bm, int ldb, int c0, int k0, int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(A + k * lda + m0);
    const float4 bv = *reinterpret_cast<const float4*>(Bm + k * ldb + c0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

__global__ void __launch_bounds__(kThreads) mamba_ssd_kernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int Q = p.Q, P = p.p, N = p.n, QP = pad_q(Q);
  float* xs = sm;                  // [Q][P]
  float* bts = xs + Q * P;         // [N][QP]  B^T
  float* cts = bts + N * QP;       // [N][QP]  C^T
  float* bs = cts + N * QP;        // [Q][N]   B, then w_j B_j
  float* gts = bs + Q * N;         // [Q][Q]   gts[j][i] = (j <= i) (C_i.B_j) dt_j b_j
  float* ss = gts + Q * Q;         // [N][P]   the state S
  float* cum = ss + N * P;         // [Q] cumulative log decay
  float* ai = cum + Q;             // [Q] exp(clip(cum_i - c))
  float* dtb = ai + Q;             // [Q] dt_j exp(clip(c - cum_j))
  float* wj = dtb + Q;             // [Q] exp(total - cum_j) dt_j
  float* ec = wj + Q;              // [Q] exp(cum_i)
  float* as = ec + Q;              // [Q] log decay
  float* dts = as + Q;             // [Q] dt
  float* ctr = dts + Q;            // [1] the centre

  const int tid = threadIdx.x;
  const int nchunks = (p.s + Q - 1) / Q;
  const long long trow = (long long)p.h * P;  // x / y stride of one token
  for (int item = blockIdx.x; item < p.b * p.h; item += gridDim.x) {
    const int bb = item / p.h, hh = item % p.h;
    __syncthreads();  // the previous item's last state update is done
    for (int i = tid; i < N * P; i += kThreads) ss[i] = 0.f;  // S = 0 for every (batch, head)

    for (int ch = 0; ch < nchunks; ++ch) {
      const int t0 = ch * Q;
      __syncthreads();  // the previous chunk's readers of x and B are done
      // -------- stage the chunk; tokens past s are zero (the reference's padding)
      for (int i = tid; i < Q * (P / 4); i += kThreads) {
        const int j = i / (P / 4), col = (i % (P / 4)) * 4, t = t0 + j;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < p.s)
          v = *reinterpret_cast<const float4*>(p.x + ((long long)bb * p.s + t) * trow +
                                               (long long)hh * P + col);
        *reinterpret_cast<float4*>(xs + j * P + col) = v;
      }
      for (int i = tid; i < Q * N; i += kThreads) {
        const int j = i / N, k = i % N, t = t0 + j;
        float bv = 0.f, cv = 0.f;
        if (t < p.s) {
          const long long off = ((long long)bb * p.s + t) * N + k;
          bv = p.B[off];
          cv = p.C[off];
        }
        bs[j * N + k] = bv;
        bts[k * QP + j] = bv;
        cts[k * QP + j] = cv;
      }
      for (int j = tid; j < Q; j += kThreads) {
        const int t = t0 + j;
        const long long off = ((long long)bb * p.s + t) * p.h + hh;
        as[j] = t < p.s ? p.a[off] : 0.f;
        dts[j] = t < p.s ? p.dt[off] : 0.f;
      }
      __syncthreads();

      // -------- cumulative decays and the centre (one warp)
      if (tid < 32) {
        const int E = (Q + 31) / 32, j0 = tid * E;
        float run = 0.f;
        for (int e = 0; e < E; ++e)
          if (j0 + e < Q) {
            run += as[j0 + e];
            cum[j0 + e] = run;
          }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, o);
          if (tid >= o) incl += v;
        }
        const float off = incl - run;
        float mx = -INFINITY, mn = INFINITY;
        for (int e = 0; e < E; ++e)
          if (j0 + e < Q) {
            const float v = cum[j0 + e] + off;
            cum[j0 + e] = v;
            mx = fmaxf(mx, v);
            mn = fminf(mn, v);
          }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        }
        if (tid == 0) ctr[0] = 0.5f * (mx + mn);
      }
      __syncthreads();
      const float center = ctr[0], total = cum[Q - 1];
      for (int j = tid; j < Q; j += kThreads) {
        const float cj = cum[j];
        ai[j] = expf(clip60(cj - center));
        dtb[j] = dts[j] * expf(clip60(center - cj));
        wj[j] = expf(total - cj) * dts[j];
        ec[j] = expf(cj);
      }
      __syncthreads();

      // -------- gts[j][i] = (j <= i) ? dtb_j * sum_k B[j][k] C[i][k] : 0
      for (int tile = tid; tile < (Q / 4) * (Q / 4); tile += kThreads) {
        const int j0 = (tile / (Q / 4)) * 4, i0 = (tile % (Q / 4)) * 4;
        float acc[4][4] = {};
        if (j0 <= i0 + 3) mm4x4(acc, bts, QP, j0, cts, QP, i0, 0, N);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + r;
          const float sc = dtb[j];
          float4 v;
          v.x = j <= i0 ? acc[r][0] * sc : 0.f;
          v.y = j <= i0 + 1 ? acc[r][1] * sc : 0.f;
          v.z = j <= i0 + 2 ? acc[r][2] * sc : 0.f;
          v.w = j <= i0 + 3 ? acc[r][3] * sc : 0.f;
          *reinterpret_cast<float4*>(gts + j * Q + i0) = v;
        }
      }
      __syncthreads();

      // -------- y = a_i * (G x)_i + exp(cum_i) * (C S)_i; then B_j *= w_j
      for (int tile = tid; tile < (Q / 4) * (P / 4); tile += kThreads) {
        const int i0 = (tile / (P / 4)) * 4, c0 = (tile % (P / 4)) * 4;
        float yi[4][4] = {}, ys[4][4] = {};
        mm4x4(yi, gts, Q, i0, xs, P, c0, 0, i0 + 4);  // gts[j][i] = 0 for j > i
        mm4x4(ys, cts, QP, i0, ss, P, c0, 0, N);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r, t = t0 + i;
          if (t < p.s) {
            const float A_ = ai[i], E_ = ec[i];
            float4 v;
            v.x = A_ * yi[r][0] + E_ * ys[r][0];
            v.y = A_ * yi[r][1] + E_ * ys[r][1];
            v.z = A_ * yi[r][2] + E_ * ys[r][2];
            v.w = A_ * yi[r][3] + E_ * ys[r][3];
            *reinterpret_cast<float4*>(p.y + ((long long)bb * p.s + t) * trow +
                                       (long long)hh * P + c0) = v;
          }
        }
      }
      for (int i = tid; i < Q * N; i += kThreads) bs[i] *= wj[i / N];
      __syncthreads();

      // -------- S = exp(total) S + sum_j (w_j B_j) (x) x_j
      const float et = expf(total);
      for (int tile = tid; tile < (N / 4) * (P / 4); tile += kThreads) {
        const int n0 = (tile / (P / 4)) * 4, c0 = (tile % (P / 4)) * 4;
        float acc[4][4] = {};
        mm4x4(acc, bs, N, n0, xs, P, c0, 0, Q);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* row = reinterpret_cast<float4*>(ss + (n0 + r) * P + c0);
          const float4 s0 = *row;
          *row = make_float4(et * s0.x + acc[r][0], et * s0.y + acc[r][1],
                             et * s0.z + acc[r][2], et * s0.w + acc[r][3]);
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

// All tensors f32 and contiguous.  Returns cudaGetLastError() after the
// launch, or -1 for a shape this kernel does not take (p, n and chunk
// multiples of 16 in [16, 128]; shared memory within 227 KB).
extern "C" int mamba_ssd_fwd(const void* x, const void* a, const void* dt, const void* B,
                             const void* C, void* y, int b, int s, int h, int p, int n,
                             int chunk, void* stream) {
  if (!shape_ok(p) || !shape_ok(n) || !shape_ok(chunk) || b < 1 || s < 1 || h < 1) return -1;
  const long long smem = smem_floats(chunk, p, n) * 4;
  if (smem > 232448) return -1;
  const cudaError_t e = cudaFuncSetAttribute(
      mamba_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params prm{static_cast<const float*>(x), static_cast<const float*>(a),
             static_cast<const float*>(dt), static_cast<const float*>(B),
             static_cast<const float*>(C), static_cast<float*>(y), b, s, h, p, n, chunk};
  const long long items = (long long)b * h;
  const int grid = (int)(items < 2LL * sm_count() ? items : 2LL * sm_count());
  mamba_ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mamba_ssd_error_string(int code) {
  if (code < 0) return "unsupported shape (p, n, chunk multiples of 16 in [16, 128]; "
                       "shared memory within 227 KB)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
