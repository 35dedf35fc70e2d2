// Flash attention backward in f32 (the gradient of flash_attention.cu's f32
// function) for Hopper, sm_90a: a plain FMA kernel at head dims 32, 64, 80
// and 128.  f32 serves the reduced configs that the training CLI trains
// (head dim 32) and the checks, not serving: ops.py routes f32 here
// (ops.bwd_kernel), bf16 to flash_attention_bwd_sm90.cu.
//
// Replaces: no Pallas kernel.  The reference trains through XLA's gradient
// of the jnp attention_chunked (src/repro/models/attention.py:81); the
// port's forward runs on flash_attention.cu, whose output autograd cannot
// see through, so this file is its gradient (kernels/ops.py:
// FlashAttention).
//
// Same function as kernels/ref.py: flash_attention_bwd_ref.  With scores
// s = q.k / sqrt(D) under the forward's masks (flash_common.cuh: attend;
// int32-max marks a padded key), P = softmax(s) (zero on a row that attends
// no key), Delta_i = sum_d dO_id O_id from the forward's output O,
// dP = dO V^T and dS = P o (dP - Delta):
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),  dV = P^T dO,
// dK and dV summed over the G query heads of a kv head's group (GQA).  P is
// exp2(s log2(e) / sqrt(D) - lse) with the log-sum-exp that
// flash_attention.cu's f32 kernel wrote (kernels/ref.py:
// flash_attention_lse_ref's units); no launch here computes it again.
//
// Design.  Deterministic, with no atomics on a result: every output element
// is summed by one thread in a fixed order.  As the f32 forward, four
// threads own a row (a query or a key), each D/4 of its dims interleaved by
// 4, so a quad reads 64 contiguous bytes and a dot product ends in two quad
// shuffles.  Three launches on the stream, 128 threads a block:
//   1. bwd_f32_prep, a block per (batch, head, 32 queries): each row's
//      Delta, into an f32 workspace.
//   2. bwd_f32_dkdv, a block per (batch, kv head, 32 keys): dK and dV of its
//      keys stay in registers while the block walks the G heads of the group
//      in order and, for each, the 32-query tiles that hold an attendable
//      pair with its keys (flash_common.cuh: live_q_tiles), Q and dO staged
//      in shared memory, P^T and dS^T recomputed a query at a time.
//   3. bwd_f32_dq, a block per (batch, head, 32 queries): dQ in registers
//      over the live 32-key tiles (flash_common.cuh: live_tiles), K and V
//      staged in shared memory.
//
// What bounds it.  Its products: 2.5 times the forward's over the attended
// pairs, on the f32 FMA units (67 TFLOP/s), far above the card's ~20 f32
// operations per byte at a training length.  It is not tuned: f32 is for
// the reduced configs and the checks.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "flash_common.cuh"

namespace {

using flash::attend;
using flash::kLog2e;
using flash::kPadPos;

constexpr int kThreads = 128;  // 4 threads a row, 32 rows a block
constexpr int kRows = 32;      // queries of a prep / dq block, keys of a dkdv block
constexpr int kTile = 32;      // queries (dkdv) or keys (dq) of a staged tile

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const int* qpos;
  const int* kvpos;
  const float* lse;  // [B][H][Sq] from the forward (kernels/ref.py: flash_attention_lse_ref)
  float* delta;      // [B][H][Sq]
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Skv, H, KV;
  long long qpos_bs, kvpos_bs;  // batch strides of the position arrays
  int causal, window;
  float scale;
};

inline int list_bytes(int n, int tile) { return ((n + tile - 1) / tile + 3) * 4; }

// This thread's D/4 dims of row ``row`` (a global or shared row pointer):
// float4 group i holds dims 16 i + 4 j .. 16 i + 4 j + 3.
template <int D>
__device__ __forceinline__ void load_row(float (&r)[D / 4], const float* row, int j, bool ok) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) x = *reinterpret_cast<const float4*>(row + 16 * i + 4 * j);
    r[4 * i] = x.x;
    r[4 * i + 1] = x.y;
    r[4 * i + 2] = x.z;
    r[4 * i + 3] = x.w;
  }
}

// The full dot product of a quad's row with ``row`` (shared memory), in
// every lane of the quad.
template <int D>
__device__ __forceinline__ float quad_dot(const float (&a)[D / 4], const float* row, int j) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 16 * i + 4 * j);
    part += a[4 * i] * x.x + a[4 * i + 1] * x.y + a[4 * i + 2] * x.z + a[4 * i + 3] * x.w;
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// acc += c * row (shared memory), this thread's dims
template <int D>
__device__ __forceinline__ void axpy(float (&acc)[D / 4], float c, const float* row, int j) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 16 * i + 4 * j);
    acc[4 * i] = fmaf(c, x.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(c, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(c, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(c, x.w, acc[4 * i + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* row, const float (&r)[D / 4], float c, int j) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
    *reinterpret_cast<float4*>(row + 16 * i + 4 * j) =
        make_float4(r[4 * i] * c, r[4 * i + 1] * c, r[4 * i + 2] * c, r[4 * i + 3] * c);
}

// Stage rows r0 .. r0 + kTile - 1 of two [rows][rs] arrays (zero past n)
// into shared tiles [kTile][D].
template <int D>
__device__ __forceinline__ void stage(float (*a)[D], float (*b)[D], const float* ga,
                                      const float* gb, long long rs, int r0, int n, int tid) {
  for (int i = tid; i < kTile * D / 4; i += kThreads) {
    const int row = i / (D / 4), cc = (i % (D / 4)) * 4, r = r0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r < n) {
      x = *reinterpret_cast<const float4*>(ga + r * rs + cc);
      y = *reinterpret_cast<const float4*>(gb + r * rs + cc);
    }
    *reinterpret_cast<float4*>(&a[row][cc]) = x;
    *reinterpret_cast<float4*>(&b[row][cc]) = y;
  }
}

// --------------------------------------------------------------- 1. prep
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_f32_prep(Params p) {
  const int tid = threadIdx.x, row = tid >> 2, j = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qrs = (long long)p.H * D;
  const long long qoff = (long long)b * p.Sq * qrs + (long long)h * D;
  const int r = blockIdx.x * kRows + row;
  const bool ok = r < p.Sq;
  float o[D / 4], d[D / 4];
  load_row<D>(o, p.o + qoff + r * qrs, j, ok);
  load_row<D>(d, p.dout + qoff + r * qrs, j, ok);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) part = fmaf(o[i], d[i], part);
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  if (ok && j == 0) p.delta[((long long)b * p.H + h) * p.Sq + r] = part;
}

// ------------------------------------------------------------ 2. dK, dV
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_f32_dkdv(Params p) {
  __shared__ __align__(16) float Qs[kTile][D];
  __shared__ __align__(16) float dOs[kTile][D];
  __shared__ int qp_s[kTile];
  __shared__ float lse_s[kTile], dl_s[kTile];
  extern __shared__ int live[];  // [q tiles + 3]

  const int tid = threadIdx.x, row = tid >> 2, j = tid & 3;
  const int hk = blockIdx.y, b = blockIdx.z, G = p.H / p.KV;
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const long long kvoff = (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int k0 = blockIdx.x * kRows, kr = k0 + row;
  const bool ok_k = kr < p.Skv;
  const int kp = ok_k ? p.kvpos[b * p.kvpos_bs + kr] : kPadPos;
  const int* qpos = p.qpos + b * p.qpos_bs;

  float kf[D / 4], vf[D / 4], dk[D / 4], dv[D / 4];
  load_row<D>(kf, p.k + kvoff + kr * kvrs, j, ok_k);
  load_row<D>(vf, p.v + kvoff + kr * kvrs, j, ok_k);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = p.scale * kLog2e;

  const int nlive = flash::live_q_tiles<kTile, kRows, kThreads>(
      qpos, p.Sq, p.kvpos + b * p.kvpos_bs, k0, p.Skv, p.causal, p.window, live,
      live + (p.Sq + kTile - 1) / kTile);
  for (int hh = 0; hh < G; ++hh) {  // every head of the group, in order
    const int h = hk * G + hh;
    const long long off = (long long)b * p.Sq * qrs + (long long)h * D;
    for (int t = 0; t < nlive; ++t) {
      const int q0 = (live[t] >> 1) * kTile;
      __syncthreads();  // the previous tile is done with
      stage<D>(Qs, dOs, p.q + off, p.dout + off, qrs, q0, p.Sq, tid);
      if (tid < kTile) {
        const int r = q0 + tid;
        const long long rr = ((long long)b * p.H + h) * p.Sq + r;
        qp_s[tid] = r < p.Sq ? qpos[r] : 0;
        lse_s[tid] = r < p.Sq ? p.lse[rr] : INFINITY;  // P = 0 on a missing row
        dl_s[tid] = r < p.Sq ? p.delta[rr] : 0.f;
      }
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        const float s = quad_dot<D>(kf, Qs[i], j);
        const bool ok = attend(qp_s[i], kp, p.causal, p.window);
        const float pij = ok ? exp2f(fmaf(s, sl2, -lse_s[i])) : 0.f;
        axpy<D>(dv, pij, dOs[i], j);                     // dV += P^T dO
        const float dp = quad_dot<D>(vf, dOs[i], j);     // dP^T = V dO^T
        axpy<D>(dk, pij * (dp - dl_s[i]), Qs[i], j);     // dK += dS^T Q
      }
    }
  }
  if (ok_k) {
    store_row<D>(p.dk + kvoff + kr * kvrs, dk, p.scale, j);
    store_row<D>(p.dv + kvoff + kr * kvrs, dv, 1.f, j);
  }
}

// ------------------------------------------------------------------ 3. dQ
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_f32_dq(Params p) {
  __shared__ __align__(16) float Ks[kTile][D];
  __shared__ __align__(16) float Vs[kTile][D];
  __shared__ int kvp_s[kTile];
  extern __shared__ int live[];  // [key tiles + 3]

  const int tid = threadIdx.x, row = tid >> 2, j = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.KV);
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const long long qoff = (long long)b * p.Sq * qrs + (long long)h * D;
  const long long kvoff = (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int r = blockIdx.x * kRows + row;
  const bool ok_r = r < p.Sq;
  const int qp = ok_r ? p.qpos[b * p.qpos_bs + r] : 0;
  const long long rr = ((long long)b * p.H + h) * p.Sq + r;
  const float lse = ok_r ? p.lse[rr] : INFINITY, dl = ok_r ? p.delta[rr] : 0.f;

  float qf[D / 4], dof[D / 4], dq[D / 4];
  load_row<D>(qf, p.q + qoff + r * qrs, j, ok_r);
  load_row<D>(dof, p.dout + qoff + r * qrs, j, ok_r);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.f;
  const float sl2 = p.scale * kLog2e;

  const int ntiles = flash::live_tiles<kRows, kTile, kThreads>(
      p.qpos + b * p.qpos_bs, blockIdx.x * kRows, p.Sq, p.kvpos + b * p.kvpos_bs, p.Skv,
      p.causal, p.window, live, live + (p.Skv + kTile - 1) / kTile);
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = (live[t] >> 1) * kTile;
    __syncthreads();
    stage<D>(Ks, Vs, p.k + kvoff, p.v + kvoff, kvrs, n0, p.Skv, tid);
    if (tid < kTile) {
      const int n = n0 + tid;
      kvp_s[tid] = n < p.Skv ? p.kvpos[b * p.kvpos_bs + n] : kPadPos;
    }
    __syncthreads();
    for (int n = 0; n < kTile; ++n) {
      const float s = quad_dot<D>(qf, Ks[n], j);
      const float dp = quad_dot<D>(dof, Vs[n], j);
      const bool ok = attend(qp, kvp_s[n], p.causal, p.window);
      const float ds = ok ? exp2f(fmaf(s, sl2, -lse)) * (dp - dl) : 0.f;
      axpy<D>(dq, ds, Ks[n], j);                         // dQ += dS K
    }
  }
  if (ok_r) store_row<D>(p.dq + qoff + r * qrs, dq, p.scale, j);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p, cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_all(const Params& p, cudaStream_t st) {
  static_assert(D % 16 == 0, "float4 groups of 4 lanes x 4 dims");
  const dim3 qgrid((p.Sq + kRows - 1) / kRows, p.H, p.B);
  cudaError_t e = launch(bwd_f32_prep<D>, qgrid, 0, p, st);
  if (e != cudaSuccess) return e;
  e = launch(bwd_f32_dkdv<D>, dim3((p.Skv + kRows - 1) / kRows, p.KV, p.B),
             list_bytes(p.Sq, kTile), p, st);
  if (e != cudaSuccess) return e;
  return launch(bwd_f32_dq<D>, qgrid, list_bytes(p.Skv, kTile), p, st);
}

}  // namespace

// q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, KV, D); all f32 and
// contiguous, 16-byte aligned.  lse: the forward's f32 (B, H, Sq)
// log-sum-exp; delta: an f32 workspace of B * H * Sq.  Returns
// cudaGetLastError() after the launches, or -1 for a head dim this file has
// no kernel for.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* qpos,
                                       const void* kvpos, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                                       int D, long long qpos_bs, long long kvpos_bs, int causal,
                                       int window, void* stream) {
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(out),
           static_cast<const float*>(dout), static_cast<const int*>(qpos),
           static_cast<const int*>(kvpos), static_cast<const float*>(lse),
           static_cast<float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
           static_cast<float*>(dv), B, Sq, Skv, H, KV, qpos_bs, kvpos_bs, causal, window,
           1.0f / sqrtf((float)D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 32) e = launch_all<32>(p, st);
  else if (D == 64) e = launch_all<64>(p, st);
  else if (D == 80) e = launch_all<80>(p, st);
  else if (D == 128) e = launch_all<128>(p, st);
  else return -1;
  return static_cast<int>(e);
}

extern "C" const char* flash_attention_bwd_f32_error_string(int code) {
  if (code < 0) return "unsupported head dim (32, 64, 80 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
