// Position-aware latent reconstruction (paper Eqs. 15-17) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/latent_blend.py:latent_blend, the Pallas
// TPU kernel (grid (F blocks, K) with K innermost, accumulating the
// output tile across partitions in VMEM scratch).
//
// Same function: out[x, f] = sum_k W_k[x - s_k] * preds[k, x - s_k, f] / Z[x]
// over the partitions whose window [s_k, s_k + W) covers x, in f32: the
// serving path's latent and predictions are f32.  The sum runs over k in
// ascending order, each product and each sum rounded once (__fmul_rn,
// __fadd_rn: no FMA contraction), then __fdiv_rn by Z[x]: the order of
// the plain version, so the two agree bit for bit.
//
// What bounds it.  A few flops per element against (covering windows + 1)
// x 4 bytes moved: memory bandwidth.  At the serving path's T dim a row is
// covered by up to 4 windows, so a thread that waits on one load before it
// issues the next keeps a quarter of the bytes in flight that it could.
//
// Design.  Blocks of a GPU grid share no scratch, so the TPU's
// K-innermost accumulation becomes a loop in each thread.  A block's row
// x = blockIdx.y is fixed: at its start one warp writes the row's cover
// list to shared memory, each window k covering x at j = x - s_k in k
// order (a ballot over lanes k, so starts may repeat; at most kMaxK
// entries).  Then each thread owns 4 consecutive f (a float4; one f where
// F % 4 != 0, chosen by shape at launch) and, for up to 4 covering
// windows at a time, issues every window's 16-byte load (and its weight)
// before the first sum, so a thread has all its bytes in flight; the
// sums then run in k order, the quotient is stored as a float4.  No
// atomics: deterministic.  The cover list in shared memory keeps the
// window index out of registers (a list indexed by a loop variable from
// by-value parameters would go to local memory); 4 blocks of 256 threads
// an SM hold 64 KB of loads in flight each, with at most 64 registers.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kThreads = 256;

struct Starts {
  int s[kMaxK];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }

__device__ __forceinline__ void madd(float& acc, float p, float w) {
  acc = __fadd_rn(acc, __fmul_rn(p, w));
}
__device__ __forceinline__ void madd(float4& acc, const float4& p, float w) {
  madd(acc.x, p.x, w);
  madd(acc.y, p.y, w);
  madd(acc.z, p.z, w);
  madd(acc.w, p.w, w);
}

__device__ __forceinline__ float quotient(float a, float z) { return __fdiv_rn(a, z); }
__device__ __forceinline__ float4 quotient(const float4& a, float z) {
  return make_float4(__fdiv_rn(a.x, z), __fdiv_rn(a.y, z), __fdiv_rn(a.z, z), __fdiv_rn(a.w, z));
}

// acc += preds[row c] * weight c for the N covering windows of the list
// from c0, in list (= k) order: every load issued before the first sum.
template <int N, typename V>
__device__ __forceinline__ void sum_windows(V& acc, const float* __restrict__ preds,
                                            const float* __restrict__ w,
                                            const long long* row, const int* widx,
                                            long long i) {
  V p[N];
  float wt[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    p[c] = load(reinterpret_cast<const V*>(preds + row[c]) + i);
    wt[c] = __ldg(w + widx[c]);
  }
#pragma unroll
  for (int c = 0; c < N; ++c) madd(acc, p[c], wt[c]);
}

// grid (ceil(F / lanes(V) / kThreads), E); V is float4 when F % 4 == 0, else float.
template <typename V>
__global__ void __launch_bounds__(kThreads, 4) latent_blend_kernel(
    const float* __restrict__ preds, const float* __restrict__ w,
    const float* __restrict__ norm, float* __restrict__ out, Starts st, int K, int W,
    long long F) {
  __shared__ long long row[kMaxK];   // offset of preds[k, j, 0] of each covering window
  __shared__ int widx[kMaxK];        // k * W + j: its weight
  __shared__ int n_cover;
  const int x = blockIdx.y;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int s = 0;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)  // constant indices: no local copy of st
      if (k == lane) s = st.s[k];
    const int j = x - s;
    const bool covers = lane < K && j >= 0 && j < W;
    const unsigned ballot = __ballot_sync(0xffffffffu, covers);
    if (covers) {
      const int at = __popc(ballot & ((1u << lane) - 1u));  // k order
      row[at] = (static_cast<long long>(lane) * W + j) * F;
      widx[at] = lane * W + j;
    }
    if (lane == 0) n_cover = __popc(ballot);
  }
  __syncthreads();
  constexpr int kLanes = sizeof(V) / sizeof(float);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= F / kLanes) return;
  const int nc = n_cover;
  const float z = __ldg(norm + x);
  V acc{};
  int c = 0;
  for (; c + 4 <= nc; c += 4) sum_windows<4>(acc, preds, w, row + c, widx + c, i);
  switch (nc - c) {
    case 3: sum_windows<3>(acc, preds, w, row + c, widx + c, i); break;
    case 2: sum_windows<2>(acc, preds, w, row + c, widx + c, i); break;
    case 1: sum_windows<1>(acc, preds, w, row + c, widx + c, i); break;
    default: break;
  }
  __stcs(reinterpret_cast<V*>(out + static_cast<long long>(x) * F) + i, quotient(acc, z));
}

template <typename V>
cudaError_t launch(const float* preds, const float* w, const float* norm, float* out,
                   const Starts& st, int K, int W, int E, long long F, cudaStream_t s) {
  const long long n = F / static_cast<long long>(sizeof(V) / sizeof(float));
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), static_cast<unsigned>(E));
  latent_blend_kernel<V><<<grid, kThreads, 0, s>>>(preds, w, norm, out, st, K, W, F);
  return cudaGetLastError();
}

}  // namespace

// All arrays are float32; preds and out start on a 16-byte boundary.
// ``starts`` is a host array of K ints, passed to the kernel by value.
// Returns cudaGetLastError() after the launch, or -1 for arguments this
// file has no kernel for.
extern "C" int latent_blend_fwd(const void* preds, const void* weights,
                                const void* normalizer, void* out, const int* starts,
                                int K, int W, int E, long long F, void* stream) {
  if (K < 1 || K > kMaxK || E < 1 || E > 65535 || F < 1 ||
      (F + kThreads - 1) / kThreads > 0x7fffffffLL)
    return -1;
  Starts st{};
  for (int k = 0; k < K; ++k) st.s[k] = starts[k];
  const float* p = static_cast<const float*>(preds);
  const float* w = static_cast<const float*>(weights);
  const float* z = static_cast<const float*>(normalizer);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = F % 4 == 0 ? launch<float4>(p, w, z, o, st, K, W, E, F, s)
                                   : launch<float>(p, w, z, o, st, K, W, E, F, s);
  return static_cast<int>(e);
}

extern "C" const char* latent_blend_error_string(int code) {
  if (code < 0) return "unsupported partition count, extent or row length";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
