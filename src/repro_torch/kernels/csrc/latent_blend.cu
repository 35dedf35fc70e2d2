// Position-aware latent reconstruction (paper Eqs. 15-17) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/latent_blend.py:latent_blend, the Pallas
// TPU kernel (grid (F blocks, K) with K innermost, accumulating the
// output tile across partitions in VMEM scratch).
//
// Same function: out[x, f] = sum_k W_k[x - s_k] * preds[k, x - s_k, f] / Z[x]
// over the partitions whose window [s_k, s_k + W) covers x, in f32: the
// serving path's latent and predictions are f32.
//
// Design.  Blocks of a GPU grid run in parallel and share no scratch, so
// the TPU's K-innermost accumulation has no counterpart.  Instead each
// thread owns output elements (x, f): it loops over the K windows that
// cover x, accumulates in a register, divides by Z[x] and stores once.
// No atomics, so the result is deterministic; the products and sums use
// explicit round-to-nearest intrinsics (no FMA contraction) in the order
// of the plain version, so the two agree bit for bit in f32.
//
// What bounds it.  A few flops per element against K*W/E + 1 reads and
// one write of 4 bytes each: memory bandwidth.  Neighbouring threads
// take neighbouring f, so every read and the write are coalesced; each
// pred element is read exactly once.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;

struct Starts {
  int s[kMaxK];
};

// Grid row x = blockIdx.y owns output row x, so which windows cover it is
// the same for the whole block and no index is divided.  The k loop is
// unrolled over kMaxK so that ``st`` is read with constant indices from
// the parameter space: a loop-variable index would copy the struct into
// every thread's local memory.
__global__ void __launch_bounds__(256) latent_blend_kernel(
    const float* __restrict__ preds, const float* __restrict__ w,
    const float* __restrict__ norm, float* __restrict__ out, Starts st, int K, int W,
    long long F) {
  const int x = blockIdx.y;
  const float z = norm[x];
  for (long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x; f < F;
       f += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) break;
      const int j = x - st.s[k];
      if (j >= 0 && j < W)
        acc = __fadd_rn(acc, __fmul_rn(preds[((long long)k * W + j) * F + f], w[k * W + j]));
    }
    out[(long long)x * F + f] = __fdiv_rn(acc, z);
  }
}

}  // namespace

// All arrays are float32.  ``starts`` is a host array of K ints, passed
// to the kernel by value.  Returns cudaGetLastError() after the launch,
// or -1 for arguments this file has no kernel for.
extern "C" int latent_blend_fwd(const void* preds, const void* weights,
                                const void* normalizer, void* out, const int* starts,
                                int K, int W, int E, long long F, void* stream) {
  if (K < 1 || K > kMaxK || E < 1 || E > 65535) return -1;
  Starts st{};
  for (int k = 0; k < K; ++k) st.s[k] = starts[k];
  const int threads = 256;
  long long fblocks = (F + threads - 1) / threads;
  if (fblocks > 1024) fblocks = 1024;  // grid-stride along f beyond that
  const dim3 grid((unsigned)fblocks, (unsigned)E);
  latent_blend_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(preds), static_cast<const float*>(weights),
      static_cast<const float*>(normalizer), static_cast<float*>(out), st, K, W, F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* latent_blend_error_string(int code) {
  if (code < 0) return "unsupported partition count or extent";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
