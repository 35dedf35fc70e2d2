// Fused int8 dequantize + position-aware latent reconstruction for
// Hopper, sm_90a: the quantized-wire twin of latent_blend.cu.
//
// Replaces: src/repro/kernels/wire_codec.py:dequant_blend, the Pallas TPU
// kernel (grid (F blocks, K) with K innermost, accumulating the output
// tile across partitions in VMEM scratch).
//
// Same function:
//   out[x, f] = (sum_k W_k[x - s_k] * (scale_k * wire[k, x - s_k, f])) / Z[x]
// over the windows [s_k, s_k + W) that cover x, accumulated in f32 and
// stored as f32 or bf16.  The dequantized f32 windows never reach
// device memory: each int8 code is read once and scaled in a register.
//
// Design.  latent_blend.cu's: blocks share no scratch, so each thread
// owns output elements (x, f), loops over the K windows in k order,
// adds (float(wire) * scale_k) * W_k to a register, divides by Z[x] once
// and stores.  No atomics; products and sums use round-to-nearest
// intrinsics (no FMA contraction) in the plain version's order, so the
// two agree bit for bit.  Grid row x = blockIdx.y owns latent row x, and
// the K loop is unrolled over kMaxK so the by-value starts are read with
// constant indices.
//
// What bounds it.  One byte read per code (K*W/E per output element on
// average), a 4- or 2-byte write, a few flops: memory bandwidth.
// Neighbouring threads take neighbouring f: coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;

struct Starts {
  int s[kMaxK];
};

template <typename Out>
__device__ __forceinline__ Out store_cast(float v);

template <>
__device__ __forceinline__ float store_cast<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename Out>
__global__ void __launch_bounds__(256) dequant_blend_kernel(
    const int8_t* __restrict__ wire, const float* __restrict__ scales,
    const float* __restrict__ w, const float* __restrict__ norm, Out* __restrict__ out,
    Starts st, int K, int W, long long F) {
  const int x = blockIdx.y;
  const float z = norm[x];
  for (long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x; f < F;
       f += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) break;
      const int j = x - st.s[k];
      if (j >= 0 && j < W) {
        const float v = __fmul_rn((float)wire[((long long)k * W + j) * F + f], scales[k]);
        acc = __fadd_rn(acc, __fmul_rn(v, w[k * W + j]));
      }
    }
    out[(long long)x * F + f] = store_cast<Out>(__fdiv_rn(acc, z));
  }
}

}  // namespace

// wire int8 (K, W, F); scales (K,), weights (K, W), normalizer (E,) f32; out
// (E, F) f32 (out_dtype 0) or bf16 (1).  ``starts`` is a host array of K
// ints, passed to the kernel by value.  Returns cudaGetLastError() after
// the launch, or -1 for arguments this file has no kernel for.
extern "C" int dequant_blend_fwd(const void* wire, const void* scales, const void* weights,
                                 const void* normalizer, void* out, const int* starts,
                                 int K, int W, int E, long long F, int out_dtype,
                                 void* stream) {
  if (K < 1 || K > kMaxK || E < 1 || E > 65535 || (out_dtype != 0 && out_dtype != 1))
    return -1;
  Starts st{};
  for (int k = 0; k < K; ++k) st.s[k] = starts[k];
  const int threads = 256;
  long long fblocks = (F + threads - 1) / threads;
  if (fblocks > 1024) fblocks = 1024;  // grid-stride along f beyond that
  const dim3 grid((unsigned)fblocks, (unsigned)E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wr = static_cast<const int8_t*>(wire);
  const float* sc = static_cast<const float*>(scales);
  const float* wt = static_cast<const float*>(weights);
  const float* nz = static_cast<const float*>(normalizer);
  if (out_dtype == 0)
    dequant_blend_kernel<float><<<grid, threads, 0, s>>>(
        wr, sc, wt, nz, static_cast<float*>(out), st, K, W, F);
  else
    dequant_blend_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        wr, sc, wt, nz, static_cast<__nv_bfloat16*>(out), st, K, W, F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dequant_blend_error_string(int code) {
  if (code < 0) return "unsupported partition count, extent or output dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
