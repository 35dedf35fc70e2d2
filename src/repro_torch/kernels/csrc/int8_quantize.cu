// Per-slab max-abs scale + symmetric integer quantize for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/wire_codec.py:int8_quantize, the Pallas TPU
// kernel (a two-phase grid: phase 0 reduces max|x| over the row blocks
// into one SMEM scalar, phase 1 quantizes every block with the finished
// scale).
//
// Same function, for N slabs at once (each slab is one wire message):
//   scale_n = max(max|x_n|, 1e-20f) / qmax
//   wire_n  = clip(round_half_even(x_n / scale_n), -qmax, qmax)   (int8)
// bit-equal to IntCodec.encode: qmax 127 for int8, 7 for the int4 codes.
//
// Design.  GPU blocks share no scalar across a grid, so the TPU's two
// phases become two kernels on one stream:
//   1. amax: grid (blocks, N).  Each thread takes the max of the bit
//      patterns of |x| (sign cleared) over its elements; a warp and then
//      a block reduce it; one atomicMax per block folds it into the
//      slab's unsigned word.  Non-negative floats order like their bit
//      patterns, and every NaN pattern with the sign cleared lies above
//      +inf, so a NaN anywhere in the slab wins the max and the scale is
//      NaN, as jnp.max propagates it (fmaxf would drop it).  A max does
//      not depend on the order of its operands: deterministic.
//   2. quantize: grid (blocks, N), every element divided by the finished
//      scale with IEEE division (__fdiv_rn, as the reference's x / scale;
//      never a reciprocal multiply), rounded half to even (rintf),
//      clipped and stored as int8.  Block 0 of each slab writes its scale.
// The launcher zeroes the amax words with cudaMemsetAsync on the same
// stream first.  Built without --use_fast_math: no FTZ, IEEE division.
//
// What bounds it.  Four bytes read twice and one written per element,
// a few operations each: memory bandwidth.  Neighbouring threads take
// neighbouring elements, so every access is coalesced.  A serving slab
// is ~150k elements, so launch cost dominates (two launches per call).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  return __reduce_max_sync(0xffffffffu, v);
}

__global__ void __launch_bounds__(kThreads) amax_kernel(
    const float* __restrict__ x, unsigned* __restrict__ amax_bits, long long M) {
  const int n = blockIdx.y;
  const float* xs = x + (long long)n * M;
  unsigned m = 0u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned u = __float_as_uint(xs[i]) & 0x7fffffffu;
    m = u > m ? u : m;
  }
  m = warp_max(m);
  __shared__ unsigned warp_m[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_m[lane] : 0u;
    m = warp_max(m);
    if (lane == 0) atomicMax(amax_bits + n, m);
  }
}

__global__ void __launch_bounds__(kThreads) quantize_kernel(
    const float* __restrict__ x, const unsigned* __restrict__ amax_bits,
    int8_t* __restrict__ wire, float* __restrict__ scales, long long M, float qmax) {
  const int n = blockIdx.y;
  const float amax = __uint_as_float(amax_bits[n]);
  // jnp.maximum(amax, 1e-20): NaN propagates
  const float floored = (amax > 1e-20f || amax != amax) ? amax : 1e-20f;
  const float scale = __fdiv_rn(floored, qmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) scales[n] = scale;
  const float* xs = x + (long long)n * M;
  int8_t* ws = wire + (long long)n * M;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += (long long)gridDim.x * blockDim.x) {
    float q = rintf(__fdiv_rn(xs[i], scale));
    q = fminf(fmaxf(q, -qmax), qmax);
    ws[i] = static_cast<int8_t>(static_cast<int>(q));
  }
}

}  // namespace

// x: N contiguous f32 slabs of M elements; wire: N*M int8; scales: N f32;
// amax_scratch: N unsigned words (zeroed here).  Returns cudaGetLastError()
// after the launches, or -1 for arguments this file has no kernel for.
extern "C" int int8_quantize_fwd(const void* x, void* wire, void* scales,
                                 void* amax_scratch, int N, long long M, int qmax,
                                 void* stream) {
  if (N < 1 || N > 65535 || M < 1 || qmax < 1 || qmax > 127) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(amax_scratch, 0, sizeof(unsigned) * (size_t)N, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 256) blocks = 256;  // grid-stride beyond that
  const dim3 grid((unsigned)blocks, (unsigned)N);
  amax_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                        static_cast<unsigned*>(amax_scratch), M);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  quantize_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const unsigned*>(amax_scratch),
      static_cast<int8_t*>(wire), static_cast<float*>(scales), M, (float)qmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_quantize_error_string(int code) {
  if (code < 0) return "unsupported slab count, slab size or qmax";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
