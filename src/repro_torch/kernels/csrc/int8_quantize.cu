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
// What bounds it.  Four bytes read and one written per element, a few
// operations each: memory bandwidth.  At the serving path's slabs (0.6-0.8
// MB each, 4 a call) the bytes take under a microsecond, so what a call
// costs beyond them is fixed cost: launches, a memset, a second read, and
// barriers.  At 480p (4 slabs of 4.8 MB) a call needs every SM's share of
// the card's bandwidth.
//
// Design: one launch, x read once, every SM loaded.  A cooperative launch
// puts one block on each of the card's G SMs, all resident at once.
//   1. With N < G slabs, each slab gets P = G / N blocks (4 slabs: 33 a
//      slab); each block owns a contiguous share of the slab's
//      16-byte-aligned body and copies it into shared memory with 16-byte
//      cp.async, every copy in flight at once (the unaligned head and
//      tail, at most 3 elements each, are scalar accesses of the slab's
//      first block).  A share larger than kMaxStageBytes is staged up to
//      that size; the rest is read straight from memory, and again (from
//      the 50 MB L2) to quantize.
//   2. Each block reduces the max of the bit patterns of |x| (sign
//      cleared) over its share.  Non-negative floats order like their bit
//      patterns, and every NaN pattern with the sign cleared lies above
//      +inf, so a NaN anywhere in the slab wins the max and the scale is
//      NaN, as jnp.max propagates it (fmaxf would drop it).  A max does not
//      depend on the order of its operands: deterministic.
//   3. Each block writes its max to its word of a scratch of G words (each
//      word read is written first in the same launch: no memset), a grid
//      barrier follows, then every warp reads its slab's P words and forms
//      the slab's scale.
//   4. Each block quantizes its share from shared memory with IEEE
//      division (__fdiv_rn, as the reference's x / scale; never a
//      reciprocal multiply), rounds half to even (rintf), clips, and stores
//      4 codes as one 32-bit word (4 bytes where the slab's codes start off
//      a 4-byte boundary).  The codes reach their bytes by an exact float
//      add and byte permutes, not float-to-int conversions.  The slab's
//      first block writes the scale.
//   With N >= G slabs, a block takes whole slabs in turn (n = b, b + G,
//   ...) and reduces and quantizes each alone: no scratch, no grid barrier.
// A thread-block cluster a slab (16 blocks, the max reduced through
// distributed shared memory) was the first design.  It ran slower: a
// 16-block cluster's launch and barriers cost ~3.5 us alone, and a slab
// then loads 16 SMs, not 33 (PERF.md).
// Built without --use_fast_math: no FTZ, IEEE division.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStageBytes = 224 * 1024;    // of the 227 KB a block may have
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max4(const float4& v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

// The code of v in the low byte: the clipped integer rintf gives, plus
// 1.5 * 2^23, is exact, and the low byte of its bit pattern is the int8
// code in two's complement (no float-to-int conversion).  A zero v is its
// own quotient by any scale but NaN (the scale is never 0): taken as it is,
// since __fdiv_rn sends a zero numerator down its slow path, and slabs
// carry zero rows (core padding).
__device__ __forceinline__ unsigned code_of(float v, float scale, float qmax) {
  float q = rintf(v == 0.f && scale == scale ? v : __fdiv_rn(v, scale));
  q = fminf(fmaxf(q, -qmax), qmax);
  return __float_as_uint(q + 12582912.0f);
}

__device__ __forceinline__ void store4(int8_t* w, const float4& v, float scale, float qmax,
                                       bool word) {
  const unsigned c0 = code_of(v.x, scale, qmax), c1 = code_of(v.y, scale, qmax),
                 c2 = code_of(v.z, scale, qmax), c3 = code_of(v.w, scale, qmax);
  if (word) {
    *reinterpret_cast<unsigned*>(w) =
        __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
  } else {
    w[0] = static_cast<int8_t>(c0 & 0xffu);
    w[1] = static_cast<int8_t>(c1 & 0xffu);
    w[2] = static_cast<int8_t>(c2 & 0xffu);
    w[3] = static_cast<int8_t>(c3 & 0xffu);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ float scale_of(unsigned amax_bits, float qmax) {
  const float amax = __uint_as_float(amax_bits);
  // jnp.maximum(amax, 1e-20): NaN propagates
  const float floored = (amax > 1e-20f || amax != amax) ? amax : 1e-20f;
  return __fdiv_rn(floored, qmax);
}

// The max over the block: every thread gets it.  Ends on a barrier, so
// warp_max may be written again at once.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* warp_max) {
  const int lane = threadIdx.x & 31;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = __reduce_max_sync(0xffffffffu, lane < kThreads / 32 ? warp_max[lane] : 0u);
  __syncthreads();
  return m;
}

// Share r of the P shares of slab n: the head scalars up to a 16-byte
// boundary, the body's float4s [v0, v0 + count) (the first `staged` kept in
// shared memory), the tail; share 0 takes the head and the tail.  Each
// thread reads back only the staged float4s it copied itself, so no block
// barrier guards them.
struct Share {
  const float* xs;
  int8_t* ws;
  const float4* xv;
  int8_t* wsv;        // the code of the body's first float4
  long long v0, count, staged;
  long long e;        // this thread's edge element, if `edge`
  bool edge;

  __device__ __forceinline__ Share(const float* x, int8_t* wire, long long n, long long M,
                                   int r, int P, long long stage_vecs) {
    xs = x + n * M;
    ws = wire + n * M;
    const long long head =
        min(M, static_cast<long long>(((16u - (reinterpret_cast<uintptr_t>(xs) & 15u)) & 15u)
                                      >> 2));
    const long long nvec = (M - head) >> 2;
    const long long per = (nvec + P - 1) / P;
    v0 = min(nvec, r * per);
    count = min(nvec, v0 + per) - v0;
    staged = min(count, stage_vecs);
    xv = reinterpret_cast<const float4*>(xs + head) + v0;
    wsv = ws + head + 4 * v0;
    // share 0: the head (threads 0-2) and the tail (threads 4-6)
    const int t = threadIdx.x;
    e = t < 4 ? t : head + 4 * nvec + t - 4;
    edge = r == 0 && (t < 4 ? e < head : t < 8 && e < M);
  }

  // Stage the share; returns this thread's max of |x| bits over its part
  // of the share and its edge element.
  __device__ __forceinline__ unsigned load(float4* stage, float& ev) const {
    for (long long i = threadIdx.x; i < staged; i += kThreads) cp_async16(stage + i, xv + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    unsigned m = 0u;
#pragma unroll 4
    for (long long i = staged + threadIdx.x; i < count; i += kThreads) m = max(m, max4(xv[i]));
    ev = edge ? xs[e] : 0.f;
    m = max(m, abs_bits(ev));
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    for (long long i = threadIdx.x; i < staged; i += kThreads) m = max(m, max4(stage[i]));
    return m;
  }

  __device__ __forceinline__ void quantize(const float4* stage, float ev, float scale,
                                           float qmax) const {
    const bool word = (reinterpret_cast<uintptr_t>(wsv) & 3u) == 0;
    for (long long i = threadIdx.x; i < staged; i += kThreads)
      store4(wsv + 4 * i, stage[i], scale, qmax, word);
#pragma unroll 4
    for (long long i = staged + threadIdx.x; i < count; i += kThreads)
      store4(wsv + 4 * i, xv[i], scale, qmax, word);
    if (edge) ws[e] = static_cast<int8_t>(code_of(ev, scale, qmax) & 0xffu);
  }
};

// grid (G), one block an SM, launched cooperatively.  P > 1: slab
// b / P, share b % P, the maxes exchanged through part (G words) across a
// grid barrier.  P == 1: whole slabs b, b + G, ...
__global__ void __launch_bounds__(kThreads) int8_quantize_kernel(
    const float* __restrict__ x, int8_t* __restrict__ wire, float* __restrict__ scales,
    unsigned* __restrict__ part, int N, long long M, float qmax, int P,
    long long stage_vecs) {
  extern __shared__ float4 stage[];
  __shared__ unsigned warp_max[kThreads / 32];
  float ev;
  if (P == 1) {
    for (long long n = blockIdx.x; n < N; n += gridDim.x) {
      const Share s(x, wire, n, M, 0, 1, stage_vecs);
      const float scale = scale_of(block_max(s.load(stage, ev), warp_max), qmax);
      if (threadIdx.x == 0) scales[n] = scale;
      s.quantize(stage, ev, scale, qmax);
    }
    return;
  }
  const int n = blockIdx.x / P, r = blockIdx.x % P;
  const bool active = n < N;
  const Share s(x, wire, active ? n : 0, M, r, P, stage_vecs);
  const unsigned m = block_max(active ? s.load(stage, ev) : 0u, warp_max);
  if (active && threadIdx.x == 0) part[blockIdx.x] = m;
  cg::this_grid().sync();
  if (!active) return;
  // the slab's max: its P blocks' words, read by every warp
  unsigned m_all = 0u;
  for (int j = threadIdx.x & 31; j < P; j += 32) m_all = max(m_all, __ldcg(part + n * P + j));
  m_all = __reduce_max_sync(0xffffffffu, m_all);
  const float scale = scale_of(m_all, qmax);
  if (r == 0 && threadIdx.x == 0) scales[n] = scale;
  s.quantize(stage, ev, scale, qmax);
}

// The SM count, and the function attribute for more than 48 KB of dynamic
// shared memory, set once per device at its first launch.
cudaError_t configure(int* sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && count[dev] > 0) {
    *sms = count[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(int8_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxStageBytes);
  if (e == cudaSuccess && dev < kMaxDevices) count[dev] = *sms;
  return e;
}

}  // namespace

// x: N contiguous f32 slabs of M elements (4-byte aligned); wire: N*M
// int8; scales: N f32; part: part_words unsigned words of scratch (the
// grid takes min(SMs, part_words) blocks; 1 word suffices for N >= that).
// One launch.  Returns its error (cudaLaunchKernelEx, then
// cudaGetLastError()), or -1 for arguments this file has no kernel for.
extern "C" int int8_quantize_fwd(const void* x, void* wire, void* scales, void* part,
                                 int part_words, int N, long long M, int qmax, void* stream) {
  if (N < 1 || M < 1 || qmax < 1 || qmax > 127 || part_words < 1) return -1;
  int sms = 0;
  cudaError_t e = configure(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = sms < part_words ? sms : part_words;
  const int P = N < G ? G / N : 1;
  const long long per = (M / 4 + P - 1) / P;   // the largest share
  const long long stage_vecs = per < kMaxStageBytes / 16 ? per : kMaxStageBytes / 16;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(stage_vecs) * 16;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, int8_quantize_kernel, static_cast<const float*>(x),
                         static_cast<int8_t*>(wire), static_cast<float*>(scales),
                         static_cast<unsigned*>(part), N, M, static_cast<float>(qmax), P,
                         stage_vecs);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_quantize_error_string(int code) {
  if (code < 0) return "unsupported slab count, slab size or qmax";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
