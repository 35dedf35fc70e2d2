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
// Each code: v = code * scale_k, then acc += v * W_k, each product and
// sum rounded once (__fmul_rn, __fadd_rn: no FMA contraction) in k
// order, then __fdiv_rn by Z[x]: the plain version's order, so the two
// agree bit for bit (bf16 by __float2bfloat16_rn of the same quotient).
//
// What bounds it.  One byte read per code (K*W/E codes per output element
// on average), a 4- or 2-byte write, a few flops: memory bandwidth.  A
// thread that waits on one window's load before it issues the next keeps
// a fraction of the bytes in flight that it could, and 1-byte loads fill
// a warp request with 32 bytes.
//
// Design (latent_blend.cu's, on int8 codes).  A block's row x =
// blockIdx.y is fixed: at its start one warp writes the row's cover list
// to shared memory, each window k covering x at j = x - s_k in k order (a
// ballot over lanes k, so starts may repeat; at most kMaxK entries): the
// slab row's byte offset, k * W + j for its weight and k for its scale.
// Each thread owns a run of L consecutive codes: 16 (one 16-byte load a
// window) where F % 16 == 0, the wire starts on 16 bytes and E * F / 16
// runs fill the card's resident threads, else 4 (a 4-byte load) where
// F % 4 == 0 and it starts on 4, else 1; chosen by shape at launch.  For
// up to 4 covering windows at a time a thread issues every window's code
// load, scale and weight before the first sum, so all its bytes are in
// flight at once.  16 codes make 64 bytes of f32 quotients a thread: a
// warp passes them through shared memory so that each of its store
// instructions writes 512 contiguous bytes (stored from their owners,
// they cost more than all the loads at 480p).  No atomics, no grid-stride
// loop: one thread a run, deterministic.  At most 64 registers (8 blocks
// of 128 threads an SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kThreads = 128;

struct Starts {
  int s[kMaxK];
};

// L codes a thread: the vector type of one load
template <int L> struct Codes;
template <> struct Codes<16> { using T = uint4; };
template <> struct Codes<4> { using T = unsigned; };
template <> struct Codes<1> { using T = signed char; };

__device__ __forceinline__ int sbyte(unsigned w, int b) {  // signed byte b of w
  return static_cast<int>(w << (24 - 8 * b)) >> 24;
}
__device__ __forceinline__ int code_at(const uint4& c, int e) {
  const unsigned w = e < 4 ? c.x : e < 8 ? c.y : e < 12 ? c.z : c.w;
  return sbyte(w, e & 3);
}
__device__ __forceinline__ int code_at(unsigned c, int e) { return sbyte(c, e); }
__device__ __forceinline__ int code_at(signed char c, int) { return c; }

// acc += (code * scale) * w, each step rounded once: the plain version's order
__device__ __forceinline__ void madd(float& acc, int code, float scale, float w) {
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(static_cast<float>(code), scale), w));
}

// acc[e] += W * scale * codes for the N covering windows of the list from
// c0, in list (= k) order: every load issued before the first sum.
template <int L, int N>
__device__ __forceinline__ void sum_windows(float (&acc)[L], const int8_t* __restrict__ wire,
                                            const float* __restrict__ scales,
                                            const float* __restrict__ w,
                                            const long long* row, const int* widx,
                                            const int* kidx, long long i) {
  using T = typename Codes<L>::T;
  T c[N];
  float sc[N], wt[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    c[n] = __ldg(reinterpret_cast<const T*>(wire + row[n]) + i);
    sc[n] = __ldg(scales + kidx[n]);
    wt[n] = __ldg(w + widx[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < L; ++e) madd(acc[e], code_at(c[n], e), sc[n], wt[n]);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // each rounded to nearest even
  return *reinterpret_cast<const unsigned*>(&v);
}

// the quotients of a run of 1 or 4 codes, streamed out (nothing reads them back here)
template <int L>
__device__ __forceinline__ void store(float* o, const float (&q)[L]) {
  if constexpr (L == 1) {
    __stcs(o, q[0]);
  } else {
    __stcs(reinterpret_cast<float4*>(o), make_float4(q[0], q[1], q[2], q[3]));
  }
}

template <int L>
__device__ __forceinline__ void store(__nv_bfloat16* o, const float (&q)[L]) {
  if constexpr (L == 1) {
    *o = __float2bfloat16_rn(q[0]);
  } else {
    __stcs(reinterpret_cast<uint2*>(o), make_uint2(pack_bf16(q[0], q[1]), pack_bf16(q[2], q[3])));
  }
}

// 16-byte piece pc of the 16 quotients of a run (f32: 4 a piece, bf16: 8)
template <typename Out>
__device__ __forceinline__ uint4 piece(const float (&q)[16], int pc) {
  if constexpr (sizeof(Out) == 4) {
    return make_uint4(__float_as_uint(q[4 * pc]), __float_as_uint(q[4 * pc + 1]),
                      __float_as_uint(q[4 * pc + 2]), __float_as_uint(q[4 * pc + 3]));
  } else {
    return make_uint4(pack_bf16(q[8 * pc], q[8 * pc + 1]),
                      pack_bf16(q[8 * pc + 2], q[8 * pc + 3]),
                      pack_bf16(q[8 * pc + 4], q[8 * pc + 5]),
                      pack_bf16(q[8 * pc + 6], q[8 * pc + 7]));
  }
}

// 16 quotients a thread leave a warp as 16-byte stores of contiguous
// bytes (a lane's own 64 or 32 bytes would put each store instruction on
// 32 strided pieces): each lane puts its pieces in shared memory (a row of
// NP + 1 pieces a lane, so the 8 lanes of a phase hit 8 distinct bank
// groups), then store e writes the warp's pieces e * 32 .. e * 32 + 31 of
// output row ``row``; pieces of runs past the row's end are not stored.
template <typename Out>
__device__ __forceinline__ void store_warp(Out* row, uint4* stage, const float (&q)[16],
                                           long long i, long long n_runs) {
  constexpr int NP = 16 * sizeof(Out) / 16, STRIDE = NP + 1;
  const int lane = threadIdx.x & 31;
  uint4* mine = stage + threadIdx.x * STRIDE;
#pragma unroll
  for (int pc = 0; pc < NP; ++pc) mine[pc] = piece<Out>(q, pc);
  __syncwarp();
  const long long first = i - lane;               // the warp's first run
  uint4* dst = reinterpret_cast<uint4*>(row) + first * NP;
  const uint4* src = stage + (threadIdx.x - lane) * STRIDE;
#pragma unroll
  for (int e = 0; e < NP; ++e) {
    const int at = e * 32 + lane, owner = at / NP;
    if (first + owner < n_runs) __stcs(dst + at, src[owner * STRIDE + at % NP]);
  }
}

// grid (ceil(F / L / kThreads), E)
template <int L, typename Out>
__global__ void __launch_bounds__(kThreads, 8) dequant_blend_kernel(
    const int8_t* __restrict__ wire, const float* __restrict__ scales,
    const float* __restrict__ w, const float* __restrict__ norm, Out* __restrict__ out,
    Starts st, int K, int W, long long F) {
  __shared__ long long row[kMaxK];   // byte offset of wire[k, j, 0] of each covering window
  __shared__ int widx[kMaxK];        // k * W + j: its weight
  __shared__ int kidx[kMaxK];        // k: its scale
  __shared__ int n_cover;
  __shared__ uint4 stage[L == 16 ? kThreads * (sizeof(Out) + 1) : 1];  // store_warp's pieces
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
      kidx[at] = lane;
    }
    if (lane == 0) n_cover = __popc(ballot);
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_runs = F / L;
  const bool active = i < n_runs;
  if (L != 16 && !active) return;     // 16 codes a thread: the whole warp stores together
  const int nc = active ? n_cover : 0;
  const float z = __ldg(norm + x);
  float acc[L];
#pragma unroll
  for (int e = 0; e < L; ++e) acc[e] = 0.f;
  int c = 0;
  for (; c + 4 <= nc; c += 4)
    sum_windows<L, 4>(acc, wire, scales, w, row + c, widx + c, kidx + c, i);
  switch (nc - c) {
    case 3: sum_windows<L, 3>(acc, wire, scales, w, row + c, widx + c, kidx + c, i); break;
    case 2: sum_windows<L, 2>(acc, wire, scales, w, row + c, widx + c, kidx + c, i); break;
    case 1: sum_windows<L, 1>(acc, wire, scales, w, row + c, widx + c, kidx + c, i); break;
    default: break;
  }
#pragma unroll
  for (int e = 0; e < L; ++e) acc[e] = __fdiv_rn(acc[e], z);
  Out* orow = out + static_cast<long long>(x) * F;
  if constexpr (L == 16)
    store_warp<Out>(orow, stage, acc, i, n_runs);
  else
    store<L>(orow + i * L, acc);
}

template <int L, typename Out>
cudaError_t launch(const int8_t* wire, const float* sc, const float* w, const float* z,
                   Out* out, const Starts& st, int K, int W, int E, long long F,
                   cudaStream_t s) {
  const long long n = F / L;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), static_cast<unsigned>(E));
  dequant_blend_kernel<L, Out><<<grid, kThreads, 0, s>>>(wire, sc, w, z, out, st, K, W, F);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t launch_any(const int8_t* wire, const float* sc, const float* w, const float* z,
                       Out* out, const Starts& st, int K, int W, int E, long long F,
                       cudaStream_t s) {
  // 16 codes a thread where every slab row and output row starts on 16
  // bytes and the runs fill the card's resident threads once (8 blocks an
  // SM); 4 where rows start on 4 (and an output run on 8), else 1.  Fewer
  // runs of 16 than resident threads leave too few warps to hide a
  // thread's 16 divisions (at the smoke's T dim, 40,560 runs: 4.7 us
  // against 2.9 with 4 codes a thread)
  const uintptr_t a = reinterpret_cast<uintptr_t>(wire), o = reinterpret_cast<uintptr_t>(out);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (F % 16 == 0 && a % 16 == 0 && o % 16 == 0 &&
      static_cast<long long>(E) * (F / 16) >= static_cast<long long>(sms) * 8 * kThreads)
    return launch<16>(wire, sc, w, z, out, st, K, W, E, F, s);
  if (F % 4 == 0 && a % 4 == 0 && o % 16 == 0)
    return launch<4>(wire, sc, w, z, out, st, K, W, E, F, s);
  return launch<1>(wire, sc, w, z, out, st, K, W, E, F, s);
}

}  // namespace

// wire int8 (K, W, F); scales (K,), weights (K, W), normalizer (E,) f32; out
// (E, F) f32 (out_dtype 0) or bf16 (1).  ``starts`` is a host array of K
// ints, passed to the kernel by value.  The wire may start anywhere (the
// load width follows its alignment and F).  Returns cudaGetLastError()
// after the launch, or -1 for arguments this file has no kernel for.
extern "C" int dequant_blend_fwd(const void* wire, const void* scales, const void* weights,
                                 const void* normalizer, void* out, const int* starts,
                                 int K, int W, int E, long long F, int out_dtype,
                                 void* stream) {
  if (K < 1 || K > kMaxK || E < 1 || E > 65535 || F < 1 ||
      (F + kThreads - 1) / kThreads > 0x7fffffffLL || (out_dtype != 0 && out_dtype != 1))
    return -1;
  Starts st{};
  for (int k = 0; k < K; ++k) st.s[k] = starts[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wr = static_cast<const int8_t*>(wire);
  const float* sc = static_cast<const float*>(scales);
  const float* wt = static_cast<const float*>(weights);
  const float* nz = static_cast<const float*>(normalizer);
  const cudaError_t e =
      out_dtype == 0
          ? launch_any(wr, sc, wt, nz, static_cast<float*>(out), st, K, W, E, F, s)
          : launch_any(wr, sc, wt, nz, static_cast<__nv_bfloat16*>(out), st, K, W, E, F, s);
  return static_cast<int>(e);
}

extern "C" const char* dequant_blend_error_string(int code) {
  if (code < 0) return "unsupported partition count, extent, row length or output dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
