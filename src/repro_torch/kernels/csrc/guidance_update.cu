// Fused CFG combine + flow-matching Euler step for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/guidance_update.py:guidance_update, the
// Pallas TPU kernel (a 1-D grid over flattened 65536-element blocks, each
// block computed in one VMEM pass).
//
// Same function: out = z + dt * (u + w * (c - u)), computed in f32 and
// cast back to z's dtype; z, c (cond) and u (uncond) share one shape and
// one dtype (f32 or bf16), w and dt are scalars.
//
// Design.  Elementwise, so the TPU's block grid becomes one grid-stride
// loop: each thread loads 16 bytes of each input at a time (a float4 in
// f32, eight bf16 in bf16), with a scalar tail for the last elements and
// a scalar path for buffers that do not start on a 16-byte boundary.
// The arithmetic uses explicit round-to-nearest intrinsics in the
// reference's order (subtract, scale, add, scale, add), so nvcc cannot
// contract it into FMAs and the kernel is bit-equal to its plain version;
// bf16 is rounded once, at the end, with __float2bfloat16_rn.
//
// What bounds it.  Five flops per element against 3 reads and 1 write of
// the element size: memory bandwidth (about 6.2 us for the 480p latent
// (1, 13, 60, 104, 16) in f32 at 3.35 TB/s, half that in bf16).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float update(float z, float c, float u, float w, float dt) {
  const float pred = __fadd_rn(u, __fmul_rn(w, __fsub_rn(c, u)));
  return __fadd_rn(z, __fmul_rn(dt, pred));
}

__global__ void guidance_f32(const float* __restrict__ z, const float* __restrict__ c,
                             const float* __restrict__ u, float* __restrict__ out,
                             long long n, float w, float dt, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    for (long long i = first; i < nv; i += stride) {
      const float4 a = reinterpret_cast<const float4*>(z)[i];
      const float4 b = reinterpret_cast<const float4*>(c)[i];
      const float4 d = reinterpret_cast<const float4*>(u)[i];
      reinterpret_cast<float4*>(out)[i] =
          make_float4(update(a.x, b.x, d.x, w, dt), update(a.y, b.y, d.y, w, dt),
                      update(a.z, b.z, d.z, w, dt), update(a.w, b.w, d.w, w, dt));
    }
    done = nv * 4;
  }
  for (long long i = done + first; i < n; i += stride) out[i] = update(z[i], c[i], u[i], w, dt);
}

__global__ void guidance_bf16(const __nv_bfloat16* __restrict__ z,
                              const __nv_bfloat16* __restrict__ c,
                              const __nv_bfloat16* __restrict__ u,
                              __nv_bfloat16* __restrict__ out, long long n, float w, float dt,
                              int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 8;
    for (long long i = first; i < nv; i += stride) {
      const uint4 a = reinterpret_cast<const uint4*>(z)[i];
      const uint4 b = reinterpret_cast<const uint4*>(c)[i];
      const uint4 d = reinterpret_cast<const uint4*>(u)[i];
      const __nv_bfloat16* za = reinterpret_cast<const __nv_bfloat16*>(&a);
      const __nv_bfloat16* cb = reinterpret_cast<const __nv_bfloat16*>(&b);
      const __nv_bfloat16* ud = reinterpret_cast<const __nv_bfloat16*>(&d);
      uint4 r;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16_rn(update(__bfloat162float(za[j]), __bfloat162float(cb[j]),
                                          __bfloat162float(ud[j]), w, dt));
      reinterpret_cast<uint4*>(out)[i] = r;
    }
    done = nv * 8;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = __float2bfloat16_rn(update(__bfloat162float(z[i]), __bfloat162float(c[i]),
                                        __bfloat162float(u[i]), w, dt));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or -1 for a dtype this file has no kernel for.
extern "C" int guidance_update_fwd(const void* z, const void* cond, const void* uncond,
                                   void* out, long long n, float w, float dt, int dtype,
                                   void* stream) {
  if (n <= 0) return 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(cond) |
                        reinterpret_cast<uintptr_t>(uncond) | reinterpret_cast<uintptr_t>(out);
  const int vec = (any % 16) == 0;
  const int threads = 256;
  const long long per_thread = dtype == 1 ? 8 : 4;
  long long blocks = (n / per_thread + threads) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    guidance_f32<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(z), static_cast<const float*>(cond),
        static_cast<const float*>(uncond), static_cast<float*>(out), n, w, dt, vec);
  } else if (dtype == 1) {
    guidance_bf16<<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(cond),
        static_cast<const __nv_bfloat16*>(uncond), static_cast<__nv_bfloat16*>(out), n, w, dt,
        vec);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* guidance_update_error_string(int code) {
  if (code < 0) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
