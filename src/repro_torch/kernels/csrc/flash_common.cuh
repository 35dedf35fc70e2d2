// What the flash kernels share:
//  - the mask of one (query, key) pair (every flash kernel);
//  - the list of the key tiles a block of queries has to visit
//    (flash_attention.cu, flash_attention_sm90.cu and both backward files)
//    and its transpose, the query tiles a block of keys has to visit (the
//    two backward files).  flash_attention.cu and the backward kernels
//    build a block's list in their own shared memory; flash_attention_sm90.cu
//    builds it once per (batch, 128-query block) in a pre-pass kernel
//    (live_tiles_pass) into a global buffer that the attention blocks of
//    every head read; flash_decode.cu lists attendable keys, not tiles,
//    itself;
//  - the mma.sync helpers (flash_attention.cu, flash_decode.cu,
//    flash_attention_bwd.cu): m16n8k16 bf16 products, ldmatrix, cp.async;
//  - the Hopper helpers of the two wgmma + TMA files
//    (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu): mbarriers, TMA
//    loads, wgmma descriptors (D 80's 32-byte swizzled tail box too) and
//    products, the host-side tensor-map encoder.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace flash {

constexpr int kPadPos = 2147483647;  // int32 max: padded kv slot
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool attend(int qp, int kp, int causal, int window) {
  bool ok = kp != kPadPos;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && (long long)kp > (long long)qp - window;
  return ok;
}

// The key tiles of BN keys that a block of BM queries (rows q0 .. q0+BM-1
// of ``qpos``, the ones below Sq) must visit, in order, into ``list``
// (shared or global memory, room for one int per tile of Skv); returns
// how many.  Entry i is 2 * tile + 1 when some pair of the tile is masked
// (padding, the causal or window mask, keys past Skv) and 2 * tile when
// every pair is attendable, so the per-element mask can be left out.
// kernels/ref.py: live_tiles_plain is its plain version.
//
// A tile is dropped only when it holds no attendable pair for any query of
// the block, judged from positions (so any order of positions works):
// it has no key other than int32-max, or, causally, its smallest key
// position is above the block's largest query position, or, with a
// window, its largest key position is at or below the block's smallest
// query position minus the window.  ``scratch`` holds 3 ints of shared
// memory.  Every thread of the block must call it.
template <int BM, int BN, int kThreads>
__device__ int live_tiles(const int* __restrict__ qpos, int q0, int Sq,
                          const int* __restrict__ kvpos, int Skv, int causal, int window,
                          int* list, int* scratch) {
  static_assert(BN % 32 == 0 && kThreads % 32 == 0, "whole warps");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = tid; r < BM; r += kThreads) {
    if (q0 + r < Sq) {
      const int qp = qpos[q0 + r];
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tid == 0) {
    scratch[0] = INT_MAX;
    scratch[1] = INT_MIN;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(&scratch[0], lo);
    atomicMax(&scratch[1], hi);
  }
  __syncthreads();
  const int qlo = scratch[0], qhi = scratch[1];
  const int ntiles = (Skv + BN - 1) / BN;
  // one warp per tile: its key positions' min, max and valid count
#pragma unroll 4
  for (int t = warp; t < ntiles; t += kThreads / 32) {
    int kmin = INT_MAX, kmax = INT_MIN, nvalid = 0;
#pragma unroll
    for (int j = lane; j < BN; j += 32) {
      const int n = t * BN + j;
      const int kp = n < Skv ? kvpos[n] : kPadPos;
      if (kp != kPadPos) {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
        ++nvalid;
      }
    }
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    nvalid = __reduce_add_sync(0xffffffffu, nvalid);
    if (lane == 0) {
      bool live = nvalid > 0;
      if (causal) live = live && kmin <= qhi;
      if (window > 0) live = live && (long long)kmax > (long long)qlo - window;
      bool clear = nvalid == BN;
      if (causal) clear = clear && kmax <= qlo;
      if (window > 0) clear = clear && (long long)kmin > (long long)qhi - window;
      list[t] = live ? (clear ? 1 : 2) : 0;
    }
  }
  __syncthreads();
  // compact the live tiles in place, in order (an entry never moves up)
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int t = base + lane;
      const int f = t < ntiles ? list[t] : 0;
      __syncwarp();  // every lane has read its flag before any entry is written
      const unsigned live = __ballot_sync(0xffffffffu, f != 0);
      if (f) list[count + __popc(live & ((1u << lane) - 1u))] = 2 * t + (f == 2);
      count += __popc(live);
      __syncwarp();
    }
    if (lane == 0) scratch[2] = count;
  }
  __syncthreads();
  return scratch[2];
}

// The query tiles of BQ rows that hold an attendable pair with the keys
// k0 .. k0+BK-1 (those below Skv) of ``kvpos``, in order, into ``list``;
// returns how many.  live_tiles with queries and keys swapped: entry i is
// 2 * tile + 1 when some pair may be masked and 2 * tile when every pair is
// attendable (BQ rows below Sq, BK valid keys, each inside the causal and
// window limits of every query).  A tile is dropped only when no pair is
// attendable, judged from positions: the keys have no valid one, or,
// causally, their smallest position is above the tile's largest query
// position, or, with a window, their largest is at or below the tile's
// smallest query position minus the window.  ``scratch`` holds 3 ints of
// shared memory.  Every thread of the block must call it.
template <int BQ, int BK, int kThreads>
__device__ int live_q_tiles(const int* __restrict__ qpos, int Sq,
                            const int* __restrict__ kvpos, int k0, int Skv, int causal,
                            int window, int* list, int* scratch) {
  static_assert(kThreads % 32 == 0, "whole warps");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int kmin = INT_MAX, kmax = INT_MIN, nvalid = 0;
  for (int j = tid; j < BK; j += kThreads) {
    const int n = k0 + j;
    const int kp = n < Skv ? kvpos[n] : kPadPos;
    if (kp != kPadPos) {
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
      ++nvalid;
    }
  }
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  nvalid = __reduce_add_sync(0xffffffffu, nvalid);
  if (tid == 0) {
    scratch[0] = INT_MAX;
    scratch[1] = INT_MIN;
    scratch[2] = 0;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(&scratch[0], kmin);
    atomicMax(&scratch[1], kmax);
    atomicAdd(&scratch[2], nvalid);
  }
  __syncthreads();
  const int klo = scratch[0], khi = scratch[1], kn = scratch[2];
  const int ntiles = (Sq + BQ - 1) / BQ;
  for (int t = warp; t < ntiles; t += kThreads / 32) {  // one warp per query tile
    int qlo = INT_MAX, qhi = INT_MIN;
    for (int r = lane; r < BQ; r += 32) {
      if (t * BQ + r < Sq) {
        const int qp = qpos[t * BQ + r];
        qlo = min(qlo, qp);
        qhi = max(qhi, qp);
      }
    }
    qlo = __reduce_min_sync(0xffffffffu, qlo);
    qhi = __reduce_max_sync(0xffffffffu, qhi);
    if (lane == 0) {
      bool live = kn > 0;
      if (causal) live = live && klo <= qhi;
      if (window > 0) live = live && (long long)khi > (long long)qlo - window;
      bool clear = kn == BK && (t + 1) * BQ <= Sq;
      if (causal) clear = clear && khi <= qlo;
      if (window > 0) clear = clear && (long long)klo > (long long)qhi - window;
      list[t] = live ? (clear ? 1 : 2) : 0;
    }
  }
  __syncthreads();
  if (warp == 0) {  // compact the live tiles in place, in order
    int count = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int t = base + lane;
      const int f = t < ntiles ? list[t] : 0;
      __syncwarp();
      const unsigned live = __ballot_sync(0xffffffffu, f != 0);
      if (f) list[count + __popc(live & ((1u << lane) - 1u))] = 2 * t + (f == 2);
      count += __popc(live);
      __syncwarp();
    }
    if (lane == 0) scratch[2] = count;
  }
  __syncthreads();
  return scratch[2];
}

// ------------------------------------------------------------ arithmetic
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mma.sync
// Fragment layouts of mma m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16x16): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..)
//   B (16x8):  b0 (k = 2c..2c+1, n = g), b1 (k = 2c+8.., n = g)
//   C (16x8):  c0,c1 (g, 2c..2c+1), c2,c3 (g+8, 2c..2c+1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (two) 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without a register round trip; zero-filled
// when ``valid`` is false (``src`` must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ------------------------------------------------ mbarriers, TMA, wgmma
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptors; bits 62-63 name the swizzle
// (1: 128-byte, 3: 32-byte)
__device__ __forceinline__ uint64_t desc_bits(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
// rows of 128 bytes with the 128-byte swizzle, 8-row groups 1024 bytes
// apart (sbo); lbo steps 64-column boxes along a MN-major operand's N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return desc_bits(addr, lbo, sbo) | (1ull << 62);
}
// D 80's 16-column box: rows of 32 bytes with the 32-byte swizzle, 8-row
// groups 256 bytes apart (K-major, and MN-major with N 16)
__device__ __forceinline__ uint64_t desc32(uint32_t addr) {
  return desc_bits(addr, 16, 256) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup's wgmma are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait that guards them
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define FLASH_D32_REGS                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_D32_OPS                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= A B, 64 x 64 x 16; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_D32_OPS
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, 64 x 64 x 16; A in registers (an accumulator's layout: k-step kk
// from its 8-column blocks 2 kk and 2 kk + 1), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_D32_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D 80: d[0:32] += A B (64 x 64 x 16) and d[32:40] += A B' (64 x 16 x 16);
// A in registers, B and B' MN-major in shared memory.  One asm statement,
// so that nothing is scheduled between the two products (ptxas would
// fence the registers of A again)
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                         uint64_t dbt) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %45, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32_REGS
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
      " {%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %46, p, 1, 1, 1;\n}\n"
      : FLASH_D32_OPS, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "l"(dbt));
}

// A operands of K = 16 kk .. 16 kk + 15 from an f32 accumulator fragment of
// 8 NK columns (8-column blocks 2 kk and 2 kk + 1), rounded to bf16
template <int NK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NK][4], const float (&s)[8 * NK]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ----------------------------------------------------- host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Make the current device's primary context current on the calling thread.
// The driver's encoder below fails without one, and a thread that has made
// no runtime call yet has none (autograd's backward thread, when the flash
// backward is its first CUDA work); cudaSetDevice makes it current.
inline cudaError_t current_context() {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaSetDevice(dev);
}

// The driver's cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint
// so that the build needs no -lcuda; null if the driver has none.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (B, S, heads, D) tensor as the 3-D map {heads * D, S, B}, read in
// boxes of ``cols`` dims x ``rows`` rows: 64 columns with the 128-byte
// swizzle, 16 with the 32-byte one; rows past S read as zeros (never the
// next batch row's).
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int heads, int D, int S,
                   int B, int cols, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * D * 2, (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace flash
