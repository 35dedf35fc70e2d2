// What the flash kernels share: the mask of one (query, key) pair (all
// three), and the list of the key tiles a block of queries has to visit
// (flash_attention.cu and flash_attention_sm90.cu).  flash_attention.cu
// builds each block's list in its own shared memory; flash_attention_sm90.cu
// builds it once per (batch, 128-query block) in a pre-pass kernel
// (live_tiles_pass) into a global buffer that the attention blocks of every
// head read; flash_decode.cu lists attendable keys, not tiles, itself.
#pragma once

#include <climits>

namespace flash {

constexpr int kPadPos = 2147483647;  // int32 max: padded kv slot

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

}  // namespace flash
