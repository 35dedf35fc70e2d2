// Flash attention backward in f32 (the gradient of flash_attention.cu's f32
// function) for Hopper, sm_90a, at head dims 32, 64, 80 and 128, on 3xTF32
// tensor-core products.  f32 serves the reduced configs that the training
// CLI trains (head dim 32) and the checks, not serving: ops.py routes f32
// here (ops.bwd_kernel), bf16 to flash_attention_bwd_sm90.cu.
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
// is summed by one thread in a fixed order.  Three launches on the stream
// (four at D 128):
//   1. bwd_f32_prep, a block per (batch, head, 32 queries), four threads a
//      row: each row's Delta, into an f32 workspace.
//   2. bwd_f32_dkdv, a block per (kv head, batch, T keys), 16 keys a warp:
//      dK and dV of its keys stay in registers while the block walks the G
//      heads of the group in order and, for each, the query tiles (qtile)
//      that hold an attendable pair with its keys (flash_common.cuh:
//      live_q_tiles); per tile S^T = K Q^T and dP^T = V dO^T, then
//      dV += P^T dO and dK += dS^T Q.  At D 128 dV and dK take a launch
//      each (both running sums would not fit the registers).
//   3. bwd_f32_dq, a block per (head, batch, T queries), 16 queries a warp,
//      the longest causal rows first: dQ in registers over the live T-key
//      tiles (flash_common.cuh: live_tiles); per tile S = Q K^T and
//      dP = dO V^T, then dQ += dS K.
// Every product runs in 3xTF32 on mma.sync m16n8k8 (flash_tf32.cuh, as
// flash_attention.cu's f32 kernel), each operand split once: the block's
// own rows (K and V in dkdv, Q and dO in dq) when it loads them, each
// staged tile's rows as they arrive (the next tile's copy runs while this
// one is multiplied), P^T, dS^T and dS in registers.  S^T, dP^T, S and dP
// are rows_dot; dV, dK and dQ tile_product, each tile's share into a
// zeroed accumulator added to the running sum in f32.
//
// What bounds it.  Its products: 2.5 times the forward's over the attended
// pairs, each as three TF32 products (495 TFLOP/s dense, mma.sync measured
// at 314: tools/tf32_mma_rate.py), far above the card's operations per
// byte at a training length.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "flash_common.cuh"
#include "flash_tf32.cuh"

namespace {

using flash::attend;
using flash::exp2_approx;
using flash::kLog2e;
using flash::kPadPos;
using flash_tf32::rows_dot;
using flash_tf32::split_staged;
using flash_tf32::stage;
using flash_tf32::store_rows;
using flash_tf32::tile_product;

constexpr int kPrepThreads = 128;  // 4 threads a row, 32 rows a block
constexpr int kPrepRows = 32;

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

// Rows of a block (16 a warp) and of dq's key tiles: 64 up to D 64, 32 above
template <int D>
__host__ __device__ constexpr int tile() { return D <= 64 ? 64 : 32; }

// Queries of dkdv's tiles: fewer at the wider head dims, where the block's
// dK and dV take D registers a thread (64 at D 32, 32 at D 64 and 80, 16 at
// D 128)
template <int D>
__host__ __device__ constexpr int qtile() { return D == 32 ? 64 : D == 128 ? 16 : 32; }

// What a dkdv launch sums: dV (1), dK (2) or both (3).  At D 128 the two
// running sums would take 128 registers a thread and spill, so dV and dK
// get a launch each there (each recomputes P^T)
constexpr int kDV = 1, kDK = 2;

// dkdv: K and V hi / lo [T][D + 4], Q and dO hi / lo [TQ][D + 4], the raw
// stage [2][T][D + 4], and [2][TQ] ints of positions, log-sum-exps and Deltas
template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return ((6 * tile<D>() + 4 * qtile<D>()) * (D + 4) + 6 * qtile<D>()) * 4;
}

// dq: Q, dO, K and V hi / lo and the raw stage's two, each [T][D + 4], and
// the tiles' key positions [2][T]
template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (10 * tile<D>() * (D + 4) + 2 * tile<D>()) * 4;
}

// --------------------------------------------------------------- 1. prep
template <int D>
__global__ void __launch_bounds__(kPrepThreads) bwd_f32_prep(Params p) {
  const int tid = threadIdx.x, row = tid >> 2, j = tid & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qrs = (long long)p.H * D;
  const long long qoff = (long long)b * p.Sq * qrs + (long long)h * D;
  const int r = blockIdx.x * kPrepRows + row;
  float part = 0.f;
  if (r < p.Sq) {
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(p.o + qoff + r * qrs + 16 * i + 4 * j);
      const float4 y =
          *reinterpret_cast<const float4*>(p.dout + qoff + r * qrs + 16 * i + 4 * j);
      part = fmaf(x.x, y.x, part);
      part = fmaf(x.y, y.y, part);
      part = fmaf(x.z, y.z, part);
      part = fmaf(x.w, y.w, part);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  if (r < p.Sq && j == 0) p.delta[((long long)b * p.H + h) * p.Sq + r] = part;
}

// ------------------------------------------------------------ 2. dK, dV
template <int D, int kSum>
__global__ void __launch_bounds__(2 * tile<D>()) bwd_f32_dkdv(Params p) {
  constexpr int T = tile<D>(), TQ = qtile<D>(), NT = 2 * T, LD = D + 4, NB = TQ / 8;
  constexpr int DB = D / 8, CW = D == 128 ? 2 : 4;  // dim blocks of a tile product's accumulator
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* Kh = reinterpret_cast<uint32_t*>(smem);  // [T][LD] each
  uint32_t* Kl = Kh + T * LD;
  uint32_t* Vh = Kl + T * LD;
  uint32_t* Vl = Vh + T * LD;
  uint32_t* Qh = Vl + T * LD;                         // [TQ][LD] each
  uint32_t* Ql = Qh + TQ * LD;
  uint32_t* Oh = Ql + TQ * LD;  // dO
  uint32_t* Ol = Oh + TQ * LD;
  float* Qr = reinterpret_cast<float*>(Ol + TQ * LD);  // the raw stage: K then Q
  float* Or = Qr + T * LD;                             // V then dO
  int* qp_s = reinterpret_cast<int*>(Or + T * LD);     // [2][TQ]
  float* lse_s = reinterpret_cast<float*>(qp_s + 2 * TQ);
  float* dl_s = lse_s + 2 * TQ;
  int* live = reinterpret_cast<int*>(dl_s + 2 * TQ);   // [q tiles + 3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int hk = blockIdx.x, b = blockIdx.y, G = p.H / p.KV;
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const long long kvoff = (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int k0 = blockIdx.z * T, wr = warp * 16;
  const int* qpos = p.qpos + b * p.qpos_bs;
  int krow[2], kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    krow[i] = k0 + wr + g + 8 * i;
    kp[i] = krow[i] < p.Skv ? p.kvpos[b * p.kvpos_bs + krow[i]] : kPadPos;
  }

  stage<D, T, NT>(Qr, p.k + kvoff, kvrs, k0, p.Skv, tid);
  stage<D, T, NT>(Or, p.v + kvoff, kvrs, k0, p.Skv, tid);
  ssd::cp_async_commit();
  const int nlive = flash::live_q_tiles<TQ, T, NT>(
      qpos, p.Sq, p.kvpos + b * p.kvpos_bs, k0, p.Skv, p.causal, p.window, live,
      live + (p.Sq + TQ - 1) / TQ);
  ssd::cp_async_wait_all();
  split_staged<D, T, NT>(Qr, Kh, Kl, tid);
  split_staged<D, T, NT>(Or, Vh, Vl, tid);

  // the (head of the group, live q tile) of step n: Q and dO rows into the
  // raw stage, their positions, log-sum-exps and Deltas into buffer n & 1
  auto load = [&](int n) {
    const int h = hk * G + n / nlive, q0 = (live[n % nlive] >> 1) * TQ;
    const long long off = (long long)b * p.Sq * qrs + (long long)h * D;
    stage<D, TQ, NT>(Qr, p.q + off, qrs, q0, p.Sq, tid);
    stage<D, TQ, NT>(Or, p.dout + off, qrs, q0, p.Sq, tid);
    if (tid < TQ) {
      const int r = q0 + tid, at = (n & 1) * TQ + tid;
      const long long rr = ((long long)b * p.H + h) * p.Sq + r;
      qp_s[at] = r < p.Sq ? qpos[r] : 0;
      lse_s[at] = r < p.Sq ? p.lse[rr] : INFINITY;  // P = 0 on a missing row
      dl_s[at] = r < p.Sq ? p.delta[rr] : 0.f;
    }
  };

  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[db][e] = dv[db][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

  if (nlive > 0) load(0);
  ssd::cp_async_commit();
  for (int hh = 0; hh < G; ++hh) {  // every head of the group, in order
    for (int t = 0; t < nlive; ++t) {
      const int n = hh * nlive + t;
      ssd::cp_async_wait_all();
      __syncthreads();  // every warp is done with the previous tile's operands
      split_staged<D, TQ, NT>(Qr, Qh, Ql, tid);
      split_staged<D, TQ, NT>(Or, Oh, Ol, tid);
      if (n + 1 < G * nlive) load(n + 1);
      ssd::cp_async_commit();
      __syncthreads();
      const bool full = !(live[t] & 1);
      const int* qp = qp_s + (n & 1) * TQ;
      const float* lse = lse_s + (n & 1) * TQ;
      const float* dl = dl_s + (n & 1) * TQ;

      // P^T = exp2(K Q^T sl2 - lse): the warp's 16 keys x TQ queries
      float pt[NB][4];
      rows_dot<D, NB>(pt, Kh, Kl, wr, Qh, Ql, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * c + (e & 1);
          const bool ok = full || attend(qp[col], kp[e >> 1], p.causal, p.window);
          pt[nb][e] = ok ? exp2_approx(fmaf(pt[nb][e], sl2, -lse[col])) : 0.f;
        }
      }
      if (kSum & kDV)  // dV += P^T dO
        tile_product<D, NB, CW>(dv, pt, Oh, Ol, g, c, {1.f, 1.f});
      if (kSum & kDK) {
        // dS^T = P^T o (dP^T - Delta), dP^T = V dO^T
        float dpt[NB][4];
        rows_dot<D, NB>(dpt, Vh, Vl, wr, Oh, Ol, lane);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nb * 8 + 2 * c + (e & 1);
            pt[nb][e] *= dpt[nb][e] - dl[col];
          }
        }
        tile_product<D, NB, CW>(dk, pt, Qh, Ql, g, c, {1.f, 1.f});  // dK += dS^T Q
      }
    }
  }
  ssd::cp_async_wait_all();
  if (kSum & kDK) store_rows<D>(p.dk + kvoff, kvrs, krow, p.Skv, dk, {p.scale, p.scale}, c);
  if (kSum & kDV) store_rows<D>(p.dv + kvoff, kvrs, krow, p.Skv, dv, {1.f, 1.f}, c);
}

// ------------------------------------------------------------------ 3. dQ
template <int D>
__global__ void __launch_bounds__(2 * tile<D>()) bwd_f32_dq(Params p) {
  constexpr int T = tile<D>(), NT = 2 * T, LD = D + 4, NB = T / 8, DB = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* Qh = reinterpret_cast<uint32_t*>(smem);  // [T][LD] each
  uint32_t* Ql = Qh + T * LD;
  uint32_t* Oh = Ql + T * LD;  // dO
  uint32_t* Ol = Oh + T * LD;
  uint32_t* Kh = Ol + T * LD;
  uint32_t* Kl = Kh + T * LD;
  uint32_t* Vh = Kl + T * LD;
  uint32_t* Vl = Vh + T * LD;
  float* Kr = reinterpret_cast<float*>(Vl + T * LD);  // the raw stage: Q then K
  float* Vr = Kr + T * LD;                            // dO then V
  int* kvp_s = reinterpret_cast<int*>(Vr + T * LD);   // [2][T]
  int* live = kvp_s + 2 * T;                          // [key tiles + 3]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int hk = h / (p.H / p.KV);
  const long long qrs = (long long)p.H * D, kvrs = (long long)p.KV * D;
  const long long qoff = (long long)b * p.Sq * qrs + (long long)h * D;
  const long long kvoff = (long long)b * p.Skv * kvrs + (long long)hk * D;
  const int q0 = qt * T, wr = warp * 16;
  int row[2], qp[2];
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + wr + g + 8 * i;
    const bool ok = row[i] < p.Sq;
    const long long rr = ((long long)b * p.H + h) * p.Sq + row[i];
    qp[i] = ok ? p.qpos[b * p.qpos_bs + row[i]] : 0;
    lse[i] = ok ? p.lse[rr] : INFINITY;
    dl[i] = ok ? p.delta[rr] : 0.f;
  }

  stage<D, T, NT>(Kr, p.q + qoff, qrs, q0, p.Sq, tid);
  stage<D, T, NT>(Vr, p.dout + qoff, qrs, q0, p.Sq, tid);
  ssd::cp_async_commit();
  const int ntiles = flash::live_tiles<T, T, NT>(
      p.qpos + b * p.qpos_bs, q0, p.Sq, p.kvpos + b * p.kvpos_bs, p.Skv, p.causal, p.window,
      live, live + (p.Skv + T - 1) / T);
  ssd::cp_async_wait_all();
  split_staged<D, T, NT>(Kr, Qh, Ql, tid);
  split_staged<D, T, NT>(Vr, Oh, Ol, tid);

  auto load = [&](int t) {
    const int n0 = (live[t] >> 1) * T;
    stage<D, T, NT>(Kr, p.k + kvoff, kvrs, n0, p.Skv, tid);
    stage<D, T, NT>(Vr, p.v + kvoff, kvrs, n0, p.Skv, tid);
    if (tid < T) {
      const int n = n0 + tid;
      kvp_s[(t & 1) * T + tid] = n < p.Skv ? p.kvpos[b * p.kvpos_bs + n] : kPadPos;
    }
  };

  float dq[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) dq[db][0] = dq[db][1] = dq[db][2] = dq[db][3] = 0.f;
  const float sl2 = p.scale * kLog2e;

  if (ntiles > 0) load(0);
  ssd::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    ssd::cp_async_wait_all();
    __syncthreads();
    split_staged<D, T, NT>(Kr, Kh, Kl, tid);
    split_staged<D, T, NT>(Vr, Vh, Vl, tid);
    if (t + 1 < ntiles) load(t + 1);
    ssd::cp_async_commit();
    __syncthreads();
    const bool full = !(live[t] & 1);
    const int* kvp = kvp_s + (t & 1) * T;

    // dS = P o (dP - Delta), P = exp2(Q K^T sl2 - lse), dP = dO V^T
    float s[NB][4], dp[NB][4];
    rows_dot<D, NB>(s, Qh, Ql, wr, Kh, Kl, lane);
    rows_dot<D, NB>(dp, Oh, Ol, wr, Vh, Vl, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok =
            full || attend(qp[i], kvp[nb * 8 + 2 * c + (e & 1)], p.causal, p.window);
        s[nb][e] = ok ? exp2_approx(fmaf(s[nb][e], sl2, -lse[i])) * (dp[nb][e] - dl[i]) : 0.f;
      }
    }
    tile_product<D, NB>(dq, s, Kh, Kl, g, c, {1.f, 1.f});  // dQ += dS K
  }
  store_rows<D>(p.dq + qoff, qrs, row, p.Sq, dq, {p.scale, p.scale}, c);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
                   cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_all(const Params& p, cudaStream_t st) {
  constexpr int T = tile<D>();
  static_assert(D % 16 == 0, "float4 groups of 4 lanes x 4 dims; k-steps in pairs");
  cudaError_t e = launch(bwd_f32_prep<D>, dim3((p.Sq + kPrepRows - 1) / kPrepRows, p.H, p.B),
                         kPrepThreads, 0, p, st);
  if (e != cudaSuccess) return e;
  const dim3 kgrid(p.KV, p.B, (p.Skv + T - 1) / T);
  const int ksmem = dkdv_smem_bytes<D>() + list_bytes(p.Sq, qtile<D>());
  if constexpr (D == 128) {
    e = launch(bwd_f32_dkdv<D, kDV>, kgrid, 2 * T, ksmem, p, st);
    if (e != cudaSuccess) return e;
    e = launch(bwd_f32_dkdv<D, kDK>, kgrid, 2 * T, ksmem, p, st);
  } else {
    e = launch(bwd_f32_dkdv<D, kDV | kDK>, kgrid, 2 * T, ksmem, p, st);
  }
  if (e != cudaSuccess) return e;
  return launch(bwd_f32_dq<D>, dim3(p.H, p.B, (p.Sq + T - 1) / T), 2 * T,
                dq_smem_bytes<D>() + list_bytes(p.Skv, T), p, st);
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
