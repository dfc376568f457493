// Gradient of the cache-free GQA attention for Hopper (sm_90a): the
// attention backward of every layer of a training step.
//
// Replaces: XLA's autodiff of the reference's plain attention
// (repro/kernels/ref.py::attention_naive / attention_blockwise).  The
// Pallas forward (repro/kernels/flash_attention.py::flash_attention) has
// no VJP, so JAX training differentiates the plain attention; this kernel
// computes that same gradient from the forward's saved output and
// log-sum-exp (flash_attention.cu), by the FlashAttention formulas:
//   P  = exp(S - lse) on the visible keys     dV = P^T dO
//   dP = dO V^T                              dS = P * (dP - delta),
//   delta = rowsum(dO * O),  times 1 - tanh^2(s / c) under a softcap,
//   dQ = dS K * scale                        dK = dS^T Q * scale,
// dK and dV summed over the G query heads of each kv head.
//
// What bounds it on the card: operations.  At the training shape (B=2,
// S=2048, H=24, K=8, D=128, causal) it needs 10 * D * (causal pairs) =
// 1.3e11 operations, 2.5 x the forward's: 0.13 ms at the bf16 tensor-core
// peak, against ~100 MB of inputs and gradients (0.03 ms).
//
// What the design does (one C entry point, three kernels in turn on the
// caller's stream; tiling in flash_attention.cuh):
//   1. delta: one warp per (b, row, head) sums dO * O;
//   2. dK/dV: one block per (b, kv head, 64-row key tile).  It loops over
//      the G query heads of that kv head and the query tiles that can see
//      the key tile (causality and window skip the rest), recomputes S and
//      dP for each, and accumulates dK and dV in registers -- no atomics,
//      a fixed summation order, so the gradient is deterministic;
//   3. dQ: one block per (b, head, 64-row query tile), looping over the
//      visible key tiles like the forward, dQ in registers.
// S and dP are computed twice (once in each of 2 and 3): 14 * D * pairs
// operations instead of 10, the price of keeping out of atomics.  All
// products run on the CUDA cores in f32 (bf16 inputs, f32 accumulation);
// the tensor cores are later work.

#include "flash_attention.cuh"

namespace {

template <typename T>
__global__ void attn_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                  float* __restrict__ delta, int rows, int Sq, int H, int D) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;   // (b, q, h) order
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f(o[d]) * to_f(g[d]);
  s = warp_sum(s);
  const int h = row % H, qp = (row / H) % Sq, b = row / (H * Sq);
  if (lane == 0) delta[((size_t)b * H + h) * Sq + qp] = s;
}

// P and dS of one (query tile) x (key tile) pair into ps / dss ([q][k])
template <typename T, int D>
__device__ __forceinline__ void probs_and_dscores(const T* qs, const T* ks, const T* dos,
                                                  const T* vs, const float* lse_s,
                                                  const float* dl_s, float* ps, float* dss,
                                                  int q0, int k0, int Sq, int Sk, int causal,
                                                  float scale, float softcap, int window) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  dot_tile<T, D>(qs, ks, ty, tx, s);
  dot_tile<T, D>(dos, vs, ty, tx, dp);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float t;
      const float x = cap_logit(s[r][c], scale, softcap, &t);
      const bool ok = visible(q0 + i, k0 + j, Sq, Sk, causal, window);
      const float p = ok ? expf(x - lse_s[i]) : 0.f;
      float ds = p * (dp[r][c] - dl_s[i]);
      if (softcap > 0.f) ds *= 1.f - t * t;
      ps[i * FA_SSTRIDE + j] = p;
      dss[i * FA_SSTRIDE + j] = ds;
    }
  }
}

// lse and delta of query rows [q0, q0 + 64) of head h (0 past Sq)
__device__ __forceinline__ void stage_row_stats(float* lse_s, float* dl_s,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta, int b, int h,
                                                int q0, int Sq, int H) {
  for (int i = threadIdx.x; i < FA_TILE; i += FA_THREADS) {
    const int qp = q0 + i;
    const size_t at = ((size_t)b * H + h) * Sq + qp;
    lse_s[i] = qp < Sq ? lse[at] : 0.f;
    dl_s[i] = qp < Sq ? delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Sk, int H, int K, int causal, float scale, float softcap,
                     int window) {
  using Lay = FaLayout<T, D>;
  constexpr int ST = Lay::STRIDE, DPT = Lay::DPT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + FA_TILE * ST;
  T* qs = vs + FA_TILE * ST;
  T* dos = qs + FA_TILE * ST;
  float* ps = reinterpret_cast<float*>(dos + FA_TILE * ST);
  float* dss = ps + FA_TILE * FA_SSTRIDE;
  float* lse_s = dss + FA_TILE * FA_SSTRIDE;
  float* dl_s = lse_s + FA_TILE;

  const int k0 = blockIdx.x * FA_TILE, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage_rows<T, D>(ks, k, b, k0, Sk, K, kh);
  stage_rows<T, D>(vs, v, b, k0, Sk, K, kh);
  float adk[4][DPT], adv[4][DPT];   // key rows ty*4 + r, columns tx*DPT ..
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adk[r][e] = adv[r][e] = 0.f;

  int lo, hi;
  query_range(k0, Sq, Sk, causal, window, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = lo; q0 < hi; q0 += FA_TILE) {
      stage_rows<T, D>(qs, q, b, q0, Sq, H, h);
      stage_rows<T, D>(dos, dout, b, q0, Sq, H, h);
      stage_row_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, H);
      cp_async_wait_all();
      __syncthreads();
      probs_and_dscores<T, D>(qs, ks, dos, vs, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal,
                              scale, softcap, window);
      __syncthreads();
      // dV[j][:] += sum_i P[i][j] dO[i][:];  dK[j][:] += sum_i dS[i][j] Q[i][:]
#pragma unroll 4
      for (int i = 0; i < FA_TILE; ++i) {
        float gf[DPT], qf[DPT];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          gf[e] = to_f(dos[i * ST + tx * DPT + e]);
          qf[e] = to_f(qs[i * ST + tx * DPT + e]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = ps[i * FA_SSTRIDE + ty * 4 + r];
          const float ds = dss[i * FA_SSTRIDE + ty * 4 + r];
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            adv[r][e] += p * gf[e];
            adk[r][e] += ds * qf[e];
          }
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait_all();   // the key tile, when no query tile was visible

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= Sk) continue;
    const size_t at = (((size_t)b * Sk + kp) * K + kh) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      dk[at + e] = from_f<T>(adk[r][e] * scale);
      dv[at + e] = from_f<T>(adv[r][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H,
                   int K, int causal, float scale, float softcap, int window) {
  using Lay = FaLayout<T, D>;
  constexpr int ST = Lay::STRIDE, DPT = Lay::DPT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + FA_TILE * ST;
  T* ks = dos + FA_TILE * ST;
  T* vs = ks + FA_TILE * ST;
  float* ps = reinterpret_cast<float*>(vs + FA_TILE * ST);
  float* dss = ps + FA_TILE * FA_SSTRIDE;
  float* lse_s = dss + FA_TILE * FA_SSTRIDE;
  float* dl_s = lse_s + FA_TILE;

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage_rows<T, D>(qs, q, b, q0, Sq, H, h);
  stage_rows<T, D>(dos, dout, b, q0, Sq, H, h);
  stage_row_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, H);
  float adq[4][DPT];   // query rows ty*4 + r, columns tx*DPT ..
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adq[r][e] = 0.f;

  int lo, hi;
  key_range(q0, Sq, Sk, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += FA_TILE) {
    stage_rows<T, D>(ks, k, b, k0, Sk, K, kh);
    stage_rows<T, D>(vs, v, b, k0, Sk, K, kh);
    cp_async_wait_all();
    __syncthreads();
    probs_and_dscores<T, D>(qs, ks, dos, vs, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal,
                            scale, softcap, window);
    __syncthreads();
    // dQ[i][:] += sum_j dS[i][j] K[j][:]
#pragma unroll 4
    for (int j = 0; j < FA_TILE; ++j) {
      float kf[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) kf[e] = to_f(ks[j * ST + tx * DPT + e]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dss[(ty * 4 + r) * FA_SSTRIDE + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) adq[r][e] += ds * kf[e];
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();   // the query tile, when no key tile was visible

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= Sq) continue;
    T* o = dq + (((size_t)b * Sq + qp) * H + h) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[e] = from_f<T>(adq[r][e] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       void* delta, int B, int Sq, int Sk, int H, int K, int causal,
                       float scale, float softcap, int window, cudaStream_t stream) {
  using Lay = FaLayout<T, D>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const int rows = B * Sq * H;
  attn_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const T*>(out), g_,
                                                           delta_, rows, Sq, H, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem = 4 * Lay::tile_bytes + 2 * Lay::score_bytes + 2 * FA_TILE * sizeof(float);
  auto kv_kern = attn_bwd_dkdv_kernel<T, D>;
  static bool kv_configured = false;
  e = allow_smem(kv_kern, smem, kv_configured);
  if (e != cudaSuccess) return e;
  dim3 kv_grid((Sk + FA_TILE - 1) / FA_TILE, K, B);
  kv_kern<<<kv_grid, FA_THREADS, smem, stream>>>(q_, k_, v_, g_, lse_, delta_,
                                                 static_cast<T*>(dk), static_cast<T*>(dv), Sq,
                                                 Sk, H, K, causal, scale, softcap, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto q_kern = attn_bwd_dq_kernel<T, D>;
  static bool q_configured = false;
  e = allow_smem(q_kern, smem, q_configured);
  if (e != cudaSuccess) return e;
  dim3 q_grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  q_kern<<<q_grid, FA_THREADS, smem, stream>>>(q_, k_, v_, g_, lse_, delta_,
                                               static_cast<T*>(dq), Sq, Sk, H, K, causal,
                                               scale, softcap, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dim(const void* q, const void* k, const void* v, const void* out,
                           const void* lse, const void* dout, void* dq, void* dk, void* dv,
                           void* delta, int B, int Sq, int Sk, int H, int K, int D, int causal,
                           float scale, float softcap, int window, cudaStream_t st) {
  switch (D) {
    case 32:    // the reduced configs
      return launch_bwd<T, 32>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                                causal, scale, softcap, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Inputs q/out/dout (B, Sq, H, D), k/v (B, Sk, K, D), lse (B, H, Sq) f32
// from the forward; outputs dq/dk/dv shaped and typed like q/k/v; delta is
// (B, H, Sq) f32 scratch.  dtype: 0 = float32, 1 = bfloat16.  softcap <= 0
// and window <= 0 mean none.  Returns the first cudaError_t of the three
// launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta, int B, int Sq,
                                   int Sk, int H, int K, int D, int dtype, int causal,
                                   float scale, float softcap, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_dim<float>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk,
                                      H, K, D, causal, scale, softcap, window, st);
  if (dtype == 1)
    return (int)launch_bwd_dim<__nv_bfloat16>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                                              Sq, Sk, H, K, D, causal, scale, softcap, window,
                                              st);
  return (int)cudaErrorInvalidValue;
}
