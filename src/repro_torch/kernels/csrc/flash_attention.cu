// Cache-free GQA attention forward for Hopper (sm_90a): the attention of
// every layer of a training forward.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _attn_kernel).  Same function: q (B, Sq, H, D), k/v (B, Sk, K,
// D), query head h reads kv head h / (H / K); causal or bidirectional,
// sliding window, logit softcap, keys past Sk masked (the reference pads
// to its block sizes and masks with sk_actual), f32 online softmax, output
// acc / max(l, 1e-30) in q's dtype.  It also writes the f32 log-sum-exp
// lse (B, H, Sq) = m + log(l) of each query row, which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.
//
// What bounds it on the card: operations.  At the training shape (B=2,
// S=2048, H=24, K=8, D=128, causal) the QK and PV products are
// 4 * D * (causal pairs) = 5.2e10 operations, 0.052 ms at the bf16
// tensor-core peak, against ~67 MB of q, k, v, out (0.02 ms).
//
// What the design does (a first, simple kernel; see flash_attention.cuh
// for the tiling):
//   * the TPU's sequential ("arbitrary") kv grid axis becomes a loop inside
//     the block: a block owns (b, h, 64-row query tile), keeps each row's
//     running max, sum and (64 x D) accumulator in registers and walks the
//     64-row key tiles the mask leaves visible -- fully masked tiles
//     (causality, window) are never loaded, as the reference skips them;
//   * each key/value tile is staged once per block by cp.async into
//     shared memory and feeds all 64 query rows;
//   * both products run on the CUDA cores in f32 (register-tiled 4 x 4
//     and 4 x D/16 patches per thread): bf16 inputs, f32 accumulation.
// Known limit, the first thing to fix: the products do not use the tensor
// cores (mma.sync / wgmma), so the kernel sits far above its bound.

#include "flash_attention.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int K,
                int causal, float scale, float softcap, int window) {
  using Lay = FaLayout<T, D>;
  constexpr int ST = Lay::STRIDE, DPT = Lay::DPT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + FA_TILE * ST;
  T* vs = ks + FA_TILE * ST;
  float* ps = reinterpret_cast<float*>(vs + FA_TILE * ST);   // P of the tile, [q][k]

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  stage_rows<T, D>(qs, q, b, q0, Sq, H, h);
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[r][e] = 0.f;
  }

  int lo, hi;
  key_range(q0, Sq, Sk, causal, window, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += FA_TILE) {
    stage_rows<T, D>(ks, k, b, k0, Sk, K, kh);
    stage_rows<T, D>(vs, v, b, k0, Sk, K, kh);
    cp_async_wait_all();
    __syncthreads();

    float s[4][4];
    dot_tile<T, D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      bool ok[4];
      float x[4], tmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t;
        ok[c] = visible(qp, k0 + tx + 16 * c, Sq, Sk, causal, window);
        x[c] = cap_logit(s[r][c], scale, softcap, &t);
        if (ok[c]) tmax = fmaxf(tmax, x[c]);
      }
      const float mn = fmaxf(m[r], row_max16(tmax));
      const float alpha = expf(m[r] - mn);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(x[c] - mn) : 0.f;
        psum += p;
        ps[(ty * 4 + r) * FA_SSTRIDE + tx + 16 * c] = p;
      }
      l[r] = l[r] * alpha + row_sum16(psum);
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

    // acc[r][:] += sum_j P[row][j] * V[j][tx*DPT ..]
#pragma unroll 4
    for (int j = 0; j < FA_TILE; ++j) {
      float vf[DPT];
      const T* vr = vs + j * ST + tx * DPT;
#pragma unroll
      for (int e = 0; e < DPT; ++e) vf[e] = to_f(vr[e]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = ps[(ty * 4 + r) * FA_SSTRIDE + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[r][e] += p * vf[e];
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();   // the q tile, when no key tile was visible

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o = out + (((size_t)b * Sq + qp) * H + h) * D + tx * DPT;
#pragma unroll
    for (int e = 0; e < DPT; ++e) o[e] = from_f<T>(acc[r][e] * inv);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qp] = l[r] > 0.f ? m[r] + logf(l[r]) : NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int Sq, int Sk, int H, int K, int causal, float scale,
                       float softcap, int window, cudaStream_t stream) {
  using Lay = FaLayout<T, D>;
  auto kern = attn_fwd_kernel<T, D>;
  const size_t smem = 3 * Lay::tile_bytes + Lay::score_bytes;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H, K, causal, scale, softcap,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_dim(const void* q, const void* k, const void* v, void* out, void* lse,
                           int B, int Sq, int Sk, int H, int K, int D, int causal, float scale,
                           float softcap, int window, cudaStream_t st) {
  switch (D) {
    case 32:    // the reduced configs
      return launch_fwd<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, st);
    case 64:
      return launch_fwd<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, st);
    case 128:
      return launch_fwd<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                                window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, K, D) -> out (B, Sq, H, D), lse (B, H, Sq) f32.
// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 and window <= 0 mean
// none.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int Sq, int Sk, int H, int K, int D,
                                   int dtype, int causal, float scale, float softcap,
                                   int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_dim<float>(q, k, v, out, lse, B, Sq, Sk, H, K, D, causal, scale,
                                      softcap, window, st);
  if (dtype == 1)
    return (int)launch_fwd_dim<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, K, D, causal,
                                              scale, softcap, window, st);
  return (int)cudaErrorInvalidValue;
}
