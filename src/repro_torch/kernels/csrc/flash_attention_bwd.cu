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
// dK and dV summed over the G query heads of each kv head.  With the
// forward's query offset (flash_attention.cu) query row i sits at position
// qoff + i: the dK/dV pass's first query tile for a key tile is the one
// holding position k0 (not row k0), the dQ pass's key range ends at
// position qoff + its last row, and the window counts from the positions.
//
// What bounds it on the card: operations.  At the training shape (B=2,
// S=2048, H=24, K=8, D=128, causal) it needs 10 * D * (causal pairs) =
// 1.3e11 operations, 2.5 x the forward's: 0.13 ms at the bf16 tensor-core
// peak, against ~100 MB of inputs and gradients (0.03 ms).
//
// What the design does (one C entry point, three kernels in turn on the
// caller's stream):
//   1. delta: one warp per (b, row, head) sums dO * O;
//   2. dK/dV: one block per (b, kv head, key tile).  It loops over the G
//      query heads of that kv head and the query tiles that can see the
//      key tile (causality and window skip the rest), recomputes S and dP
//      for each, and accumulates dK and dV in registers -- no atomics, a
//      fixed summation order, so the gradient is deterministic;
//   3. dQ: one block per (b, head, query tile), looping over the visible
//      key tiles like the forward, dQ in registers.
// S and dP are computed twice (once in each of 2 and 3), the price of
// keeping out of atomics: on the tensor cores that recompute costs ~0.05
// ms at the peak, and dQ summed by atomics would change from run to run.
//
// bf16: the tensor cores (attn_bwd_dkdv_tc_kernel, attn_bwd_dq_tc_kernel;
// building blocks in hopper.cuh).  Both kernels run two warpgroups of 64
// rows each; thread 0 loads the block's fixed tiles and, by TMA into a
// ring of 2 stages on mbarriers, the tiles it loops over, the next one
// under this one's products.
//   * dK/dV: a block owns 128 key rows (64 per warpgroup) and steps over
//     64-row query tiles: S^T = K Q^T and dP^T = V dO^T are wgmma from
//     shared memory (K-major), so P^T and dS^T land in the accumulator
//     layout that is the register A operand of dV += P^T dO and dK +=
//     dS^T Q, whose B operands are the same q and dO tiles read MN-major.
//     lse and delta of the step's rows are staged in shared memory.
//   * dQ: a block owns 128 query rows (64 per warpgroup) and steps over
//     64-row key tiles: S = Q K^T, dP = dO V^T, dQ += dS K (K MN-major).
//   * P and dS go to the tensor cores as hi = bf16(x) and lo = bf16(x -
//     hi), two products summed in f32 (one bf16 part would break the
//     check's one bf16 ulp per entry): S^T, dP^T 2D each, dV, dK 4D each,
//     S, dP 2D each, dQ 4D, so 20 * D * pairs operations (0.26 ms at the
//     peak).
// What still bounds it: as the forward, the products and the elementwise
// work of a step run in turn, and one __syncthreads per step.
//
// head_dim 256 (gemma2).  At D = 256 the D = 128 tiling would take 256 KiB
// of shared memory in each pass (227 KB a block) and 256 accumulator
// registers a thread in the dK/dV pass.  So:
//   * dK/dV: a block owns 64 key rows, shared by its two warpgroups; each
//     warpgroup owns 128 of the 256 columns of dK and dV (64 + 64 f32
//     registers a thread, as at D = 128), computes the step's full S^T and
//     dP^T (the price: 4 * D * pairs more operations than the minimum) and
//     multiplies P^T and dS^T into its columns of dO and q (m64n128 wgmma
//     on those columns' boxes).  K, V and two stages of q and dO: 192 KiB;
//   * dQ: as at D = 128, 128 query rows as two warpgroups of 64, a
//     warpgroup's dQ 128 registers a thread (one m64n256 wgmma per k-step),
//     with one stage of 64-row K and V tiles (192 KiB in all), so a key
//     tile's load no longer runs under the previous tile's products.
// D = 32, 64 and 128 compile to the kernels they were.
//
// head_dim 80 (hubert-xlarge).  As the forward (flash_attention.cu's note):
// q, k, v and dO are read as 128-wide tiles whose columns 80-127 TMA
// zero-fills, the D = 128 kernels run unchanged (the zero columns add
// nothing to S or dP, and dQ's, dK's and dV's columns 80-127 come out
// zero) and only 80 columns are stored.  Simpler than five 32-byte-swizzled
// boxes and new descriptors, at 1.6x the operations of every product; the
// bound is reckoned at D = 80.
//
// float32 (the checks and the f32 parity step): attn_bwd_dkdv_kernel and
// attn_bwd_dq_kernel on the CUDA cores (tiling in flash_attention.cuh), with
// the same structure and 64-row tiles, f32 products throughout.  At D = 256
// their four staged tiles do not fit, and attn_bwd_{dkdv,dq}_restage_kernel
// keep two, restaging them within a step.  At D = 80 the four tiles fit
// (119,296 B with the score tiles), a thread owning 5 columns.

#include "flash_attention.cuh"
#include "hopper.cuh"

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

// P and dS of a (query tile) x (key tile) pair into ps / dss ([q][k]),
// from this thread's patches of S = Q K^T and dP = dO V^T
__device__ __forceinline__ void write_probs(const float (&s)[4][4], const float (&dp)[4][4],
                                            const float* lse_s, const float* dl_s, float* ps,
                                            float* dss, int q0, int k0, int Sq, int Sk,
                                            int causal, float scale, float softcap,
                                            int window, int qoff) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      float t;
      const float x = cap_logit(s[r][c], scale, softcap, &t);
      const bool ok = visible(q0 + i, k0 + j, Sq, Sk, causal, window, qoff);
      const float p = ok ? expf(x - lse_s[i]) : 0.f;
      float ds = p * (dp[r][c] - dl_s[i]);
      if (softcap > 0.f) ds *= 1.f - t * t;
      ps[i * FA_SSTRIDE + j] = p;
      dss[i * FA_SSTRIDE + j] = ds;
    }
  }
}

// P and dS of one (query tile) x (key tile) pair, all four tiles staged
template <typename T, int D>
__device__ __forceinline__ void probs_and_dscores(const T* qs, const T* ks, const T* dos,
                                                  const T* vs, const float* lse_s,
                                                  const float* dl_s, float* ps, float* dss,
                                                  int q0, int k0, int Sq, int Sk, int causal,
                                                  float scale, float softcap, int window,
                                                  int qoff) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  dot_tile<T, D>(qs, ks, ty, tx, s);
  dot_tile<T, D>(dos, vs, ty, tx, dp);
  write_probs(s, dp, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal, scale, softcap, window, qoff);
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
                     int window, int qoff) {
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
  query_range(k0, Sq, Sk, causal, window, qoff, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = lo; q0 < hi; q0 += FA_TILE) {
      stage_rows<T, D>(qs, q, b, q0, Sq, H, h);
      stage_rows<T, D>(dos, dout, b, q0, Sq, H, h);
      stage_row_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, H);
      cp_async_wait_all();
      __syncthreads();
      probs_and_dscores<T, D>(qs, ks, dos, vs, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal,
                              scale, softcap, window, qoff);
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
                   int K, int causal, float scale, float softcap, int window, int qoff) {
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
  key_range(q0, Sq, Sk, causal, window, qoff, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += FA_TILE) {
    stage_rows<T, D>(ks, k, b, k0, Sk, K, kh);
    stage_rows<T, D>(vs, v, b, k0, Sk, K, kh);
    cp_async_wait_all();
    __syncthreads();
    probs_and_dscores<T, D>(qs, ks, dos, vs, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal,
                            scale, softcap, window, qoff);
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

// float32 at D = 256: the four 64-row tiles of the kernels above take
// 266,240 B with the score tiles, past the block's 227 KB.  These two
// keep two staged tiles and restage what a step needs in turn (S from q
// and k, then dP from dO and v, then the product's operand): the same
// sums in the same order, more tile loads.  f32 is the checks' and the
// parity step's dtype, not a training one.
template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
attn_bwd_dkdv_restage_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                             int K, int causal, float scale, float softcap, int window, int qoff) {
  using Lay = FaLayout<T, D>;
  constexpr int ST = Lay::STRIDE, DPT = Lay::DPT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);          // k, then v, then q
  T* tb = ta + FA_TILE * ST;                   // q, then dO
  float* ps = reinterpret_cast<float*>(tb + FA_TILE * ST);
  float* dss = ps + FA_TILE * FA_SSTRIDE;
  float* lse_s = dss + FA_TILE * FA_SSTRIDE;
  float* dl_s = lse_s + FA_TILE;

  const int k0 = blockIdx.x * FA_TILE, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float adk[4][DPT], adv[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adk[r][e] = adv[r][e] = 0.f;

  int lo, hi;
  query_range(k0, Sq, Sk, causal, window, qoff, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int q0 = lo; q0 < hi; q0 += FA_TILE) {
      float s[4][4], dp[4][4];
      stage_rows<T, D>(ta, k, b, k0, Sk, K, kh);
      stage_rows<T, D>(tb, q, b, q0, Sq, H, h);
      stage_row_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, H);
      cp_async_wait_all();
      __syncthreads();
      dot_tile<T, D>(tb, ta, ty, tx, s);
      __syncthreads();
      stage_rows<T, D>(ta, v, b, k0, Sk, K, kh);
      stage_rows<T, D>(tb, dout, b, q0, Sq, H, h);
      cp_async_wait_all();
      __syncthreads();
      dot_tile<T, D>(tb, ta, ty, tx, dp);
      write_probs(s, dp, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal, scale, softcap, window,
                  qoff);
      __syncthreads();
      stage_rows<T, D>(ta, q, b, q0, Sq, H, h);
      cp_async_wait_all();
      __syncthreads();
      // dV[j][:] += sum_i P[i][j] dO[i][:];  dK[j][:] += sum_i dS[i][j] Q[i][:]
#pragma unroll 4
      for (int i = 0; i < FA_TILE; ++i) {
        float gf[DPT], qf[DPT];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          gf[e] = to_f(tb[i * ST + tx * DPT + e]);
          qf[e] = to_f(ta[i * ST + tx * DPT + e]);
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
attn_bwd_dq_restage_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, int Sq, int Sk, int H, int K, int causal,
                           float scale, float softcap, int window, int qoff) {
  using Lay = FaLayout<T, D>;
  constexpr int ST = Lay::STRIDE, DPT = Lay::DPT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ta = reinterpret_cast<T*>(smem);          // q, then dO
  T* tb = ta + FA_TILE * ST;                   // k, then v, then k
  float* ps = reinterpret_cast<float*>(tb + FA_TILE * ST);
  float* dss = ps + FA_TILE * FA_SSTRIDE;
  float* lse_s = dss + FA_TILE * FA_SSTRIDE;
  float* dl_s = lse_s + FA_TILE;

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  stage_row_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, H);
  float adq[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < DPT; ++e) adq[r][e] = 0.f;

  int lo, hi;
  key_range(q0, Sq, Sk, causal, window, qoff, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += FA_TILE) {
    float s[4][4], dp[4][4];
    stage_rows<T, D>(ta, q, b, q0, Sq, H, h);
    stage_rows<T, D>(tb, k, b, k0, Sk, K, kh);
    cp_async_wait_all();
    __syncthreads();
    dot_tile<T, D>(ta, tb, ty, tx, s);
    __syncthreads();
    stage_rows<T, D>(ta, dout, b, q0, Sq, H, h);
    stage_rows<T, D>(tb, v, b, k0, Sk, K, kh);
    cp_async_wait_all();
    __syncthreads();
    dot_tile<T, D>(ta, tb, ty, tx, dp);
    write_probs(s, dp, lse_s, dl_s, ps, dss, q0, k0, Sq, Sk, causal, scale, softcap, window, qoff);
    __syncthreads();
    stage_rows<T, D>(tb, k, b, k0, Sk, K, kh);
    cp_async_wait_all();
    __syncthreads();
    // dQ[i][:] += sum_j dS[i][j] K[j][:]
#pragma unroll 4
    for (int j = 0; j < FA_TILE; ++j) {
      float kf[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) kf[e] = to_f(tb[j * ST + tx * DPT + e]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dss[(ty * 4 + r) * FA_SSTRIDE + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) adq[r][e] += ds * kf[e];
      }
    }
    __syncthreads();
  }

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
                       float scale, float softcap, int window, int qoff, cudaStream_t stream) {
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

  // four staged tiles, or two where four do not fit (f32 at D = 256)
  constexpr bool restage = 4 * Lay::tile_bytes + 2 * Lay::score_bytes > 227 * 1024;
  const size_t smem = (restage ? 2 : 4) * Lay::tile_bytes + 2 * Lay::score_bytes +
                      2 * FA_TILE * sizeof(float);
  // only the kernels the dims take are instantiated
  auto kv_kern = [] {
    if constexpr (restage) return attn_bwd_dkdv_restage_kernel<T, D>;
    else return attn_bwd_dkdv_kernel<T, D>;
  }();
  static bool kv_configured = false;
  e = allow_smem(kv_kern, smem, kv_configured);
  if (e != cudaSuccess) return e;
  dim3 kv_grid((Sk + FA_TILE - 1) / FA_TILE, K, B);
  kv_kern<<<kv_grid, FA_THREADS, smem, stream>>>(q_, k_, v_, g_, lse_, delta_,
                                                 static_cast<T*>(dk), static_cast<T*>(dv), Sq,
                                                 Sk, H, K, causal, scale, softcap, window, qoff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto q_kern = [] {
    if constexpr (restage) return attn_bwd_dq_restage_kernel<T, D>;
    else return attn_bwd_dq_kernel<T, D>;
  }();
  static bool q_configured = false;
  e = allow_smem(q_kern, smem, q_configured);
  if (e != cudaSuccess) return e;
  dim3 q_grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  q_kern<<<q_grid, FA_THREADS, smem, stream>>>(q_, k_, v_, g_, lse_, delta_,
                                               static_cast<T*>(dq), Sq, Sk, H, K, causal,
                                               scale, softcap, window, qoff);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dim(const void* q, const void* k, const void* v, const void* out,
                           const void* lse, const void* dout, void* dq, void* dk, void* dv,
                           void* delta, int B, int Sq, int Sk, int H, int K, int D, int causal,
                           float scale, float softcap, int window, int qoff, cudaStream_t st) {
  switch (D) {
    case 32:    // the reduced configs
      return launch_bwd<T, 32>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, qoff, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, qoff, st);
    case 80:    // hubert
      return launch_bwd<T, 80>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, qoff, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                                causal, scale, softcap, window, qoff, st);
    case 256:   // gemma2
      return launch_bwd<T, 256>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                                causal, scale, softcap, window, qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;                // two warpgroups
constexpr int KV_BQ = 64;                      // dK/dV pass: query step
constexpr int DQ_BQ = 128, DQ_BK = 64;         // dQ pass: query rows per block, key step
constexpr int BW_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

// The dK/dV pass at D = 256.  A warpgroup's dK and dV for 64 key rows
// would be 128 + 128 f32 registers a thread.  So the two warpgroups share
// the block's 64 key rows and each owns half of the 256 columns of dK and
// dV (64 + 64 registers, as at D = 128): both compute the step's S^T and
// dP^T over all 256 columns (twice the block's S^T and dP^T work), and each
// multiplies P^T and dS^T into its own columns of dO and q.  Below D = 256
// each warpgroup owns 64 of the block's 128 key rows and every column.
template <int D>
struct Dkdv {
  static constexpr bool SPLIT = D > 128;
  static constexpr int BK = SPLIT ? 64 : 128;   // key rows per block
  static constexpr int DC = SPLIT ? D / 2 : D;  // dK/dV columns per warpgroup
};

// The dQ pass takes one stage at D = 256: two stages of 64-row K and V
// tiles beside the 128-row q and dO tiles would take 256 KiB.
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D > 128 ? 1 : BW_STAGES;
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  return (size_t)(2 * Dkdv<D>::BK + 2 * BW_STAGES * KV_BQ) * D * 2 + 2 * BW_STAGES * KV_BQ * 4 +
         (1 + BW_STAGES) * 8 + 1024;
}
template <int D>
constexpr size_t dq_tc_smem() {
  return (size_t)(2 * DQ_BQ + 2 * dq_stages<D>() * DQ_BK) * D * 2 + (1 + dq_stages<D>()) * 8 +
         1024;
}

// p = exp(x - lse) on a visible entry (x the capped logit), and dS =
// p (dP - delta) times the softcap's 1 - tanh^2; in place of s and dp
__device__ __forceinline__ void probs_grad(float& s, float& dp, float scale, float softcap,
                                           float lse2, float dl, bool ok) {
  float x = s * scale, t = 0.f;
  if (softcap > 0.f) {
    t = tanhf(x / softcap);
    x = softcap * t;
  }
  const float p = ok ? exp2f(x * LOG2E - lse2) : 0.f;
  float ds = p * (dp - dl);
  if (softcap > 0.f) ds *= 1.f - t * t;
  s = p;
  dp = ds;
}

// D the tiles' columns, DG <= D the tensors' (hubert: 80 in 128-wide tiles).
// OFF: the launch has a query offset (qoff_in > 0).  The offset's mask
// arithmetic costs this kernel registers it has none of to spare (at D =
// 128: 56 bytes spilled a thread against 44, and the pass 10 % slower), so
// without an offset the kernel compiles with qoff the constant 0: the
// code, registers and time it had before the offset.
template <int D, int DG, bool OFF>
__global__ void __launch_bounds__(TC_THREADS, 1)
attn_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                        int Sk, int H, int K, int causal, float scale, float softcap,
                        int window, int qoff_in) {
  using bf16 = __nv_bfloat16;
  const int qoff = OFF ? qoff_in : 0;
  constexpr int KV_BK = Dkdv<D>::BK, DC = Dkdv<D>::DC;
  static_assert(DG == D || !Dkdv<D>::SPLIT, "narrow tensors only in unsplit tiles");
  constexpr int DCS = Dkdv<D>::SPLIT ? DC : DG;          // dK/dV columns stored
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* vs = ks + KV_BK * D;
  bf16* qs = vs + KV_BK * D;                   // BW_STAGES query tiles
  bf16* dos = qs + BW_STAGES * KV_BQ * D;      // BW_STAGES dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + BW_STAGES * KV_BQ * D);  // [stage][row], log2
  float* dl_s = lse_s + BW_STAGES * KV_BQ;                               // [stage][row]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + BW_STAGES * KV_BQ);  // k/v, then stages

  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * KV_BK;
  const int G = H / K;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kw = k0 + (Dkdv<D>::SPLIT ? 0 : 64 * wg);    // the warpgroup's first key row
  const int c0 = Dkdv<D>::SPLIT ? DC * wg : 0;           // ... and first dK/dV column
  const int row = kw + 16 * warp + lane / 4;             // key rows row, row + 8
  const int col = 2 * (lane % 4);                        // + 8j + e: query in the step

  const int k_last = min(k0 + KV_BK, Sk) - 1;
  const int qlo = causal ? (OFF ? max(0, k0 - qoff) / KV_BQ * KV_BQ : k0) : 0;
  const int qhi = window > 0 ? min(Sq, k_last + window - qoff) : Sq;
  const int nq = qhi > qlo ? (qhi - qlo + KV_BQ - 1) / KV_BQ : 0;
  const int n = G * nq;                                  // steps: (head, query tile)
  constexpr uint32_t STEP_BYTES = 2u * KV_BQ * D * 2;

  if (tid == 0) {
    for (int i = 0; i < 1 + BW_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bars[0], 2u * KV_BK * D * 2);
    tma_tile<D>(ks, &k_map, &bars[0], kh, k0, b, KV_BK);
    tma_tile<D>(vs, &v_map, &bars[0], kh, k0, b, KV_BK);
    for (int s = 0; s < BW_STAGES && s < n; ++s) {
      const int h = kh * G + s / nq, q0 = qlo + (s % nq) * KV_BQ;
      mbar_expect(&bars[1 + s], STEP_BYTES);
      tma_tile<D>(qs + s * KV_BQ * D, &q_map, &bars[1 + s], h, q0, b, KV_BQ);
      tma_tile<D>(dos + s * KV_BQ * D, &do_map, &bars[1 + s], h, q0, b, KV_BQ);
    }
  }
  // lse (log2 units) and delta of step t's query rows into stage t % 2;
  // zeros past Sq
  auto stage_stats = [&](int t) {
    if (t >= n || tid >= 2 * KV_BQ) return;
    const int h = kh * G + t / nq, qp = qlo + (t % nq) * KV_BQ + tid % KV_BQ;
    const size_t at = ((size_t)b * H + h) * Sq + qp;
    float* dst = tid < KV_BQ ? lse_s : dl_s;
    dst[(t % BW_STAGES) * KV_BQ + tid % KV_BQ] =
        qp < Sq ? (tid < KV_BQ ? lse[at] * LOG2E : delta[at]) : 0.f;
  };
  stage_stats(0);
  __syncthreads();

  float adk[DC / 2], adv[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) adk[i] = adv[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % BW_STAGES, q0 = qlo + (t % nq) * KV_BQ;
    const bf16* qt = qs + st * KV_BQ * D;
    const bf16* dot = dos + st * KV_BQ * D;
    mbar_wait(&bars[1 + st], (t / BW_STAGES) & 1);

    float s[KV_BQ / 2], dp[KV_BQ / 2];
#pragma unroll
    for (int i = 0; i < KV_BQ / 2; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor_desc<D>(ks, KV_BK, kw - k0, kk), kmajor_desc<D>(qt, KV_BQ, 0, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, kmajor_desc<D>(vs, KV_BK, kw - k0, kk), kmajor_desc<D>(dot, KV_BQ, 0, kk),
               kk > 0);
    wgmma_commit();
    stage_stats(t + 1);          // the next step's rows, under the products
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    const bool edge = kw + 63 >= Sk || q0 + KV_BQ > Sq || (causal && q0 + qoff < kw + 63) ||
                      (window > 0 && q0 + qoff + KV_BQ - 1 - kw >= window);
    const float* ls = lse_s + st * KV_BQ;
    const float* ds = dl_s + st * KV_BQ;
#pragma unroll
    for (int j = 0; j < KV_BQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col + e;
          const bool ok =
              !edge || visible(q0 + c, row + 8 * i, Sq, Sk, causal, window, qoff);
          probs_grad(s[4 * j + 2 * i + e], dp[4 * j + 2 * i + e], scale, softcap, ls[c], ds[c],
                     ok);
        }

    // dV += P^T dO, dK += dS^T Q, with P^T and dS^T as hi + lo
    uint32_t ph[KV_BQ / 16][4], pl[KV_BQ / 16][4], gh[KV_BQ / 16][4], gl[KV_BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      split_fragment(s, kk, ph[kk], pl[kk]);
      split_fragment(dp, kk, gh[kk], gl[kk]);
      reg_fence(ph[kk]);
      reg_fence(pl[kk]);
      reg_fence(gh[kk]);
      reg_fence(gl[kk]);
    }
    reg_fence(adv);
    reg_fence(adk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV_BQ / 16; ++kk) {
      // columns c0 .. c0 + DC of dO and q: the boxes from c0 / 64 on
      const uint64_t ddo = mnmajor_desc<D>(dot + c0 * KV_BQ, KV_BQ, kk);
      const uint64_t dq = mnmajor_desc<D>(qt + c0 * KV_BQ, KV_BQ, kk);
      wgmma_rs(adv, ph[kk], ddo, 1);
      wgmma_rs(adv, pl[kk], ddo, 1);
      wgmma_rs(adk, gh[kk], dq, 1);
      wgmma_rs(adk, gl[kk], dq, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(adv);
    reg_fence(adk);

    __syncthreads();   // both warpgroups are done with stage st (and its stats)
    if (tid == 0 && t + BW_STAGES < n) {
      const int tn = t + BW_STAGES;
      const int h = kh * G + tn / nq, qn = qlo + (tn % nq) * KV_BQ;
      mbar_expect(&bars[1 + st], STEP_BYTES);
      tma_tile<D>(qs + st * KV_BQ * D, &q_map, &bars[1 + st], h, qn, b, KV_BQ);
      tma_tile<D>(dos + st * KV_BQ * D, &do_map, &bars[1 + st], h, qn, b, KV_BQ);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = row + 8 * i;
    if (kp >= Sk) continue;
    const size_t at = (((size_t)b * Sk + kp) * K + kh) * DG + c0 + col;
#pragma unroll
    for (int j = 0; j < DCS / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(adk[4 * j + 2 * i] * scale, adk[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(adv[4 * j + 2 * i], adv[4 * j + 2 * i + 1]);
    }
  }
}

// OFF as the dK/dV pass's: without an offset, the kernel it was before
template <int D, int DG, bool OFF>
__global__ void __launch_bounds__(TC_THREADS, 1)
attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                      int Sk, int H, int K, int causal, float scale, float softcap, int window,
                      int qoff_in) {
  using bf16 = __nv_bfloat16;
  const int qoff = OFF ? qoff_in : 0;
  constexpr int BW_STAGES = dq_stages<D>();
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* dos = qs + DQ_BQ * D;
  bf16* ks = dos + DQ_BQ * D;                  // BW_STAGES key tiles
  bf16* vs = ks + BW_STAGES * DQ_BK * D;       // BW_STAGES value tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + BW_STAGES * DQ_BK * D);  // q/dO, stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BQ;   // most key tiles first
  const int kh = h / (H / K);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qw = q0 + 64 * wg;
  const int row = qw + 16 * warp + lane / 4;             // query rows row, row + 8
  const int col = 2 * (lane % 4);                        // + 8j + e: key in the step

  const int q_last = min(q0 + DQ_BQ, Sq) - 1 + qoff;         // positions, not rows
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 + qoff - window + 1) / DQ_BK * DQ_BK : 0;
  const int n = hi > lo ? (hi - lo + DQ_BK - 1) / DQ_BK : 0;
  constexpr uint32_t KV_BYTES = 2u * DQ_BK * D * 2;

  if (tid == 0) {
    for (int i = 0; i < 1 + BW_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bars[0], 2u * DQ_BQ * D * 2);
    tma_tile<D>(qs, &q_map, &bars[0], h, q0, b, DQ_BQ);
    tma_tile<D>(dos, &do_map, &bars[0], h, q0, b, DQ_BQ);
    for (int s = 0; s < BW_STAGES && s < n; ++s) {
      mbar_expect(&bars[1 + s], KV_BYTES);
      tma_tile<D>(ks + s * DQ_BK * D, &k_map, &bars[1 + s], kh, lo + s * DQ_BK, b, DQ_BK);
      tma_tile<D>(vs + s * DQ_BK * D, &v_map, &bars[1 + s], kh, lo + s * DQ_BK, b, DQ_BK);
    }
  }

  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row + 8 * i;
    const size_t at = ((size_t)b * H + h) * Sq + qp;
    lse2[i] = qp < Sq ? lse[at] * LOG2E : 0.f;
    dl[i] = qp < Sq ? delta[at] : 0.f;
  }
  float adq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adq[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % BW_STAGES, k0 = lo + t * DQ_BK;
    const bf16* kt = ks + st * DQ_BK * D;
    const bf16* vt = vs + st * DQ_BK * D;
    mbar_wait(&bars[1 + st], (t / BW_STAGES) & 1);

    float s[DQ_BK / 2], dp[DQ_BK / 2];
#pragma unroll
    for (int i = 0; i < DQ_BK / 2; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor_desc<D>(qs, DQ_BQ, 64 * wg, kk), kmajor_desc<D>(kt, DQ_BK, 0, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, kmajor_desc<D>(dos, DQ_BQ, 64 * wg, kk), kmajor_desc<D>(vt, DQ_BK, 0, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    reg_fence(dp);

    const bool edge = k0 + DQ_BK > Sk || (causal && k0 + DQ_BK - 1 > qw + qoff) ||
                      (window > 0 && qw + qoff + 63 - k0 >= window);
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok =
              !edge || visible(row + 8 * i, k0 + 8 * j + col + e, Sq, Sk, causal, window, qoff);
          probs_grad(s[4 * j + 2 * i + e], dp[4 * j + 2 * i + e], scale, softcap, lse2[i], dl[i],
                     ok);
        }

    // dQ += dS K with dS as hi + lo
    uint32_t gh[DQ_BK / 16][4], gl[DQ_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      split_fragment(dp, kk, gh[kk], gl[kk]);
      reg_fence(gh[kk]);
      reg_fence(gl[kk]);
    }
    reg_fence(adq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      const uint64_t dk = mnmajor_desc<D>(kt, DQ_BK, kk);
      wgmma_rs(adq, gh[kk], dk, 1);
      wgmma_rs(adq, gl[kk], dk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(adq);

    __syncthreads();   // both warpgroups are done with stage st
    if (tid == 0 && t + BW_STAGES < n) {
      const int kn = lo + (t + BW_STAGES) * DQ_BK;
      mbar_expect(&bars[1 + st], KV_BYTES);
      tma_tile<D>(ks + st * DQ_BK * D, &k_map, &bars[1 + st], kh, kn, b, DQ_BK);
      tma_tile<D>(vs + st * DQ_BK * D, &v_map, &bars[1 + st], kh, kn, b, DQ_BK);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row + 8 * i;
    if (qp >= Sq) continue;
    bf16* dst = dq + (((size_t)b * Sq + qp) * H + h) * DG + col;
#pragma unroll
    for (int j = 0; j < DG / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(adq[4 * j + 2 * i] * scale, adq[4 * j + 2 * i + 1] * scale);
  }
}

template <int D, int DG = D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* out,
                          const void* lse, const void* dout, void* dq, void* dk, void* dv,
                          void* delta, int B, int Sq, int Sk, int H, int K, int causal,
                          float scale, float softcap, int window, int qoff, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int KV_BK = Dkdv<D>::BK;
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;   // k128, v128: KV_BK rows
  cudaError_t e = tile_map<D>(&q64, q, B, Sq, H, KV_BQ, DG);
  if (e == cudaSuccess) e = tile_map<D>(&do64, dout, B, Sq, H, KV_BQ, DG);
  if (e == cudaSuccess) e = tile_map<D>(&k128, k, B, Sk, K, KV_BK, DG);
  if (e == cudaSuccess) e = tile_map<D>(&v128, v, B, Sk, K, KV_BK, DG);
  if (e == cudaSuccess) e = tile_map<D>(&q128, q, B, Sq, H, DQ_BQ, DG);
  if (e == cudaSuccess) e = tile_map<D>(&do128, dout, B, Sq, H, DQ_BQ, DG);
  if (e == cudaSuccess) e = tile_map<D>(&k64, k, B, Sk, K, DQ_BK, DG);
  if (e == cudaSuccess) e = tile_map<D>(&v64, v, B, Sk, K, DQ_BK, DG);
  if (e != cudaSuccess) return e;
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const int rows = B * Sq * H;
  attn_delta_kernel<bf16><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta_, rows, Sq, H, DG);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kv_kern = qoff ? attn_bwd_dkdv_tc_kernel<D, DG, true>
                      : attn_bwd_dkdv_tc_kernel<D, DG, false>;
  static bool kv_configured[2] = {false, false};
  e = allow_smem(kv_kern, dkdv_tc_smem<D>(), kv_configured[qoff != 0]);
  if (e != cudaSuccess) return e;
  dim3 kv_grid(K, B, (Sk + KV_BK - 1) / KV_BK);   // key tile 0 (most query tiles) first
  kv_kern<<<kv_grid, TC_THREADS, dkdv_tc_smem<D>(), stream>>>(
      q64, k128, v128, do64, lse_, delta_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
      Sk, H, K, causal, scale, softcap, window, qoff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto q_kern = qoff ? attn_bwd_dq_tc_kernel<D, DG, true>
                     : attn_bwd_dq_tc_kernel<D, DG, false>;
  static bool q_configured[2] = {false, false};
  e = allow_smem(q_kern, dq_tc_smem<D>(), q_configured[qoff != 0]);
  if (e != cudaSuccess) return e;
  dim3 q_grid(H, B, (Sq + DQ_BQ - 1) / DQ_BQ);
  q_kern<<<q_grid, TC_THREADS, dq_tc_smem<D>(), stream>>>(
      q128, k64, v64, do128, lse_, delta_, static_cast<bf16*>(dq), Sq, Sk, H, K, causal, scale,
      softcap, window, qoff);
  return cudaGetLastError();
}

cudaError_t launch_bwd_tc_dim(const void* q, const void* k, const void* v, const void* out,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int B, int Sq, int Sk, int H, int K, int D,
                              int causal, float scale, float softcap, int window, int qoff,
                              cudaStream_t st) {
  switch (D) {
    case 32:    // the reduced configs
      return launch_bwd_tc<32>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, qoff, st);
    case 64:
      return launch_bwd_tc<64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                               causal, scale, softcap, window, qoff, st);
    case 80:    // hubert: 128-wide tiles, 80 columns read and stored
      return launch_bwd_tc<128, 80>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                                    K, causal, scale, softcap, window, qoff, st);
    case 128:
      return launch_bwd_tc<128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                                causal, scale, softcap, window, qoff, st);
    case 256:   // gemma2
      return launch_bwd_tc<256>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K,
                                causal, scale, softcap, window, qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Inputs q/out/dout (B, Sq, H, D), k/v (B, Sk, K, D), lse (B, H, Sq) f32
// from the forward; outputs dq/dk/dv shaped and typed like q/k/v; delta is
// (B, H, Sq) f32 scratch.  dtype: 0 = float32 (CUDA cores), 1 = bfloat16
// (tensor cores).  softcap <= 0 and window <= 0 mean none.  qoff >= 0 is
// the position of query row 0 (flash_attention.cuh).  Returns the first
// cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta, int B, int Sq,
                                   int Sk, int H, int K, int D, int dtype, int causal,
                                   float scale, float softcap, int window, int qoff,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0 || qoff < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_dim<float>(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk,
                                      H, K, D, causal, scale, softcap, window, qoff, st);
  if (dtype == 1)
    return (int)launch_bwd_tc_dim(q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, K, D,
                                  causal, scale, softcap, window, qoff, st);
  return (int)cudaErrorInvalidValue;
}
