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
// Query offset: query row i sits at position qoff + i over keys 0..Sk-1,
// and causality and the window count from that position.  A rank of the
// sequence-parallel forward holds query rows [r S/n, (r+1) S/n) and the
// keys gathered up to its last row, so it passes qoff = r S/n.  The
// offset shifts the visible key tiles and the masked edge tiles (the
// mask is flash_attention.cuh's).  The bf16 kernels are compiled with and
// without the offset's arithmetic (OFF), and qoff = 0 runs the kernel as
// it was: the same code, outputs bit for bit and the same time.
//
// What bounds it on the card: operations.  At the training shape (B=2,
// S=2048, H=24, K=8, D=128, causal) the QK and PV products are
// 4 * D * (causal pairs) = 5.2e10 operations, 0.052 ms at the bf16
// tensor-core peak, against ~67 MB of q, k, v, out (0.02 ms).
//
// bf16: the tensor cores (attn_fwd_tc_kernel; building blocks in
// hopper.cuh).  A block owns (b, h, 128 query rows) as two warpgroups of
// 64 rows and walks the key tiles of 128 rows that the mask leaves
// visible; fully masked tiles (causality, window) are never loaded, and
// only tiles on the diagonal, the window's edge or past Sk are masked.
//   * Staging: thread 0 loads the q tile and each key/value tile by TMA
//     into a ring of 2 stages completed on mbarriers, so the next tile's
//     copy runs under this tile's products; rows past Sq / Sk arrive as
//     zeros.  The grid runs the query tiles with the most key tiles first.
//   * S = Q K^T is one chain of wgmma from shared memory (both K-major);
//     the online softmax (log2 domain) runs on the accumulator fragment in
//     registers, with no score tile in shared memory.
//   * P V: P feeds wgmma as the register A operand, V the shared-memory
//     MN-major B operand.  Rounding P to bf16 would break the check's one
//     bf16 ulp per entry, so P goes in as two bf16 parts, hi = bf16(P) and
//     lo = bf16(P - hi), two products summed in f32: 6 * D * pairs
//     operations in all (0.078 ms at the peak).  Q K^T takes bf16 inputs
//     and is exact in f32.
// What still bounds it: the block's two warpgroups run the S product, the
// softmax and the P V product in turn (no overlap of one tile's softmax
// with the next tile's product, no producer warp, one __syncthreads per
// key tile), and the output is stored from registers.
//
// head_dim 256 (gemma2): the same kernel with 64-row key tiles.  At D =
// 256 two stages of 128-row K and V tiles and the q tile would take
// (128 + 4 * 128) * 256 * 2 B = 320 KiB of shared memory against the
// block's 227 KB; with 64-row key tiles they take 192 KiB, still two
// stages.  The accumulator of a warpgroup's 64 rows is 128 f32 registers
// a thread, and P V is one m64n256 wgmma per k-step (hopper.cuh).  The
// smaller key tile halves each S product's width, not its total work.
//
// head_dim 80 (hubert-xlarge, bidirectional).  A bf16 row of 80 columns is
// 160 bytes, not a whole number of the 128-byte swizzle's boxes, and the
// descriptors' k-steps assume whole boxes.  Of the two layouts that are
// right -- five 16-column boxes under the 32-byte swizzle, with new
// descriptor code and an m64n80 P V; or the rows read as 128-wide tiles
// -- the kernel takes the second: the tensor map is 80 columns wide, TMA
// zero-fills columns 80-127 of each tile's second box, the D = 128 kernel
// runs on them unchanged (zero columns add nothing to S; P V's columns
// 80-127 come out zero) and only the 80 columns are stored.  It reuses
// the descriptors and tiles every D = 128 check has held, with no new
// swizzle mode whose misreading would pass silently, at 128/80 = 1.6x the
// operations (S and P V both run 128 wide); the bound is reckoned at D =
// 80, so the time shows that price.
//
// float32 (the checks and the f32 parity step): attn_fwd_kernel on the CUDA
// cores (tiling in flash_attention.cuh), f32 products throughout; TF32
// would not meet the f32 checks' 1e-5.  At D = 256 its three 64-row tiles
// and the score tile take 216,320 B, within the 227 KB.  At D = 80 a thread
// owns 5 output columns (D / 16), and a row 20 16-byte vectors.

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int K,
                int causal, float scale, float softcap, int window, int qoff) {
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
  key_range(q0, Sq, Sk, causal, window, qoff, lo, hi);
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
        ok[c] = visible(qp, k0 + tx + 16 * c, Sq, Sk, causal, window, qoff);
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
                       float softcap, int window, int qoff, cudaStream_t stream) {
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
      window, qoff);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_dim(const void* q, const void* k, const void* v, void* out, void* lse,
                           int B, int Sq, int Sk, int H, int K, int D, int causal, float scale,
                           float softcap, int window, int qoff, cudaStream_t st) {
  switch (D) {
    case 32:    // the reduced configs
      return launch_fwd<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, qoff, st);
    case 64:
      return launch_fwd<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, qoff, st);
    case 80:    // hubert
      return launch_fwd<T, 80>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, qoff, st);
    case 128:
      return launch_fwd<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                                window, qoff, st);
    case 256:   // gemma2
      return launch_fwd<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                                window, qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;                // two warpgroups
constexpr int FW_BQ = 128, FW_STAGES = 2;

// key rows per tile: 128, and 64 at D = 256, where two stages of 128-row
// K and V tiles (256 KiB) would not fit the block's 227 KB
template <int D>
__host__ __device__ constexpr int fw_bk() {
  return D > 128 ? 64 : 128;
}
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_tc_smem() {
  return (size_t)(FW_BQ + 2 * FW_STAGES * fw_bk<D>()) * D * 2 + (1 + FW_STAGES) * 8 + 1024;
}

// D the tile's columns, DG <= D the tensors' (hubert: 80 in 128-wide tiles).
// OFF: the launch has a query offset; without one the kernel compiles with
// qoff the constant 0, the code it was before the offset (the backward's
// kernels spilled more with the offset's arithmetic: flash_attention_bwd.cu)
template <int D, int DG, bool OFF>
__global__ void __launch_bounds__(TC_THREADS, 1)
attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int K, int causal,
                   float scale, float softcap, int window, int qoff_in) {
  using bf16 = __nv_bfloat16;
  const int qoff = OFF ? qoff_in : 0;
  constexpr int FW_BK = fw_bk<D>();
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* ks = qs + FW_BQ * D;                   // FW_STAGES key tiles
  bf16* vs = ks + FW_STAGES * FW_BK * D;       // FW_STAGES value tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + FW_STAGES * FW_BK * D);  // q, then stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FW_BQ;   // most key tiles first
  const int kh = h / (H / K);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qw = q0 + 64 * wg;                           // the warpgroup's first row
  const int row = qw + 16 * warp + lane / 4;             // rows row, row + 8
  const int col = 2 * (lane % 4);                        // + 8j + e

  const int q_last = min(q0 + FW_BQ, Sq) - 1 + qoff;         // positions, not rows
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 + qoff - window + 1) / FW_BK * FW_BK : 0;
  const int n = hi > lo ? (hi - lo + FW_BK - 1) / FW_BK : 0;
  constexpr uint32_t KV_BYTES = 2u * FW_BK * D * 2;

  if (tid == 0) {
    for (int i = 0; i < 1 + FW_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bars[0], FW_BQ * D * 2);
    tma_tile<D>(qs, &q_map, &bars[0], h, q0, b, FW_BQ);
    for (int s = 0; s < FW_STAGES && s < n; ++s) {
      mbar_expect(&bars[1 + s], KV_BYTES);
      tma_tile<D>(ks + s * FW_BK * D, &k_map, &bars[1 + s], kh, lo + s * FW_BK, b, FW_BK);
      tma_tile<D>(vs + s * FW_BK * D, &v_map, &bars[1 + s], kh, lo + s * FW_BK, b, FW_BK);
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // running max (log2 units), sum
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < n; ++t) {
    const int st = t % FW_STAGES, k0 = lo + t * FW_BK;
    const bf16* kt = ks + st * FW_BK * D;
    const bf16* vt = vs + st * FW_BK * D;
    mbar_wait(&bars[1 + st], (t / FW_STAGES) & 1);

    float s[FW_BK / 2];
#pragma unroll
    for (int i = 0; i < FW_BK / 2; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor_desc<D>(qs, FW_BQ, 64 * wg, kk), kmajor_desc<D>(kt, FW_BK, 0, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // logits in log2 units; masked ones -inf (m2 starts finite, so no
    // inf - inf)
    const bool edge = k0 + FW_BK > Sk || (causal && k0 + FW_BK - 1 > qw + qoff) ||
                      (window > 0 && qw + qoff + 63 - k0 >= window);
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < FW_BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * i + e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          x *= LOG2E;
          if (edge && !visible(row + 8 * i, k0 + 8 * j + col + e, Sq, Sk, causal, window, qoff))
            x = -INFINITY;
          s[4 * j + 2 * i + e] = x;
          tmax[i] = fmaxf(tmax[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float mn = fmaxf(m2[i], tmax[i]);
      alpha[i] = exp2f(m2[i] - mn);
      m2[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < FW_BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * i + e] - m2[i]);
          l[i] += p;
          s[4 * j + 2 * i + e] = p;
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += P V with P as hi + lo
    uint32_t ph[FW_BK / 16][4], pl[FW_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk) {
      split_fragment(s, kk, ph[kk], pl[kk]);
      reg_fence(ph[kk]);
      reg_fence(pl[kk]);
    }
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk) {
      const uint64_t dv = mnmajor_desc<D>(vt, FW_BK, kk);
      wgmma_rs(o, ph[kk], dv, 1);
      wgmma_rs(o, pl[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);

    __syncthreads();   // both warpgroups are done with stage st
    if (tid == 0 && t + FW_STAGES < n) {
      const int kn = lo + (t + FW_STAGES) * FW_BK;
      mbar_expect(&bars[1 + st], KV_BYTES);
      tma_tile<D>(ks + st * FW_BK * D, &k_map, &bars[1 + st], kh, kn, b, FW_BK);
      tma_tile<D>(vs + st * FW_BK * D, &v_map, &bars[1 + st], kh, kn, b, FW_BK);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qp = row + 8 * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* dst = out + (((size_t)b * Sq + qp) * H + h) * DG + col;
#pragma unroll
    for (int j = 0; j < DG / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    if (lane % 4 == 0)
      lse[((size_t)b * H + h) * Sq + qp] = l[i] > 0.f ? (m2[i] + log2f(l[i])) * LN2 : NEG_INF;
  }
}

template <int D, int DG = D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
                          int B, int Sq, int Sk, int H, int K, int causal, float scale,
                          float softcap, int window, int qoff, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t e = tile_map<D>(&qm, q, B, Sq, H, FW_BQ, DG);
  if (e == cudaSuccess) e = tile_map<D>(&km, k, B, Sk, K, fw_bk<D>(), DG);
  if (e == cudaSuccess) e = tile_map<D>(&vm, v, B, Sk, K, fw_bk<D>(), DG);
  if (e != cudaSuccess) return e;
  auto kern = qoff ? attn_fwd_tc_kernel<D, DG, true> : attn_fwd_tc_kernel<D, DG, false>;
  static bool configured[2] = {false, false};
  e = allow_smem(kern, fwd_tc_smem<D>(), configured[qoff != 0]);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B, (Sq + FW_BQ - 1) / FW_BQ);
  kern<<<grid, TC_THREADS, fwd_tc_smem<D>(), stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Sk, H, K,
      causal, scale, softcap, window, qoff);
  return cudaGetLastError();
}

cudaError_t launch_fwd_tc_dim(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int H, int K, int D, int causal,
                              float scale, float softcap, int window, int qoff, cudaStream_t st) {
  switch (D) {
    case 32:    // the reduced configs
      return launch_fwd_tc<32>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, qoff, st);
    case 64:
      return launch_fwd_tc<64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                               window, qoff, st);
    case 80:    // hubert: 128-wide tiles, 80 columns read and stored
      return launch_fwd_tc<128, 80>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale,
                                    softcap, window, qoff, st);
    case 128:
      return launch_fwd_tc<128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                                window, qoff, st);
    case 256:   // gemma2
      return launch_fwd_tc<256>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, scale, softcap,
                                window, qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, K, D) -> out (B, Sq, H, D), lse (B, H, Sq) f32.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  softcap
// <= 0 and window <= 0 mean none.  qoff >= 0 is the position of query row 0
// (flash_attention.cuh).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int Sq, int Sk, int H, int K, int D,
                                   int dtype, int causal, float scale, float softcap,
                                   int window, int qoff, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0 || qoff < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd_dim<float>(q, k, v, out, lse, B, Sq, Sk, H, K, D, causal, scale,
                                      softcap, window, qoff, st);
  if (dtype == 1)
    return (int)launch_fwd_tc_dim(q, k, v, out, lse, B, Sq, Sk, H, K, D, causal, scale, softcap,
                                  window, qoff, st);
  return (int)cudaErrorInvalidValue;
}
