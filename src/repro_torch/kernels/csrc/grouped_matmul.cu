// Grouped (expert) matmul for Hopper (sm_90a).
//
// Replaces: repro/kernels/grouped_matmul.py::grouped_matmul (the Pallas TPU
// kernel _gmm_kernel).  Same function as its oracle grouped_matmul_ref:
// out[g] = lhs[g] @ rhs[g] for (G, M, K) x (G, K, N) -> (G, M, N), every
// product summed in float32 and rounded once to lhs's dtype.  The TPU kernel
// padded M, K and N to its (128, 512, 512) blocks and carried the f32 sum
// across a sequential K grid axis in VMEM scratch; here each block loops
// over K itself and masks the ragged M edge, so nothing is padded or cut.
//
// What bounds it on the card: bytes.  On the MoE serving path M is the
// expert capacity, which is tiny.  For olmoe (G = 64; K x N = 2048 x 1024
// for gate and up, 1024 x 2048 for down) every call reads 268 MB of expert
// weights (80 us at 3.35 TB/s) for M = ceil(S * 8 * 1.25 / 64) rows per
// group: 2 at a batch-8 decode step, 1 to 40 at the prefill chunks of 1 to
// 256 rows.  At M = 40 the products are 10.7 GFLOP, 11 us at the bf16
// tensor-core peak but 0.16 ms on the CUDA cores' f32 FMAs (67 TFLOP/s), so
// the products must run on the tensor cores for the bytes to bound it.
//
// bf16: the tensor cores (grouped_matmul_tc_kernel; building blocks in
// hopper.cuh).  The operands are swapped so the skinny M is wgmma's N:
// out[g]^T (N x M) = rhs[g]^T (N x K) . lhs[g]^T (K x M).
//   * A block owns (group g, a 128-column slab of N, 64 rows of M) and is
//     one warpgroup.  Thread 0 streams the slab's K rows through a ring of
//     GT_STAGES = 6 stages by TMA on mbarriers: per stage two 64 (K) x 64
//     (N) boxes of rhs, which wgmma reads MN-major as A (rhs is (K, N)
//     row-major), one m64 product each, and a NW (M) x 64 (K) box of lhs,
//     read K-major as B.  Each rhs byte is read from device memory once per
//     call for every M up to 64.
//   * wgmma's N is NW, M rounded up to a multiple of 8 (n8 at decode, n40
//     at a 256-row chunk): rows past M and K rows past K arrive zero-filled
//     from TMA, and only rows < M and columns < N are stored.
//   * bf16 x bf16 products are exact in f32 and wgmma sums them in f32, so
//     the kernel and the plain version differ only in summation order.
// float32 (the checks and the f32 parity arms): grouped_matmul_kernel on
// the CUDA cores (below), f32 products throughout; TF32 would not meet the
// f32 checks' 1e-5.  Every rhs element is read once per block of M rows.
// A block owns (group g, a tile of 64 columns, MT rows of M).  It stages
// its MT rows of lhs, 512 K-rows at a time, in shared memory (transposed,
// so one K-row's MT values are adjacent); its 256 threads are 16 column
// groups x 16 K lanes.  A thread streams rhs rows k = lane, lane + 16, ...
// with 16-byte loads and keeps MT x 4 f32 sums in registers.  At the end
// the 16 K lanes' partial sums are added in lane order through shared
// memory, so the result does not depend on scheduling.  MT is 2 for M <= 2
// and 8 above.
//
// Not done yet: skipping the groups that capacity leaves empty at decode
// (ROADMAP queue 2 item 6).  The gradient (dlhs = dout rhs^T, drhs = lhs^T
// dout) is grouped_matmul_bwd.cu, a kernel of its own: the Pallas kernel
// has no VJP either, and JAX differentiates grouped_matmul_ref.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COL_GROUPS = 16;                 // threads across a column tile
constexpr int K_LANES = THREADS / COL_GROUPS;  // threads down K
constexpr int KC = 512;                        // lhs K-rows staged at a time
constexpr int UNROLL = 4;                      // rhs rows in flight per thread

constexpr int V = 4;                           // floats in 16 bytes
constexpr int TN = COL_GROUPS * V;             // columns per block

template <int MT>
__global__ void __launch_bounds__(THREADS)
grouped_matmul_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                      float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float a_s[KC][MT];  // lhs slice, [k][m]
  __shared__ float part[K_LANES][TN];          // one output row's partial sums

  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * TN;
  const int g = blockIdx.z;
  const int cg = threadIdx.x % COL_GROUPS;
  const int lane = threadIdx.x / COL_GROUPS;
  const int col = n0 + cg * V;
  const bool live = col < N;  // N % V == 0: a column group is all in or all out
  const float* a = lhs + (size_t)g * M * K;
  const float* b = rhs + (size_t)g * K * N + col;

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    // stage lhs[m0:m0+MT, k0:k0+kc] as f32; rows past M are zeros
    for (int i = threadIdx.x; i < MT * KC; i += THREADS) {
      const int m = i / KC, k = i % KC;
      a_s[k][m] = (m0 + m < M && k < kc) ? a[(size_t)(m0 + m) * K + k0 + k] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int k = lane; k < kc; k += K_LANES * UNROLL) {
        uint4 raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int kk = k + u * K_LANES;
          raw[u] = kk < kc ? __ldg(reinterpret_cast<const uint4*>(b + (size_t)(k0 + kk) * N))
                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int kk = k + u * K_LANES;
          if (kk < kc) {
            const float bv[V] = {__uint_as_float(raw[u].x), __uint_as_float(raw[u].y),
                                 __uint_as_float(raw[u].z), __uint_as_float(raw[u].w)};
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float av = a_s[kk][m];
#pragma unroll
              for (int j = 0; j < V; ++j) acc[m][j] = fmaf(av, bv[j], acc[m][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the K lanes' partial sums of each row, added in lane order
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {  // the same for every thread of the block
#pragma unroll
      for (int j = 0; j < V; ++j) part[lane][cg * V + j] = acc[m][j];
      __syncthreads();
      for (int c = threadIdx.x; c < TN; c += THREADS) {
        if (n0 + c < N) {
          float s = 0.f;
#pragma unroll
          for (int l = 0; l < K_LANES; ++l) s += part[l][c];
          out[((size_t)g * M + m0 + m) * N + n0 + c] = s;
        }
      }
      __syncthreads();
    }
  }
}

template <int MT>
cudaError_t launch(const void* lhs, const void* rhs, void* out, int G, int M, int K, int N,
                   cudaStream_t stream) {
  dim3 grid((M + MT - 1) / MT, (N + TN - 1) / TN, G);
  grouped_matmul_kernel<MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs), static_cast<float*>(out),
      M, K, N);
  return cudaGetLastError();
}

cudaError_t launch_rows(const void* lhs, const void* rhs, void* out, int G, int M, int K,
                        int N, cudaStream_t stream) {
  if (M <= 2) return launch<2>(lhs, rhs, out, G, M, K, N, stream);
  return launch<8>(lhs, rhs, out, G, M, K, N, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int GT_THREADS = 128;   // one warpgroup
constexpr int GT_BOXES = 2;       // 64-column boxes of rhs per block: wgmma's M each
constexpr int GT_SLAB = 64 * GT_BOXES;
constexpr int GT_KC = 64;         // K rows per stage: one 128-byte box of lhs
constexpr int GT_STAGES = 6;

template <int NW>
__host__ __device__ constexpr uint32_t gt_stage_bytes() {
  return (uint32_t)(GT_KC * GT_SLAB + NW * GT_KC) * 2;
}

template <int NW>
constexpr size_t gt_smem() {
  return (size_t)GT_STAGES * gt_stage_bytes<NW>() + GT_STAGES * 8 + 1024;
}

// NW: the block's M rows rounded up to a multiple of 8 (wgmma's N)
template <int NW>
__global__ void __launch_bounds__(GT_THREADS)
grouped_matmul_tc_kernel(const __grid_constant__ CUtensorMap lhs_map,
                         const __grid_constant__ CUtensorMap rhs_map,
                         __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  // stage s: the rhs boxes (GT_KC x 64 each), then the lhs box (NW x
  // GT_KC); both sizes are multiples of 1024 bytes, so every box stays
  // aligned
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + GT_STAGES * gt_stage_bytes<NW>());
  const int n0 = blockIdx.x * GT_SLAB, m0 = blockIdx.y * 64, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (K + GT_KC - 1) / GT_KC;
  constexpr uint32_t BYTES = gt_stage_bytes<NW>();

  const CUtensorMap* lmap = &lhs_map;
  const CUtensorMap* rmap = &rhs_map;
  auto a_tile = [=](int st) { return reinterpret_cast<bf16*>(base + st * BYTES); };
  auto b_tile = [=](int st) { return a_tile(st) + GT_KC * GT_SLAB; };
  // stage st <- K rows [t * GT_KC, (t + 1) * GT_KC) of the slab and of lhs
  auto load = [=](int st, int t) {
    mbar_expect(&bars[st], BYTES);
    for (int x = 0; x < GT_BOXES; ++x)
      tma_load_3d(a_tile(st) + x * GT_KC * 64, rmap, &bars[st], n0 + 64 * x, t * GT_KC, g);
    tma_load_3d(b_tile(st), lmap, &bars[st], t * GT_KC, m0, g);
  };

  if (tid == 0) {
    for (int i = 0; i < GT_STAGES; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    for (int st = 0; st < GT_STAGES && st < nk; ++st) load(st, st);
  }
  __syncthreads();

  float acc[GT_BOXES][NW / 2];
#pragma unroll
  for (int x = 0; x < GT_BOXES; ++x)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[x][i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int st = t % GT_STAGES;
    mbar_wait(&bars[st], (t / GT_STAGES) & 1);
#pragma unroll
    for (int x = 0; x < GT_BOXES; ++x) reg_fence(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GT_KC / 16; ++kk)
#pragma unroll
      for (int x = 0; x < GT_BOXES; ++x)
        wgmma_ss_amn(acc[x], mnmajor_desc<64>(a_tile(st) + x * GT_KC * 64, GT_KC, kk),
                     kmajor_desc<64>(b_tile(st), NW, 0, kk), t > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < GT_BOXES; ++x) reg_fence(acc[x]);
    __syncthreads();   // every warp is done with stage st
    if (tid == 0 && t + GT_STAGES < nk) load(st, t + GT_STAGES);
  }

  // acc[x][4j + 2i + e] = out[g][m0 + 8j + 2 (lane % 4) + e]
  //                            [n0 + 64x + 16 warp + lane / 4 + 8i]
  const int n_base = n0 + 16 * warp + lane / 4;
  const int m_base = m0 + 2 * (lane % 4);
  bf16* o = out + (size_t)g * M * N;
#pragma unroll
  for (int x = 0; x < GT_BOXES; ++x)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m_base + 8 * j + e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n_base + 64 * x + 8 * i;
          if (m < M && n < N)
            o[(size_t)m * N + n] = __float2bfloat16(acc[x][4 * j + 2 * i + e]);
        }
      }
}

template <int NW>
cudaError_t launch_tc(const void* lhs, const void* rhs, void* out, int G, int M, int K, int N,
                      cudaStream_t stream) {
  CUtensorMap lm, rm;
  cudaError_t e = tile_map_3d(&lm, lhs, K, M, G, NW);
  if (e == cudaSuccess) e = tile_map_3d(&rm, rhs, N, K, G, GT_KC);
  if (e != cudaSuccess) return e;
  auto kern = grouped_matmul_tc_kernel<NW>;
  static bool configured = false;   // once per instantiation (one card)
  if (!configured) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gt_smem<NW>());
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((N + GT_SLAB - 1) / GT_SLAB, (M + 63) / 64, G);
  kern<<<grid, GT_THREADS, gt_smem<NW>(), stream>>>(lm, rm, static_cast<__nv_bfloat16*>(out),
                                                     M, K, N);
  return cudaGetLastError();
}

cudaError_t launch_tc_rows(const void* lhs, const void* rhs, void* out, int G, int M, int K,
                           int N, cudaStream_t st) {
  switch (((M < 64 ? M : 64) + 7) / 8) {   // NW / 8: M, at most 64, rounded up
    case 1: return launch_tc<8>(lhs, rhs, out, G, M, K, N, st);
    case 2: return launch_tc<16>(lhs, rhs, out, G, M, K, N, st);
    case 3: return launch_tc<24>(lhs, rhs, out, G, M, K, N, st);
    case 4: return launch_tc<32>(lhs, rhs, out, G, M, K, N, st);
    case 5: return launch_tc<40>(lhs, rhs, out, G, M, K, N, st);
    case 6: return launch_tc<48>(lhs, rhs, out, G, M, K, N, st);
    case 7: return launch_tc<56>(lhs, rhs, out, G, M, K, N, st);
    default: return launch_tc<64>(lhs, rhs, out, G, M, K, N, st);
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores), for lhs,
// rhs and out alike.  K and N are multiples of 8; every pointer is 16-byte
// aligned.  Returns the cudaError_t of the launch (0 on success).
extern "C" int grouped_matmul(const void* lhs, const void* rhs, void* out, int G, int M,
                              int K, int N, int dtype, void* stream) {
  if (G <= 0 || G > 65535 || M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 ||
      N / 64 > 65535 || (M + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_rows(lhs, rhs, out, G, M, K, N, st);
  if (dtype == 1) return (int)launch_tc_rows(lhs, rhs, out, G, M, K, N, st);
  return (int)cudaErrorInvalidValue;
}
