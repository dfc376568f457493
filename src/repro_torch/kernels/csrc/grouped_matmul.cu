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
// What bounds it on the card: on the MoE serving path M is the expert
// capacity, which is tiny.  For olmoe (G = 64; K x N = 2048 x 1024 for gate
// and up, 1024 x 2048 for down) M is 2 at a batch-8 decode step: 0.54 GFLOP
// against 268 MB of expert weights, so bytes bound it (~80 us at 3.35 TB/s).
// At a 256-row prefill chunk M is 40: 10.7 GFLOP, ~11 us on the tensor
// cores but ~0.16 ms on the CUDA cores' f32 FMAs (67 TFLOP/s), so this
// design is bound there by its own arithmetic, above the ~85 us of bytes.
//
// What the design does about it: every rhs element is read from device
// memory once per block of M rows.  A block owns (group g, a tile of 128
// columns in bf16 or 64 in f32, MT rows of M).  It stages its MT rows of
// lhs, 512 K-rows at a time, in shared memory as f32 (transposed, so one
// K-row's MT values are adjacent); its 256 threads are 16 column groups x 16
// K lanes.  A thread streams rhs rows k = lane, lane + 16, ... with 16-byte
// loads (a half-warp reads one row's 256 contiguous bytes, four rows in
// flight per thread) and keeps MT x 8 (f32: MT x 4) f32 sums in registers.
// At the end the 16 K lanes' partial sums are added in lane order through
// shared memory, so the result does not depend on scheduling.  MT is 2 for
// M <= 2 (decode) and 8 above; the M tiles of one (group, column tile) are
// neighbours in the grid, so a rhs tile one of them reads is an L2 hit for
// the others.  The smallest full-width shape gives 64 x 8 = 512 blocks.
//
// Not done yet (ROADMAP queue 2 item 6): tensor cores (mma.sync, then wgmma
// fed by TMA), and skipping the groups that capacity leaves empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COL_GROUPS = 16;                 // threads across a column tile
constexpr int K_LANES = THREADS / COL_GROUPS;  // threads down K
constexpr int KC = 512;                        // lhs K-rows staged at a time
constexpr int UNROLL = 4;                      // rhs rows in flight per thread

template <typename T> struct Vec;              // elements in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
grouped_matmul_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                      T* __restrict__ out, int M, int K, int N) {
  constexpr int V = Vec<T>::N;
  constexpr int TN = COL_GROUPS * V;
  __shared__ __align__(16) float a_s[KC][MT];  // lhs slice, [k][m]
  __shared__ float part[K_LANES][TN];          // one output row's partial sums

  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * TN;
  const int g = blockIdx.z;
  const int cg = threadIdx.x % COL_GROUPS;
  const int lane = threadIdx.x / COL_GROUPS;
  const int col = n0 + cg * V;
  const bool live = col < N;  // N % V == 0: a column group is all in or all out
  const T* a = lhs + (size_t)g * M * K;
  const T* b = rhs + (size_t)g * K * N + col;

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
      a_s[k][m] = (m0 + m < M && k < kc) ? to_f(a[(size_t)(m0 + m) * K + k0 + k]) : 0.f;
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
            float bv[V];
            unpack(raw[u], bv, T());
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
          out[((size_t)g * M + m0 + m) * N + n0 + c] = from_f<T>(s);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int MT>
cudaError_t launch(const void* lhs, const void* rhs, void* out, int G, int M, int K, int N,
                   cudaStream_t stream) {
  constexpr int TN = COL_GROUPS * Vec<T>::N;
  dim3 grid((M + MT - 1) / MT, (N + TN - 1) / TN, G);
  grouped_matmul_kernel<T, MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* lhs, const void* rhs, void* out, int G, int M, int K,
                        int N, cudaStream_t stream) {
  if (M <= 2) return launch<T, 2>(lhs, rhs, out, G, M, K, N, stream);
  return launch<T, 8>(lhs, rhs, out, G, M, K, N, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out alike).  K and N are
// multiples of 8; every pointer is 16-byte aligned.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int grouped_matmul(const void* lhs, const void* rhs, void* out, int G, int M,
                              int K, int N, int dtype, void* stream) {
  if (G <= 0 || G > 65535 || M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0 ||
      N / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_rows<float>(lhs, rhs, out, G, M, K, N, st);
  if (dtype == 1) return (int)launch_rows<__nv_bfloat16>(lhs, rhs, out, G, M, K, N, st);
  return (int)cudaErrorInvalidValue;
}
