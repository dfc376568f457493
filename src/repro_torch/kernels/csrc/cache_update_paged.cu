// Paged KV cache write for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py::cache_update_paged (the Pallas
// TPU kernel _cache_update_paged_kernel).  Same function: scatter k/v_new
// (B, Sn, K, D) into the pools (pool_blocks, bs, K, D), row j of slot b
// landing at block table[b, (index[b] + j) / bs], offset (index[b] + j) % bs,
// cast to the pool dtype.  A slot whose write would start before row 0 or
// cross its table's logical end (max_blocks * bs rows) is dropped WHOLE
// (the done-slot convention: finished lanes write at max_seq).  A row whose
// table entry lies outside the pool is dropped, as the plain version's
// out-of-range scatter drops it: no block id past the pool becomes a pointer.
//
// What bounds it on the card: bytes only, no arithmetic: 2 * B * Sn * K * D
// elements in and the same out (16 KiB per layer at decode, B = 8), so
// launch latency dominates the bandwidth term.
//
// What the design does about it: the pools are written IN PLACE (the TPU
// kernel aliased its inputs and copied each destination block through; here
// untouched rows are never read or copied).  One thread block per
// (new row, slot, k|v) resolves that row's destination itself, so a write of
// Sn rows that crosses block boundaries (a 256-row prefill chunk spans 16
// blocks of 16) lands each row in its own block; the K*D elements of a row
// are contiguous on both sides and go out in 16-byte vector stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename Tn, typename Tc>
__global__ void __launch_bounds__(THREADS)
cache_update_paged_kernel(const Tn* __restrict__ k_new, const Tn* __restrict__ v_new,
                          Tc* __restrict__ k_pool, Tc* __restrict__ v_pool,
                          const int* __restrict__ index, const int* __restrict__ table,
                          int Sn, int bs, int max_blocks, int pool_blocks, int row) {
  constexpr int E = 16 / sizeof(Tc);     // destination elements per 16-byte store
  const int j = blockIdx.x, b = blockIdx.y;
  const int idx = index[b];
  if (idx < 0 || (long long)idx + Sn > (long long)max_blocks * bs) return;  // whole-slot drop
  const int pos = idx + j;
  const int blk = table[(size_t)b * max_blocks + pos / bs];
  if (blk < 0 || blk >= pool_blocks) return;
  const Tn* src = (blockIdx.z == 0 ? k_new : v_new) + ((size_t)b * Sn + j) * row;
  Tc* dst = (blockIdx.z == 0 ? k_pool : v_pool) + ((size_t)blk * bs + pos % bs) * row;
  for (int i = threadIdx.x * E; i < row; i += THREADS * E) {
    if constexpr (std::is_same<Tn, Tc>::value) {
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
    } else {
      alignas(16) Tc tmp[E];
#pragma unroll
      for (int e = 0; e < E; ++e) tmp[e] = from_f<Tc>(to_f(src[i + e]));
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <typename Tn, typename Tc>
cudaError_t launch(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                   const void* index, const void* table, int B, int Sn, int bs,
                   int max_blocks, int pool_blocks, int row, cudaStream_t stream) {
  dim3 grid(Sn, B, 2);
  cache_update_paged_kernel<Tn, Tc><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tn*>(k_new), static_cast<const Tn*>(v_new), static_cast<Tc*>(k_pool),
      static_cast<Tc*>(v_pool), static_cast<const int*>(index),
      static_cast<const int*>(table), Sn, bs, max_blocks, pool_blocks, row);
  return cudaGetLastError();
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  row = K * D elements, a multiple of 8.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cache_update_paged(const void* k_new, const void* v_new, void* k_pool,
                                  void* v_pool, const void* index, const void* table, int B,
                                  int Sn, int bs, int max_blocks, int pool_blocks, int row,
                                  int new_dtype, int pool_dtype, void* stream) {
  if (B <= 0 || B > 65535 || Sn <= 0 || bs <= 0 || max_blocks <= 0 || pool_blocks <= 0 ||
      row <= 0 || row % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (new_dtype == 1 && pool_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(k_new, v_new, k_pool, v_pool, index, table,
                                                     B, Sn, bs, max_blocks, pool_blocks, row, st);
  if (new_dtype == 0 && pool_dtype == 0)
    return (int)launch<float, float>(k_new, v_new, k_pool, v_pool, index, table, B, Sn, bs,
                                     max_blocks, pool_blocks, row, st);
  if (new_dtype == 0 && pool_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(k_new, v_new, k_pool, v_pool, index, table, B, Sn,
                                             bs, max_blocks, pool_blocks, row, st);
  if (new_dtype == 1 && pool_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(k_new, v_new, k_pool, v_pool, index, table, B, Sn,
                                             bs, max_blocks, pool_blocks, row, st);
  return (int)cudaErrorInvalidValue;
}
