// Per-slot KV cache write for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py::cache_update (the Pallas TPU
// kernel _cache_update_kernel).  Same function: scatter k/v_new (B, Sn, K, D)
// into the caches (B, S, K, D) at per-slot row offsets index[b], cast to the
// cache dtype; a slot whose write would start before row 0 or cross row S is
// dropped WHOLE (the done-slot convention: finished lanes write at S).
//
// What bounds it on the card: bytes only, no arithmetic.  It moves
// 2 * B * Sn * K * D elements in and the same out; at decode that is 16 KiB
// per layer for B = 8, so launch latency dominates the bandwidth term.
//
// What the design does about it: the caches are written IN PLACE (the TPU
// kernel aliased its inputs; here the untouched rows are never read or
// copied), and one slot's Sn rows are contiguous on both sides, so the write
// is a straight copy in 16-byte vector stores.  k and v go in one launch
// (grid z = 2), one grid row per slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename Tn, typename Tc>
__global__ void __launch_bounds__(THREADS)
cache_update_kernel(const Tn* __restrict__ k_new, const Tn* __restrict__ v_new,
                    Tc* __restrict__ k_cache, Tc* __restrict__ v_cache,
                    const int* __restrict__ index, int Sn, int S, int row) {
  constexpr int E = 16 / sizeof(Tc);     // destination elements per 16-byte store
  const int b = blockIdx.y;
  const int idx = index[b];
  if (idx < 0 || idx + Sn > S) return;   // whole-slot drop
  const size_t n = (size_t)Sn * row;     // contiguous elements on both sides
  const Tn* src = (blockIdx.z == 0 ? k_new : v_new) + (size_t)b * n;
  Tc* dst = (blockIdx.z == 0 ? k_cache : v_cache) + ((size_t)b * S + idx) * row;
  for (size_t i = ((size_t)blockIdx.x * THREADS + threadIdx.x) * E; i < n;
       i += (size_t)gridDim.x * THREADS * E) {
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
cudaError_t launch(const void* k_new, const void* v_new, void* k_cache, void* v_cache,
                   const void* index, int B, int Sn, int S, int row, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(Tc);
  const size_t vecs = ((size_t)Sn * row + E - 1) / E;
  const int blocks = (int)((vecs + THREADS - 1) / THREADS);
  dim3 grid(blocks < 1024 ? blocks : 1024, B, 2);
  cache_update_kernel<Tn, Tc><<<grid, THREADS, 0, stream>>>(
      static_cast<const Tn*>(k_new), static_cast<const Tn*>(v_new), static_cast<Tc*>(k_cache),
      static_cast<Tc*>(v_cache), static_cast<const int*>(index), Sn, S, row);
  return cudaGetLastError();
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16.  row = K * D elements, a multiple of 8.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cache_update(const void* k_new, const void* v_new, void* k_cache,
                            void* v_cache, const void* index, int B, int Sn, int S, int row,
                            int new_dtype, int cache_dtype, void* stream) {
  if (B <= 0 || Sn <= 0 || row <= 0 || row % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (new_dtype == 1 && cache_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(k_new, v_new, k_cache, v_cache, index, B,
                                                     Sn, S, row, st);
  if (new_dtype == 0 && cache_dtype == 0)
    return (int)launch<float, float>(k_new, v_new, k_cache, v_cache, index, B, Sn, S, row, st);
  if (new_dtype == 0 && cache_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(k_new, v_new, k_cache, v_cache, index, B, Sn, S,
                                             row, st);
  if (new_dtype == 1 && cache_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(k_new, v_new, k_cache, v_cache, index, B, Sn, S,
                                             row, st);
  return (int)cudaErrorInvalidValue;
}
