// RoPE + KV cache write kernel for Hopper (sm_90a), shared by the dense and
// the paged entry points (cache_update.cu, cache_update_paged.cu).
//
// Replaces: repro/kernels/flash_attention.py::cache_update and
// ::cache_update_paged (the Pallas TPU kernels _cache_update_kernel and
// _cache_update_paged_kernel), together with the two eager RoPE passes the
// serving step runs in front of them (repro/models/layers.py::apply_rope on
// q and on k).  Per new row j of slot b, in ONE launch:
//   * q (B, Sn, H, D) and k_new (B, Sn, K, D), when cos is given: the first
//     rot_dim dims of every head rotated as apply_rope does, with
//     cos/sin (B, Sn, rot_dim/2) float32 as rope_cos_sin gives them, the
//     tail (rotary_pct < 1) copied through;
//   * the rotated q written to q_out for every slot, done slots included
//     (attention still runs on a done lane; its output is discarded);
//   * the (rotated) k and v_new written into the cache row that index[b] + j
//     maps to, cast to the cache dtype.
// Without cos it is the plain scatter (k copied through, no q): the bare
// kernels' function, bit for bit.
//
// The two entry points differ only in where the row lands, which the
// ``Dest`` policy answers, as DenseRows/PagedRows do for the decode kernels:
//   DenseDest  a (B, S, K, D) cache; the whole slot is dropped when
//              index < 0 or index + Sn > S (the done-slot convention);
//   PagedDest  a (pool_blocks, bs, K, D) pool through block_tables; the
//              whole slot is dropped when index < 0 or index + Sn crosses
//              the table's max_blocks * bs rows, and a row whose table entry
//              lies outside the pool is dropped.
// One body for both, in this header, because the build makes one library
// per entry point (kernels/build.py, one nvcc per .cu), as
// decode_attention.cuh serves decode_attention(_paged).cu.
//
// Bit for bit with the plain composition (apply_rope on q, apply_rope on k,
// then kv_cache_update(_paged)_ref):
//   * eager PyTorch rounds x1*c, x2*s and their difference each on its own,
//     so the kernel spells them __fmul_rn / __fsub_rn / __fadd_rn: nothing
//     is contracted into an FMA;
//   * the rotated f32 is rounded to the new rows' dtype and only then cast
//     to the cache dtype, as `rotated.to(x.dtype)` then `.to(cache.dtype)`;
//   * cos and sin are read as the float32 the model computed, never
//     recomputed here.
//
// What bounds it on the card: bytes, and below them the launch itself.  At
// llama3.2-3b decode (B = 8, H = 24, K = 8, D = 128, bf16) one call reads
// q (48 KiB), k and v (16 KiB each) and cos/sin (4 KiB) and writes q (48 KiB)
// and the cache rows (32 KiB): ~0.05 us at 3.35 TB/s, far under a launch's
// own latency (the bare scatter took 1.4 us a call on an NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke.py).  So the design's gain is the launches it
// takes away: RoPE's 22 eager kernels per attention layer and step fold
// into the one launch the scatter already paid for.  Measured
// (chip_smoke.py's [time] cache_update rope lines, NVIDIA H100 80GB HBM3,
// 700.00 W, two runs): 1.85-2.00 us a call at llama decode and 2.91-2.92 us
// at a 256-row chunk, against 1.52 us for the bare scatter at decode; a
// llama decode step issues 616 fewer launches (tools/decode_ab.py).
//
// Design: one thread block per (new row, slot, group of THREADS work
// units).  The block stages the row's cos/sin (rot_dim/2 floats each) in
// shared memory once; q's and k's heads read the same row.  A work unit is
// V consecutive elements, loaded and stored as one vector (16 bytes of the
// new rows' dtype): for a rotated head, V dims of the first half and the V
// matching dims of the second half (both outputs of a RoPE pair come from
// one thread); for the tail and for v, a plain run of V.  V is the widest of
// 8/4/2/1 that divides rot_dim/2, D and K*D (8 for bf16 and 4 for f32 at
// every served model).  The grid's z blocks cut a row's units so that one
// decode step spreads over ~40 blocks instead of 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rope_cache {

constexpr int THREADS = 128;
constexpr int MAX_HALF = 128;  // rot_dim / 2 staged in shared memory (D <= 256)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements moved as one access; wider than 16 bytes (bf16 rows landing in
// an f32 cache) it keeps 16-byte alignment and the compiler splits it.
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Vec {
  T v[V];
};

struct DenseDest {
  int S;
  // the cache row of slot b's new row j, or -1 when the slot is dropped
  __device__ __forceinline__ long long row(int b, int j, int idx, int Sn) const {
    if (idx < 0 || (long long)idx + Sn > S) return -1;
    return (long long)b * S + idx + j;
  }
};

struct PagedDest {
  const int* table;
  int max_blocks, bs, pool_blocks;
  __device__ __forceinline__ long long row(int b, int j, int idx, int Sn) const {
    if (idx < 0 || (long long)idx + Sn > (long long)max_blocks * bs) return -1;
    const int pos = idx + j;
    const int blk = table[(size_t)b * max_blocks + pos / bs];
    if (blk < 0 || blk >= pool_blocks) return -1;
    return (long long)blk * bs + pos % bs;
  }
};

struct Args {
  const void* q;       // (B, Sn, H, D) new dtype, or null
  void* q_out;         // like q
  const void* k_new;   // (B, Sn, K, D) new dtype
  const void* v_new;
  void* k_cache;       // rows of K * D in the cache dtype
  void* v_cache;
  const int* index;    // (B,)
  const float* cos;    // (B, Sn, rot_dim / 2), or null: scatter only
  const float* sin;
  int B, Sn, H, K, D, rot_dim;
};

// One work unit of a rotated head row: u < half/V a RoPE pair of V dims,
// else a V-run of the tail.  f32 -> To, through Tn as the eager pass rounds.
template <int V, typename Tn, typename To>
__device__ __forceinline__ void rope_unit(const Tn* __restrict__ src, To* __restrict__ dst,
                                          int u, int D, int half, const float* c,
                                          const float* s) {
  const int per_head = half / V + (D - 2 * half) / V;
  const int h = u / per_head, r = u % per_head;
  src += (size_t)h * D;
  dst += (size_t)h * D;
  if (r < half / V) {
    const int d = r * V;
    const Vec<Tn, V> a = *reinterpret_cast<const Vec<Tn, V>*>(src + d);
    const Vec<Tn, V> b = *reinterpret_cast<const Vec<Tn, V>*>(src + half + d);
    Vec<To, V> lo, hi;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x1 = to_f(a.v[e]), x2 = to_f(b.v[e]);
      const float ce = c[d + e], se = s[d + e];
      const float r1 = __fsub_rn(__fmul_rn(x1, ce), __fmul_rn(x2, se));
      const float r2 = __fadd_rn(__fmul_rn(x2, ce), __fmul_rn(x1, se));
      lo.v[e] = from_f<To>(to_f(from_f<Tn>(r1)));
      hi.v[e] = from_f<To>(to_f(from_f<Tn>(r2)));
    }
    *reinterpret_cast<Vec<To, V>*>(dst + d) = lo;
    *reinterpret_cast<Vec<To, V>*>(dst + half + d) = hi;
  } else {
    const int d = 2 * half + (r - half / V) * V;
    const Vec<Tn, V> a = *reinterpret_cast<const Vec<Tn, V>*>(src + d);
    Vec<To, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = from_f<To>(to_f(a.v[e]));
    *reinterpret_cast<Vec<To, V>*>(dst + d) = o;
  }
}

template <int V, typename Tn, typename To>
__device__ __forceinline__ void copy_unit(const Tn* __restrict__ src, To* __restrict__ dst,
                                          int u) {
  const Vec<Tn, V> a = *reinterpret_cast<const Vec<Tn, V>*>(src + (size_t)u * V);
  Vec<To, V> o;
#pragma unroll
  for (int e = 0; e < V; ++e) o.v[e] = from_f<To>(to_f(a.v[e]));
  *reinterpret_cast<Vec<To, V>*>(dst + (size_t)u * V) = o;
}

template <typename Dest, typename Tn, typename Tc, int V>
__global__ void __launch_bounds__(THREADS)
cache_update_kernel(Args a, Dest dest) {
  __shared__ float cs[2 * MAX_HALF];
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t at = (size_t)b * a.Sn + j;          // the new row's index
  const bool rope = a.cos != nullptr;
  const int half = rope ? a.rot_dim / 2 : 0;
  if (rope) {
    for (int i = threadIdx.x; i < half; i += THREADS) {
      cs[i] = a.cos[at * half + i];
      cs[MAX_HALF + i] = a.sin[at * half + i];
    }
    __syncthreads();
  }
  const int D = a.D, row = a.K * D;
  const int per_head = half / V + (D - 2 * half) / V;
  const int nq = a.q != nullptr ? a.H * per_head : 0;
  const int nk = rope ? a.K * per_head : row / V;
  const int nv = row / V;
  const long long dst = dest.row(b, j, a.index[b], a.Sn);
  const Tn* kn = static_cast<const Tn*>(a.k_new) + at * row;
  const Tn* vn = static_cast<const Tn*>(a.v_new) + at * row;
  Tc* kc = dst < 0 ? nullptr : static_cast<Tc*>(a.k_cache) + (size_t)dst * row;
  Tc* vc = dst < 0 ? nullptr : static_cast<Tc*>(a.v_cache) + (size_t)dst * row;
  for (int u = blockIdx.z * THREADS + threadIdx.x; u < nq + nk + nv;
       u += gridDim.z * THREADS) {
    if (u < nq) {
      const size_t off = at * a.H * D;
      rope_unit<V>(static_cast<const Tn*>(a.q) + off, static_cast<Tn*>(a.q_out) + off, u, D,
                   half, cs, cs + MAX_HALF);
    } else if (dst < 0) {
      break;                                       // a dropped slot's rows
    } else if (u < nq + nk) {
      if (rope)
        rope_unit<V>(kn, kc, u - nq, D, half, cs, cs + MAX_HALF);
      else
        copy_unit<V>(kn, kc, u - nq);
    } else {
      copy_unit<V>(vn, vc, u - nq - nk);
    }
  }
}

template <typename Dest, typename Tn, typename Tc, int V>
cudaError_t launch_v(const Args& a, Dest dest, cudaStream_t stream) {
  const int half = a.cos != nullptr ? a.rot_dim / 2 : 0;
  const int per_head = half / V + (a.D - 2 * half) / V;
  const long long units = (a.q != nullptr ? (long long)a.H * per_head : 0) +
                          (a.cos != nullptr ? (long long)a.K * per_head : a.K * a.D / V) +
                          a.K * a.D / V;
  const long long z = (units + THREADS - 1) / THREADS;
  dim3 grid(a.Sn, a.B, (unsigned)(z < 1 ? 1 : (z > 65535 ? 65535 : z)));
  cache_update_kernel<Dest, Tn, Tc, V><<<grid, THREADS, 0, stream>>>(a, dest);
  return cudaGetLastError();
}

template <typename Dest, typename Tn, typename Tc>
cudaError_t launch_t(const Args& a, Dest dest, int V, cudaStream_t stream) {
  switch (V) {
    case 8: return launch_v<Dest, Tn, Tc, 8>(a, dest, stream);
    case 4: return launch_v<Dest, Tn, Tc, 4>(a, dest, stream);
    case 2: return launch_v<Dest, Tn, Tc, 2>(a, dest, stream);
    default: return launch_v<Dest, Tn, Tc, 1>(a, dest, stream);
  }
}

// dtypes: 0 = float32, 1 = bfloat16.  Checks the arguments, picks the
// vector width and the dtype pair, launches.  Returns the cudaError_t.
template <typename Dest>
int launch(const Args& a, Dest dest, int new_dtype, int cache_dtype, void* stream) {
  const bool rope = a.cos != nullptr;
  if (a.B <= 0 || a.B > 65535 || a.Sn <= 0 || a.K <= 0 || a.D <= 0 ||
      (a.q != nullptr && (a.H <= 0 || !rope)) ||
      (rope && (a.sin == nullptr || a.rot_dim < 0 || a.rot_dim % 2 || a.rot_dim > a.D ||
                a.rot_dim / 2 > MAX_HALF)))
    return (int)cudaErrorInvalidValue;
  const int half = rope ? a.rot_dim / 2 : 0;
  const int vmax = new_dtype == 1 ? 8 : 4;         // 16 bytes of the new rows
  int V = vmax;
  while (V > 1 && ((a.K * a.D) % V || (rope && (a.D % V || half % V)))) V /= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (new_dtype == 1 && cache_dtype == 1)
    return (int)launch_t<Dest, __nv_bfloat16, __nv_bfloat16>(a, dest, V, st);
  if (new_dtype == 0 && cache_dtype == 0) return (int)launch_t<Dest, float, float>(a, dest, V, st);
  if (new_dtype == 0 && cache_dtype == 1)
    return (int)launch_t<Dest, float, __nv_bfloat16>(a, dest, V, st);
  if (new_dtype == 1 && cache_dtype == 0)
    return (int)launch_t<Dest, __nv_bfloat16, float>(a, dest, V, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace rope_cache
