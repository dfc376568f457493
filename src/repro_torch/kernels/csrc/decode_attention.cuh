// Flash-decode kernel template shared by the dense and the paged entry
// points (decode_attention.cu, decode_attention_paged.cu).
//
// The two differ only in where row r of slot b's K/V lives, which the
// ``Rows`` policy answers:
//   DenseRows  a (B, S, K, D) cache:         ((b*S + r)*K + kh)*D
//   PagedRows  a (P, bs, K, D) block pool:   ((table[b, r/bs]*bs + r%bs)*K + kh)*D
// Everything else -- the tile loop, the masks, the online softmax and the
// order of every sum -- is one piece of code, so the paged kernel over a
// scattered pool gives the dense kernel's output over the gathered cache
// bit for bit.  See decode_attention.cu for the design notes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = WARPS * 32;          // K/V rows staged per tile: one per lane
constexpr float NEG_INF = -1e30f;

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
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 16-byte global -> shared copy that bypasses registers; src_size 0
// zero-fills the destination without reading the source
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row addressing of a (B, S, K, D) cache: plain arithmetic, computed at
// each copy.
struct DenseRows {
  static constexpr bool kStaged = false;
  int S;
  __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ size_t offset(int b, int r, int K, int kh, int D) const {
    return (((size_t)b * S + r) * K + kh) * D;
  }
};

// Row addressing of a (pool_blocks, bs, K, D) pool through a (B, max_blocks)
// block table.  A slot holds max_blocks * bs rows; a table entry outside
// the pool is clamped into it (as the plain version's clip), so no block
// id ever becomes a pointer past the pool.  Staged: each tile's row
// offsets are resolved once (one table load per row) into shared memory
// before the copies are issued, so no copy waits on a table load.
struct PagedRows {
  static constexpr bool kStaged = true;
  const int* table;
  int max_blocks, bs, pool_blocks;
  __device__ __forceinline__ int limit() const { return max_blocks * bs; }
  __device__ __forceinline__ size_t offset(int b, int r, int K, int kh, int D) const {
    int blk = table[(size_t)b * max_blocks + r / bs];
    blk = min(max(blk, 0), pool_blocks - 1);
    return (((size_t)blk * bs + r % bs) * K + kh) * D;
  }
};

template <typename T, int D, int RW, bool Staged>
struct Layout {
  static constexpr int EPV = 16 / sizeof(T);   // elements per 16-byte vector
  static constexpr int VPR = D / EPV;          // vectors per row
  // K rows padded by 16 bytes: lane j reading row j with 16-byte loads hits
  // 32 distinct banks per quarter warp
  static constexpr int KSTRIDE = D + EPV;
  static constexpr int DPL = D / 32;           // output columns per lane
  static constexpr size_t tile_bytes =
      (size_t)TILE * (KSTRIDE + D) * sizeof(T) + (size_t)RW * D * sizeof(float) +
      (Staged ? (size_t)TILE * sizeof(size_t) : 0);
  static constexpr size_t combine_bytes = (size_t)WARPS * RW * (D + 2) * sizeof(float);
  static constexpr size_t smem_bytes = tile_bytes > combine_bytes ? tile_bytes : combine_bytes;
};

template <typename T, int D, int RW, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ kv_len,
                        T* __restrict__ out, int Sq, int H, int K,
                        float scale, float softcap, int window, Rows rows) {
  using Lay = Layout<T, D, RW, Rows::kStaged>;
  constexpr int EPV = Lay::EPV, VPR = Lay::VPR, KSTRIDE = Lay::KSTRIDE, DPL = Lay::DPL;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                    // TILE x KSTRIDE
  T* vs = ks + TILE * KSTRIDE;                           // TILE x D
  float* qs = reinterpret_cast<float*>(vs + TILE * D);   // RW x D, pre-scaled
  size_t* roff = reinterpret_cast<size_t*>(qs + RW * D); // TILE, if staged

  const int b = blockIdx.x, kh = blockIdx.y;
  const int g = H / K;
  const int R = Sq * g;
  const int r0 = blockIdx.z * RW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int len = kv_len[b];
  const int kv_eff = min(len, rows.limit());   // never read past the slot's rows
  const int r_last = min(r0 + RW, R) - 1;
  const int qpos_min = len - Sq + r0 / g;
  const int qpos_max = len - Sq + r_last / g;
  const int k_hi = min(kv_eff, qpos_max + 1);
  const int k_lo = window > 0 ? max(0, qpos_min - window + 1) : 0;

  for (int i = threadIdx.x; i < RW * D; i += THREADS) {
    const int r = i / D, d = i % D, rr = r0 + r;
    float v = 0.f;
    if (rr < R) {
      const int t = rr / g, h = kh * g + rr % g;
      v = to_f(q[(((size_t)b * Sq + t) * H + h) * D + d]) * scale;
    }
    qs[i] = v;
  }

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();

  for (int t0 = (k_lo / TILE) * TILE; t0 < k_hi; t0 += TILE) {
    if constexpr (Rows::kStaged) {
      for (int r = threadIdx.x; r < TILE; r += THREADS)
        if (t0 + r < k_hi) roff[r] = rows.offset(b, t0 + r, K, kh, D);
      __syncthreads();
    }
    // stage the tile with cp.async: every 16-byte copy of the tile is in
    // flight at once (a plain load/store loop waits out the memory
    // latency once per iteration); rows outside [t0, k_hi) are
    // zero-filled, so no stale value (or NaN) can reach the P.V product
    for (int i = threadIdx.x; i < TILE * VPR; i += THREADS) {
      const int row = i / VPR, c = i % VPR, kpos = t0 + row;
      const bool live = kpos < k_hi;
      size_t off = 0;
      if (live)
        off = (Rows::kStaged ? roff[row] : rows.offset(b, kpos, K, kh, D)) + (size_t)c * EPV;
      cp_async16(ks + row * KSTRIDE + c * EPV, kc + off, live);
      cp_async16(vs + row * D + c * EPV, vc + off, live);
    }
    cp_async_wait_all();
    __syncthreads();

    const int w0 = t0 + warp * 32;             // this warp's first kv row
    if (w0 < k_hi && w0 + 31 >= k_lo) {        // warp-uniform skip
      const int jrow = warp * 32 + lane;
      const int kpos = t0 + jrow;
      float s[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = 0.f;
      const T* krow = ks + jrow * KSTRIDE;
#pragma unroll 4
      for (int c = 0; c < VPR; ++c) {
        float kf[EPV];
        unpack(*reinterpret_cast<const uint4*>(krow + c * EPV), kf, T());
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4* qr = reinterpret_cast<const float4*>(qs + r * D + c * EPV);
#pragma unroll
          for (int e4 = 0; e4 < EPV / 4; ++e4) {
            const float4 qv = qr[e4];
            s[r] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] + qv.z * kf[4 * e4 + 2] +
                    qv.w * kf[4 * e4 + 3];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int qp = len - Sq + (r0 + r) / g;
        float x = s[r];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos < kv_eff && kpos <= qp && (window <= 0 || kpos > qp - window);
        x = ok ? x : NEG_INF;
        const float mn = fmaxf(m[r], warp_max(x));
        const float alpha = expf(m[r] - mn);
        const float p = ok ? expf(x - mn) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = mn;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
        s[r] = p;
      }
      // acc[r][:] += sum_j p_j * V[j][:], lane owns columns lane*DPL ..
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const T* vrow = vs + (warp * 32 + j) * D + lane * DPL;
        float vf[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vf[e] = to_f(vrow[e]);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] += pj * vf[e];
        }
      }
    }
    __syncthreads();
  }

  // combine the four warps' partial softmax states
  float* cm = reinterpret_cast<float*>(smem);   // WARPS x RW
  float* cl = cm + WARPS * RW;                  // WARPS x RW
  float* ca = cl + WARPS * RW;                  // WARPS x RW x D
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      cm[warp * RW + r] = m[r];
      cl[warp * RW + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) ca[(warp * RW + r) * D + lane * DPL + e] = acc[r][e];
  __syncthreads();

  for (int i = threadIdx.x; i < RW * D; i += THREADS) {
    const int r = i / D, d = i % D, rr = r0 + r;
    if (rr >= R) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, cm[w * RW + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float sc = expf(cm[w * RW + r] - M);
      L += cl[w * RW + r] * sc;
      O += ca[(w * RW + r) * D + d] * sc;
    }
    const int t = rr / g, h = kh * g + rr % g;
    out[(((size_t)b * Sq + t) * H + h) * D + d] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int RW, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_len,
                   void* out, int B, int Sq, int H, int K, float scale, float softcap,
                   int window, Rows rows, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, D, RW, Rows>;
  const size_t smem = Layout<T, D, RW, Rows::kStaged>::smem_bytes;
  // above 48 KB only after opting in; set once per instantiation (one card)
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int R = Sq * (H / K);
  dim3 grid(B, K, (R + RW - 1) / RW);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), Sq, H, K, scale, softcap,
      window, rows);
  return cudaGetLastError();
}

template <typename T, int D, typename Rows>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* kv_len,
                        void* out, int B, int Sq, int H, int K, float scale,
                        float softcap, int window, Rows rows, cudaStream_t stream) {
  // decode (Sq * g small) takes few rows per block; prefill chunks more,
  // so each staged tile feeds more query rows
  if (Sq * (H / K) <= 4)
    return launch<T, D, 4>(q, k, v, kv_len, out, B, Sq, H, K, scale, softcap, window, rows,
                           stream);
  return launch<T, D, 16>(q, k, v, kv_len, out, B, Sq, H, K, scale, softcap, window, rows,
                          stream);
}

template <typename T, typename Rows>
cudaError_t launch_dim(const void* q, const void* k, const void* v, const void* kv_len,
                       void* out, int B, int Sq, int H, int K, int D, float scale,
                       float softcap, int window, Rows rows, cudaStream_t stream) {
  switch (D) {
    case 32:   // the reduced configs
      return launch_rows<T, 32>(q, k, v, kv_len, out, B, Sq, H, K, scale, softcap, window,
                                rows, stream);
    case 64:   // zamba2's shared attention
      return launch_rows<T, 64>(q, k, v, kv_len, out, B, Sq, H, K, scale, softcap, window,
                                rows, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, kv_len, out, B, Sq, H, K, scale, softcap, window,
                                 rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 and window <= 0 mean none.
// Returns the cudaError_t of the launch (0 on success).
template <typename Rows>
int decode_attention(const void* q, const void* k, const void* v, const void* kv_len,
                     void* out, int B, int Sq, int H, int K, int D, int dtype, float scale,
                     float softcap, int window, Rows rows, void* stream) {
  if (B <= 0 || Sq <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(q, k, v, kv_len, out, B, Sq, H, K, D, scale, softcap,
                                  window, rows, st);
  if (dtype == 1)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, kv_len, out, B, Sq, H, K, D, scale,
                                          softcap, window, rows, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
