// Flash-decode kernel templates shared by the dense and the paged entry
// points (decode_attention.cu, decode_attention_paged.cu).
//
// The two differ only in where row r of slot b's K/V lives, which the
// ``Rows`` policy answers:
//   DenseRows  a (B, S, K, D) cache:         ((b*S + r)*K + kh)*D
//   PagedRows  a (P, bs, K, D) block pool:   ((table[b, r/bs]*bs + r%bs)*K + kh)*D
// Everything else -- the tile loops, the spans of the split, the masks, the
// online softmax and the order of every sum -- is one piece of code, so the
// paged kernel over a scattered pool gives the dense kernel's output over
// the gathered cache bit for bit.  Two kernels, chosen by the query rows
// of a kv head (R = Sq * g) and the dtype; see decode_attention.cu for the
// design notes:
//   decode_attention_kernel     R <= DECODE_ROWS (decode steps), both
//                               dtypes: CUDA cores, split-KV over fixed
//                               spans of kv rows; also f32 prefill chunks,
//                               unsplit;
//   decode_attention_tc_kernel  R > DECODE_ROWS in bf16 (prefill chunks):
//                               tensor cores (wgmma, hopper.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
  __host__ __device__ __forceinline__ int limit() const { return S; }
  __device__ __forceinline__ size_t offset(int b, int r, int K, int kh, int D) const {
    return (((size_t)b * S + r) * K + kh) * D;
  }
};

// Row addressing of a (pool_blocks, bs, K, D) pool through a (B, max_blocks)
// block table.  A slot holds max_blocks * bs rows; a table entry outside
// the pool is clamped into it (as the plain version's clip), so no block
// id ever becomes a pointer past the pool.  Staged (the CUDA-core kernel):
// each tile's row offsets are resolved once (one table load per row) into
// shared memory before the copies are issued, so no copy waits on a table
// load; the tensor-core kernel loads a thread's row offsets into registers
// before it issues that thread's copies.
struct PagedRows {
  static constexpr bool kStaged = true;
  const int* table;
  int max_blocks, bs, pool_blocks;
  __host__ __device__ __forceinline__ int limit() const { return max_blocks * bs; }
  __device__ __forceinline__ size_t offset(int b, int r, int K, int kh, int D) const {
    int blk = table[(size_t)b * max_blocks + r / bs];
    blk = min(max(blk, 0), pool_blocks - 1);
    return (((size_t)blk * bs + r % bs) * K + kh) * D;
  }
};


// ---------------------------------------------------------------------------
// CUDA cores: decode steps (both dtypes, split-KV) and f32 prefill chunks
// ---------------------------------------------------------------------------

constexpr int DECODE_ROWS = 4;   // query rows (Sq * g) of a kv head on the decode path

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

// Block (b, kh, z) takes query rows [r0, r0 + RW) of kv head kh of slot b.
// span > 0 (the decode path, R <= RW, so r0 = 0): z is a span, and the block
// reads the kv rows of [z * span, (z + 1) * span) that the rows see.  The
// spans are kv positions, so they depend neither on the cache's rows nor
// on the grid; a span that no row sees exits at once.  Each live span
// leaves its (m, l, acc) in `part` (B, K, gridDim.z, RW) x (D + 2); the
// last live span of (b, kh) to finish, found by counters[b * K + kh], which
// it resets to 0, combines them in span order.  A slot with one live span
// writes its output directly (the combine of one state is the identity).
// span == 0 (f32 prefill chunks): z is the row block; every kv row is read.
template <typename T, int D, int RW, typename Rows>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ kv_len,
                        T* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counters, int Sq, int H, int K, float scale,
                        float softcap, int window, int span, Rows rows) {
  using Lay = Layout<T, D, RW, Rows::kStaged>;
  constexpr int EPV = Lay::EPV, VPR = Lay::VPR, KSTRIDE = Lay::KSTRIDE, DPL = Lay::DPL;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                    // TILE x KSTRIDE
  T* vs = ks + TILE * KSTRIDE;                           // TILE x D
  float* qs = reinterpret_cast<float*>(vs + TILE * D);   // RW x D, pre-scaled
  size_t* roff = reinterpret_cast<size_t*>(qs + RW * D); // TILE, if staged
  __shared__ int last;

  const int b = blockIdx.x, kh = blockIdx.y;
  const int g = H / K;
  const int R = Sq * g;
  const int r0 = span > 0 ? 0 : blockIdx.z * RW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int len = kv_len[b];
  const int kv_eff = min(len, rows.limit());   // never read past the slot's rows
  const int r_last = min(r0 + RW, R) - 1;
  const int qpos_min = len - Sq + r0 / g;
  const int qpos_max = len - Sq + r_last / g;
  const int k_hi = min(kv_eff, qpos_max + 1);
  const int k_lo = window > 0 ? max(0, qpos_min - window + 1) : 0;
  int t_begin = (k_lo / TILE) * TILE, t_end = k_hi, s_lo = 0, n_live = 1;
  if (span > 0) {
    s_lo = k_hi > k_lo ? k_lo / span : 0;
    const int s_hi = k_hi > k_lo ? (k_hi + span - 1) / span : 1;
    if ((int)blockIdx.z < s_lo || (int)blockIdx.z >= s_hi) return;   // no row sees it
    n_live = s_hi - s_lo;
    t_begin = max(t_begin, (int)blockIdx.z * span);
    t_end = min(t_end, ((int)blockIdx.z + 1) * span);
  }

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

  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    if constexpr (Rows::kStaged) {
      for (int r = threadIdx.x; r < TILE; r += THREADS)
        if (t0 + r < t_end) roff[r] = rows.offset(b, t0 + r, K, kh, D);
      __syncthreads();
    }
    // stage the tile with cp.async: every 16-byte copy of the tile is in
    // flight at once (a plain load/store loop waits out the memory
    // latency once per iteration); rows outside [t0, t_end) are
    // zero-filled, so no stale value (or NaN) can reach the P.V product
    for (int i = threadIdx.x; i < TILE * VPR; i += THREADS) {
      const int row = i / VPR, c = i % VPR, kpos = t0 + row;
      const bool live = kpos < t_end;
      size_t off = 0;
      if (live)
        off = (Rows::kStaged ? roff[row] : rows.offset(b, kpos, K, kh, D)) + (size_t)c * EPV;
      cp_async16(ks + row * KSTRIDE + c * EPV, kc + off, live);
      cp_async16(vs + row * D + c * EPV, vc + off, live);
    }
    cp_async_wait_all();
    __syncthreads();

    const int w0 = t0 + warp * 32;             // this warp's first kv row
    if (w0 < t_end && w0 + 31 >= k_lo) {       // warp-uniform skip
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

  // the span's states, when the slot has more than one live span
  const size_t n_states = (size_t)gridDim.x * K * gridDim.z * RW;
  float* po = part;                   // n_states x D
  float* pm = part + n_states * D;    // n_states
  float* pl = pm + n_states;          // n_states
  const size_t at0 = ((size_t)b * K + kh) * gridDim.z * RW;   // span 0, row 0
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
    if (n_live == 1) {
      const int t = rr / g, h = kh * g + rr % g;
      out[(((size_t)b * Sq + t) * H + h) * D + d] = from_f<T>(O / fmaxf(L, 1e-30f));
    } else {
      const size_t at = at0 + (size_t)blockIdx.z * RW + r;
      po[at * D + d] = O;
      if (d == 0) {
        pm[at] = M;
        pl[at] = L;
      }
    }
  }
  if (n_live == 1) return;

  __threadfence();     // this span's state is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[b * K + kh], 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < RW * D; i += THREADS) {
    const int r = i / D, d = i % D, rr = r0 + r;
    if (rr >= R) continue;
    float M = NEG_INF;
    for (int z = s_lo; z < s_lo + n_live; ++z) M = fmaxf(M, __ldcg(pm + at0 + z * RW + r));
    float L = 0.f, O = 0.f;
    for (int z = s_lo; z < s_lo + n_live; ++z) {
      const size_t at = at0 + z * RW + r;
      const float sc = expf(__ldcg(pm + at) - M);
      L += __ldcg(pl + at) * sc;
      O += __ldcg(po + at * D + d) * sc;
    }
    const int t = rr / g, h = kh * g + rr % g;
    out[(((size_t)b * Sq + t) * H + h) * D + d] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
  if (threadIdx.x == 0) counters[b * K + kh] = 0;   // ready for the next launch
}

template <typename T, int D, int RW, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_len,
                   void* out, float* part, int* counters, dim3 grid, int Sq, int H, int K,
                   float scale, float softcap, int window, int span, Rows rows,
                   cudaStream_t stream) {
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
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), part, counters, Sq, H, K, scale,
      softcap, window, span, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 prefill chunks (R > DECODE_ROWS): tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_Q = 64;          // query rows per block: one warpgroup
constexpr int TC_KV = 128;        // kv rows per tile
constexpr int TC_THR = 128;
constexpr float DA_LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem() {   // the q tile, two stages of K and V, alignment
  return (size_t)(TC_Q + 4 * TC_KV) * D * 2 + 1024;
}

// rows [t0, t0 + TC_KV) of slot b's K and V into one stage: 16-byte chunks
// by cp.async at their swizzled places (hopper.cuh's layout, 1024-byte
// aligned, so the wgmma descriptors read them as they would a TMA tile);
// rows at or past t_end are zero-filled.  Thread i copies chunk i % CPR of
// rows i / CPR + j * (TC_THR / CPR); it resolves all its rows' offsets (for
// PagedRows, table loads) before it issues its first copy.
template <int D, typename Rows>
__device__ __forceinline__ void stage_kv(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                         const __nv_bfloat16* kc, const __nv_bfloat16* vc,
                                         int b, int kh, int K, int t0, int t_end,
                                         const Rows& rows) {
  constexpr int CPR = D / 8, RPP = TC_THR / CPR;   // chunks per row, rows per pass
  const int c = threadIdx.x % CPR, r1 = threadIdx.x / CPR;
  size_t off[CPR];
#pragma unroll
  for (int j = 0; j < CPR; ++j) {
    const int kpos = t0 + r1 + j * RPP;
    off[j] = kpos < t_end ? rows.offset(b, kpos, K, kh, D) + (size_t)c * 8 : 0;
  }
#pragma unroll
  for (int j = 0; j < CPR; ++j) {
    const int r = r1 + j * RPP;
    const bool live = t0 + r < t_end;
    const uint32_t at = swizzled_byte<D>(TC_KV, r, c);
    cp_async16(reinterpret_cast<unsigned char*>(ks) + at, kc + off[j], live);
    cp_async16(reinterpret_cast<unsigned char*>(vs) + at, vc + off[j], live);
  }
}

// Block (b, kh, z): query rows [64 z, 64 z + 64) of kv head kh of slot b,
// over every kv tile that one of them sees.
template <int D, typename Rows>
__global__ void __launch_bounds__(TC_THR, 1)
decode_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ kc,
                           const __nv_bfloat16* __restrict__ vc,
                           const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                           int Sq, int H, int K, float scale, float softcap, int window,
                           Rows rows) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));   // TC_Q x D
  bf16* ks = qs + TC_Q * D;                                    // 2 stages of TC_KV x D
  bf16* vs = ks + 2 * TC_KV * D;                               // 2 stages of TC_KV x D

  const int b = blockIdx.x, kh = blockIdx.y, r0 = blockIdx.z * TC_Q;
  const int g = H / K, R = Sq * g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = kv_len[b];
  const int kv_eff = min(len, rows.limit());   // never read past the slot's rows
  const int r_last = min(r0 + TC_Q, R) - 1;
  const int qpos_min = len - Sq + r0 / g, qpos_max = len - Sq + r_last / g;
  const int k_hi = min(kv_eff, qpos_max + 1);
  const int k_lo = window > 0 ? max(0, qpos_min - window + 1) : 0;
  const int t_begin = k_lo / TC_KV * TC_KV;
  const int n = k_hi > t_begin ? (k_hi - t_begin + TC_KV - 1) / TC_KV : 0;

  // the q tile, bf16 as stored: row r is query row r0 + r, (t, h) =
  // ((r0 + r) / g, kh * g + (r0 + r) % g); rows past R are zeros
  constexpr int CPR = D / 8;
  for (int i = tid; i < TC_Q * CPR; i += TC_THR) {
    const int r = i / CPR, c = i % CPR, rr = r0 + r;
    const bool live = rr < R;
    const size_t off =
        live ? (((size_t)b * Sq + rr / g) * H + kh * g + rr % g) * D + (size_t)c * 8 : 0;
    cp_async16(reinterpret_cast<unsigned char*>(qs) + swizzled_byte<D>(TC_Q, r, c), q + off,
               live);
  }
  if (n > 0) stage_kv<D>(ks, vs, kc, vc, b, kh, K, t_begin, k_hi, rows);
  cp_async_commit();

  // this thread's accumulator rows: row and row + 8 of the block, at
  // query positions qp[0], qp[1]
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = len - Sq + min(r0 + row + 8 * i, R - 1) / g;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // running max (log2 units), sum

  for (int t = 0; t < n; ++t) {
    const int st = t & 1, t0 = t_begin + t * TC_KV;
    // tile t + 1's copies go out before tile t's products
    if (t + 1 < n) {
      stage_kv<D>(ks + (st ^ 1) * TC_KV * D, vs + (st ^ 1) * TC_KV * D, kc, vc, b, kh, K,
                  t0 + TC_KV, k_hi, rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();   // the copies, before wgmma reads them
    __syncthreads();
    const bf16* kt = ks + st * TC_KV * D;
    const bf16* vt = vs + st * TC_KV * D;

    // S = Q K^T (both K-major), scaled in f32 after the product
    float s[TC_KV / 2];
#pragma unroll
    for (int i = 0; i < TC_KV / 2; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, kmajor_desc<D>(qs, TC_Q, 0, kk), kmajor_desc<D>(kt, TC_KV, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // logits in log2 units; masked ones -inf (m2 starts finite, so no
    // inf - inf)
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < TC_KV / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = t0 + 8 * j + col + e;
          float x = s[4 * j + 2 * i + e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const bool ok =
              kpos < kv_eff && kpos <= qp[i] && (window <= 0 || kpos > qp[i] - window);
          x = ok ? x * DA_LOG2E : -INFINITY;
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
    for (int j = 0; j < TC_KV / 8; ++j)
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

    // O += P V with P as hi + lo (V MN-major)
    uint32_t ph[TC_KV / 16][4], pl[TC_KV / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_KV / 16; ++kk) {
      split_fragment(s, kk, ph[kk], pl[kk]);
      reg_fence(ph[kk]);
      reg_fence(pl[kk]);
    }
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_KV / 16; ++kk) {
      const uint64_t dv = mnmajor_desc<D>(vt, TC_KV, kk);
      wgmma_rs(o, ph[kk], dv, 1);
      wgmma_rs(o, pl[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    __syncthreads();   // every warp is done with stage st before it is refilled
  }
  if (n == 0) cp_async_wait<0>();   // the q tile

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int rr = r0 + row + 8 * i;
    if (rr >= R) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* dst = out + (((size_t)b * Sq + rr / g) * H + kh * g + rr % g) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

template <int D, typename Rows>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* kv_len,
                      void* out, int B, int Sq, int H, int K, float scale, float softcap,
                      int window, Rows rows, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kern = decode_attention_tc_kernel<D, Rows>;
  static bool configured = false;   // once per instantiation (one card)
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)tc_smem<D>());
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(B, K, (Sq * (H / K) + TC_Q - 1) / TC_Q);
  kern<<<grid, TC_THR, tc_smem<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kv_len), static_cast<bf16*>(out), Sq, H, K, scale, softcap,
      window, rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <typename T, int D, typename Rows>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const void* kv_len,
                        void* out, float* part, int* counters, int B, int Sq, int H, int K,
                        float scale, float softcap, int window, int span, Rows rows,
                        cudaStream_t stream) {
  const int R = Sq * (H / K);
  if (R <= DECODE_ROWS) {   // decode: split-KV over spans of kv rows
    if (part == nullptr || counters == nullptr || span <= 0 || span % TILE != 0)
      return cudaErrorInvalidValue;
    dim3 grid(B, K, (rows.limit() + span - 1) / span);
    return launch<T, D, DECODE_ROWS>(q, k, v, kv_len, out, part, counters, grid, Sq, H, K,
                                     scale, softcap, window, span, rows, stream);
  }
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_tc<D>(q, k, v, kv_len, out, B, Sq, H, K, scale, softcap, window, rows,
                        stream);
  } else {
    // f32 prefill chunks: 16 query rows per block, so each staged tile
    // feeds more of them
    dim3 grid(B, K, (R + 15) / 16);
    return launch<T, D, 16>(q, k, v, kv_len, out, nullptr, nullptr, grid, Sq, H, K, scale,
                            softcap, window, 0, rows, stream);
  }
}

template <typename T, typename Rows>
cudaError_t launch_dim(const void* q, const void* k, const void* v, const void* kv_len,
                       void* out, float* part, int* counters, int B, int Sq, int H, int K,
                       int D, float scale, float softcap, int window, int span, Rows rows,
                       cudaStream_t stream) {
  switch (D) {
    case 32:   // the reduced configs
      return launch_rows<T, 32>(q, k, v, kv_len, out, part, counters, B, Sq, H, K, scale,
                                softcap, window, span, rows, stream);
    case 64:   // zamba2's shared attention
      return launch_rows<T, 64>(q, k, v, kv_len, out, part, counters, B, Sq, H, K, scale,
                                softcap, window, span, rows, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, kv_len, out, part, counters, B, Sq, H, K, scale,
                                 softcap, window, span, rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 and window <= 0 mean none.
// part, counters, span: the decode path's scratch (see
// decode_attention_kernel; counters all 0 on entry, and left so), unused
// when Sq * (H / K) > DECODE_ROWS.  Returns the cudaError_t of the launch (0
// on success).
template <typename Rows>
int decode_attention(const void* q, const void* k, const void* v, const void* kv_len,
                     void* out, void* part, void* counters, int B, int Sq, int H, int K,
                     int D, int dtype, float scale, float softcap, int window, int span,
                     Rows rows, void* stream) {
  if (B <= 0 || Sq <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  if (dtype == 0)
    return (int)launch_dim<float>(q, k, v, kv_len, out, pf, ct, B, Sq, H, K, D, scale,
                                  softcap, window, span, rows, st);
  if (dtype == 1)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, kv_len, out, pf, ct, B, Sq, H, K, D, scale,
                                          softcap, window, span, rows, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
