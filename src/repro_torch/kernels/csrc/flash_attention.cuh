// Pieces shared by the cache-free attention forward (flash_attention.cu)
// and its gradient (flash_attention_bwd.cu): the mask, and the tiling of
// their float32 kernels on the CUDA cores (the bf16 kernels' tensor-core
// pieces are in hopper.cuh).
//
// Tensors keep the reference's layout: q, out, dout (B, Sq, H, D); k, v
// (B, Sk, K, D); the log-sum-exp and delta (B, H, Sq) float32.  Query head
// h reads kv head h / (H / K).  Query row i and key row j are positions
// qoff + i and j: qoff = 0 is the reference's cache-free attention, and a
// rank of the sequence-sharded forward passes the first global row of its
// queries over keys that start at row 0 (causality and the window count
// from the global rows).
//
// An f32 block works on 64 x 64 tiles of (query rows) x (key rows) with 256
// threads, a 16 x 16 grid: thread (ty, tx) owns the 4 x 4 patch of rows
// ty*4 .. ty*4+3 and columns tx, tx+16, tx+32, tx+48 of a score tile, and
// the 4 rows ty*4 .. ty*4+3 x D/16 contiguous columns tx*D/16 .. of a
// (64 x D) output tile.  Tiles are staged raw (T) in shared memory by
// cp.async, rows padded by 16 bytes so the 16 tx threads reading 16
// different rows hit distinct banks; every product accumulates in f32.

#pragma once

#include "decode_attention.cuh"   // to_f, from_f, unpack, cp_async16, NEG_INF

namespace {

constexpr int FA_TILE = 64;               // query rows and key rows per tile
constexpr int FA_THREADS = 256;
constexpr int FA_SSTRIDE = FA_TILE + 1;   // row stride of an f32 score tile

template <typename T, int D>
struct FaLayout {
  static constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int VPR = D / EPV;         // vectors per row
  static constexpr int STRIDE = D + EPV;      // staged row stride (elements)
  static constexpr int DPT = D / 16;          // output columns per thread
  static constexpr size_t tile_bytes = (size_t)FA_TILE * STRIDE * sizeof(T);
  static constexpr size_t score_bytes = (size_t)FA_TILE * FA_SSTRIDE * sizeof(float);
};

// Stage rows [r0, r0 + 64) of head hh of a (B, S, NH, D) tensor into dst;
// rows at or past S are zero-filled without being read.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int b, int r0,
                                           int S, int NH, int hh) {
  using Lay = FaLayout<T, D>;
  for (int i = threadIdx.x; i < FA_TILE * Lay::VPR; i += FA_THREADS) {
    const int row = i / Lay::VPR, c = i % Lay::VPR, r = r0 + row;
    const bool live = r < S;
    const size_t off = live ? (((size_t)b * S + r) * NH + hh) * D + (size_t)c * Lay::EPV : 0;
    cp_async16(dst + row * Lay::STRIDE + c * Lay::EPV, src + off, live);
  }
}

// acc[r][c] = sum_d A[ty*4 + r][d] * Bt[tx + 16*c][d] over two staged tiles
template <typename T, int D>
__device__ __forceinline__ void dot_tile(const T* A, const T* Bt, int ty, int tx,
                                         float acc[4][4]) {
  using Lay = FaLayout<T, D>;
  constexpr int EPV = Lay::EPV, ST = Lay::STRIDE;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
  for (int v = 0; v < Lay::VPR; ++v) {
    float a[4][EPV], bt[4][EPV];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      unpack(*reinterpret_cast<const uint4*>(A + (ty * 4 + r) * ST + v * EPV), a[r], T());
#pragma unroll
    for (int c = 0; c < 4; ++c)
      unpack(*reinterpret_cast<const uint4*>(Bt + (tx + 16 * c) * ST + v * EPV), bt[c], T());
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < EPV; ++e) acc[r][c] += a[r][e] * bt[c][e];
  }
}

// the reference's mask: padding rows, causality, sliding window, with
// query row qp at position qp + qoff
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal, int window,
                                        int qoff) {
  const int qg = qp + qoff;
  return qp < Sq && kp < Sk && (!causal || qg >= kp) && (window <= 0 || qg - kp < window);
}

// key tiles [lo, hi) that query tile [q0, q0 + 64) can see; the rest are
// skipped, as the reference's fully masked kv blocks
__device__ __forceinline__ void key_range(int q0, int Sq, int Sk, int causal, int window,
                                          int qoff, int& lo, int& hi) {
  const int q_last = min(q0 + FA_TILE, Sq) - 1 + qoff;
  hi = causal ? min(Sk, q_last + 1) : Sk;
  lo = window > 0 ? max(0, q0 + qoff - window + 1) / FA_TILE * FA_TILE : 0;
}

// query tiles [lo, hi) that can see key tile [k0, k0 + 64)
__device__ __forceinline__ void query_range(int k0, int Sq, int Sk, int causal, int window,
                                            int qoff, int& lo, int& hi) {
  const int k_last = min(k0 + FA_TILE, Sk) - 1;
  lo = causal ? max(0, k0 - qoff) / FA_TILE * FA_TILE : 0;
  hi = window > 0 ? min(Sq, k_last + window - qoff) : Sq;
}

// logit after scale and softcap; *t gets tanh(x / softcap) for the
// softcap's derivative (0 without a softcap)
__device__ __forceinline__ float cap_logit(float dot, float scale, float softcap, float* t) {
  float x = dot * scale;
  *t = 0.f;
  if (softcap > 0.f) {
    *t = tanhf(x / softcap);
    x = softcap * *t;
  }
  return x;
}

// max and sum over the 16 threads (tx) that share a row (ty): lanes 0-15
// and 16-31 of a warp
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// opt a kernel into `smem` bytes of dynamic shared memory (above 48 KB
// only after opting in); once per instantiation (one card)
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace
