// Flash-decode for Hopper (sm_90a): decode and chunked-prefill attention
// over a per-slot ragged KV cache.
//
// Replaces: repro/kernels/flash_attention.py::flash_decode (the Pallas TPU
// kernel _decode_kernel).  Same function: q (B, Sq, H, D) sits at the END of
// each slot's valid window kv_len[b] (which counts the Sq new rows), causal
// within the chunk, GQA with g = H / K query heads per kv head, optional
// logit softcap and sliding window, f32 online softmax.  Query row r of kv
// head k is head k*g + r % g at position kv_len - Sq + r / g.
//
// What bounds it on the card: the bytes of K/V read.  A decode step does
// 4*g*D operations per K/V row of 2*D*sizeof(T) bytes, far below the ~295
// operations per byte at which an H100 turns compute-bound, so the kernel
// lives on memory bandwidth.  Prefill chunks (Sq up to 256, so Sq*g = 768
// rows) reuse each staged K/V tile across many rows.
//
// What the design does about it (the kernel is decode_attention.cuh,
// shared with the paged entry point):
//   * each K/V row of the slot's valid window is read from device memory
//     once per block, by 16-byte cp.async copies all in flight together,
//     into a shared-memory tile of 128 rows (one per lane); rows past
//     min(kv_len, S), before the sliding window, or after the block's last
//     causal position are never read: done lanes (kv_len = S + 1) stop at
//     the cache end;
//   * the query rows of one kv head are processed together (RW rows per
//     block), so a staged tile feeds all of them; the q layout (B, Sq, H, D)
//     is indexed directly, with no transpose;
//   * the four warps split each tile's rows and keep their own running
//     max / sum / accumulator in registers, combined once at the end.
// Known limit, first thing to fix: at decode the grid is (B, K, 1) = 64
// blocks for B = 8, K = 8, under-filling 132 SMs; split-KV across blocks
// with a log-sum-exp combine, double-buffered (TMA) tiles and wgmma for
// prefill chunks are later work.

#include "decode_attention.cuh"

// caches (B, S, K, D).  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode(const void* q, const void* k_cache, const void* v_cache,
                            const void* kv_len, void* out, int B, int Sq, int H, int S,
                            int K, int D, int dtype, float scale, float softcap,
                            int window, void* stream) {
  return decode_attention(q, k_cache, v_cache, kv_len, out, B, Sq, H, K, D, dtype, scale,
                          softcap, window, DenseRows{S}, stream);
}
