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
// What bounds it on the card: the bytes of K/V read, at decode.  A decode
// step does 4*g*D operations per K/V row of 2*D*sizeof(T) bytes, far below
// the ~295 operations per byte at which an H100 turns compute-bound.  A
// prefill chunk (Sq up to 256, so Sq*g = 768 rows for llama) does 4*D
// operations per visible (query, key) pair: ~0.1 GFLOP over ~1 MB of K/V,
// still bytes at the tensor cores' rate, but ~30x the bytes' time at the
// CUDA cores' 67 TFLOP/s, where the kernel computed it before.
//
// What the design does about it (the kernels are decode_attention.cuh,
// shared with the paged entry point):
//   * decode steps (Sq*g <= DECODE_ROWS = 4, both dtypes): split-KV.  The
//     grid (B, K, 1) was 64 blocks for llama at B = 8 on 132 SMs, and one
//     block staged tile after tile of its slot.  Now each (b, kv head) is
//     cut into fixed spans of `span` kv rows (the wrapper's DECODE_SPAN, a
//     multiple of the 128-row tile), one block each: a block stages its
//     span's tiles into shared memory by 16-byte cp.async copies all in
//     flight together, and its four warps each take 32 rows of a tile on
//     the CUDA cores (one kv row per lane, running max / sum / accumulator
//     in registers, combined once at the end).  The spans are kv positions:
//     spans past min(kv_len, S) or before the sliding window exit at once,
//     and the last live span of a slot to finish (an atomic counter, reset
//     by that block) combines the live spans' states in span order, so the
//     sums' order depends on neither the grid nor the cache's size.  The
//     states live in scratch the wrapper allocates; one launch per call.
//   * prefill chunks in bf16 (Sq*g > 4): the tensor cores.  A block takes
//     64 query rows of one (b, kv head) (the GQA packing r -> (t = r / g,
//     h = kh*g + r % g) indexes q (B, Sq, H, D) directly) as one warpgroup
//     and walks the 128-row kv tiles its rows see, double-buffered: tile
//     t + 1's cp.async copies go out before tile t's products.  The copies
//     land in hopper.cuh's 128-byte-swizzled layout (64-byte at D = 32), so
//     S = Q K^T is one chain of wgmma from shared memory (both K-major,
//     scale applied to S in f32: q stays bf16 as stored).  The softcap, the
//     causal and window masks (query row r at kv_len - Sq + r / g) and the
//     online softmax run on the accumulator fragment in registers; P V takes
//     P from registers as hi = bf16(P) and lo = bf16(P - hi), two products
//     summed in f32, so every entry stays within one bf16 ulp of the plain
//     version (P rounded to bf16 once would not); V is read MN-major.
//   * prefill chunks in f32: the CUDA-core kernel, unsplit, 16 query rows a
//     block; TF32 would not meet the f32 checks.
//   * rows past min(kv_len, S), before the window or after the block's last
//     causal position are never read: done lanes (kv_len = S + 1) stop at
//     the cache end.
// What still bounds it: at decode, the per-block tile loads (a span's tiles
// are staged one after another, from 16-byte cp.async, not TMA) and the
// CUDA-core products; at a chunk, one warpgroup per block runs its
// products and softmax in turn.

#include "decode_attention.cuh"

// caches (B, S, K, D); part: float32 scratch of B * K * ceil(S / span) *
// DECODE_ROWS * (D + 2) entries and counters: B * K int32, all 0, for the
// decode path (Sq * H / K <= 4).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_decode(const void* q, const void* k_cache, const void* v_cache,
                            const void* kv_len, void* out, void* part, void* counters, int B,
                            int Sq, int H, int S, int K, int D, int dtype, float scale,
                            float softcap, int window, int span, void* stream) {
  return decode_attention(q, k_cache, v_cache, kv_len, out, part, counters, B, Sq, H, K, D,
                          dtype, scale, softcap, window, span, DenseRows{S}, stream);
}
