// Paged flash-decode for Hopper (sm_90a): decode and chunked-prefill
// attention whose K/V rows live in a pool of fixed-size blocks.
//
// Replaces: repro/kernels/flash_attention.py::flash_decode_paged (the Pallas
// TPU kernel _decode_paged_kernel).  Same function as flash_decode, with
// slot b's logical rows [i*bs, (i+1)*bs) read from pool block table[b, i];
// pools (pool_blocks, bs, K, D), table (B, max_blocks) int32, so a slot
// holds max_blocks * bs rows.  Blocks past kv_len are never read.
//
// What bounds it on the card: the bytes of K/V read, as for the dense
// kernel; the table adds one int per K/V row staged (L1-resident).
//
// What the design does about it: it IS the dense kernels
// (decode_attention.cuh) with the row address resolved through the table.
// The CUDA-core decode kernel resolves each 128-row tile's rows (one table
// load per row) into shared memory before it issues the tile's cp.async
// copies, so no copy waits on a table load; the tensor-core chunk kernel
// loads each thread's row offsets into registers before it issues that
// thread's copies.  The tile spans 8 blocks of 16 (or 16 of 8).
// Because the tile loops, the spans of the split, the masks and every sum
// are the dense kernels', the output over a scattered pool equals
// flash_decode's over the gathered cache bit for bit -- the reference's
// paged == dense invariant.
//   * done lanes (kv_len = max_blocks*bs + 1) stop at the slot's last row;
//   * table entries are clamped into [0, pool_blocks) before forming an
//     address: free and released slots point at the engine's parking block,
//     and no id past the pool becomes a pointer.

#include "decode_attention.cuh"

// pools (pool_blocks, bs, K, D); table (B, max_blocks) int32; part and
// counters as flash_decode's, with S = max_blocks * bs.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                                  const void* kv_len, const void* table, void* out, void* part,
                                  void* counters, int B, int Sq, int H, int K, int D, int bs,
                                  int max_blocks, int pool_blocks, int dtype, float scale,
                                  float softcap, int window, int span, void* stream) {
  if (bs <= 0 || max_blocks <= 0 || pool_blocks <= 0) return (int)cudaErrorInvalidValue;
  return decode_attention(q, k_pool, v_pool, kv_len, out, part, counters, B, Sq, H, K, D,
                          dtype, scale, softcap, window, span,
                          PagedRows{static_cast<const int*>(table), max_blocks, bs, pool_blocks},
                          stream);
}
