// Paged KV cache write for Hopper (sm_90a), with the serving step's RoPE of
// q and k folded into the same launch: the paged entry point of the kernel
// in cache_update.cuh, whose note gives the TPU kernel it replaces, what
// bounds it and the design.
//
// Paged: row j of slot b lands at block table[b, (index[b] + j) / bs],
// offset (index[b] + j) % bs, of the pools (pool_blocks, bs, K, D), written
// IN PLACE (the TPU kernel aliased its inputs and copied each destination
// block through; here untouched rows are never read or copied).  A slot
// whose write would start before row 0 or cross its table's logical end
// (max_blocks * bs rows) is dropped WHOLE (the done-slot convention:
// finished lanes write at max_seq).  A row whose table entry lies outside
// the pool is dropped, as the plain version's out-of-range scatter drops
// it: no block id past the pool becomes a pointer.  Each thread block
// resolves its own row's destination, so a 256-row prefill chunk that
// spans 16 blocks of 16 lands each row in its own block.

#include "cache_update.cuh"

// k/v_new (B, Sn, K, D) in new_dtype; pools (pool_blocks, bs, K, D) in
// pool_dtype; index (B,) and table (B, max_blocks) int32.  q, q_out, cos,
// sin and rot_dim as cache_update's.  dtypes: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cache_update_paged(const void* k_new, const void* v_new, void* k_pool,
                                  void* v_pool, const void* index, const void* table,
                                  const void* q, void* q_out, const void* cos, const void* sin,
                                  int B, int Sn, int bs, int max_blocks, int pool_blocks, int H,
                                  int K, int D, int rot_dim, int new_dtype, int pool_dtype,
                                  void* stream) {
  if (bs <= 0 || max_blocks <= 0 || pool_blocks <= 0) return (int)cudaErrorInvalidValue;
  const rope_cache::Args a{q, q_out, k_new, v_new, k_pool, v_pool,
                           static_cast<const int*>(index), static_cast<const float*>(cos),
                           static_cast<const float*>(sin), B, Sn, H, K, D, rot_dim};
  return rope_cache::launch(
      a, rope_cache::PagedDest{static_cast<const int*>(table), max_blocks, bs, pool_blocks},
      new_dtype, pool_dtype, stream);
}
