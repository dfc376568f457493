// Per-slot KV cache write for Hopper (sm_90a), with the serving step's RoPE
// of q and k folded into the same launch: the dense entry point of the
// kernel in cache_update.cuh, whose note gives the TPU kernel it replaces,
// what bounds it and the design.
//
// Dense: caches (B, S, K, D) written IN PLACE (the TPU kernel aliased its
// inputs; here the untouched rows are never read or copied) at per-slot row
// offsets index[b]; a slot whose write would start before row 0 or cross
// row S is dropped WHOLE (the done-slot convention: finished lanes write at
// S).  The serving path's prefill chunks take this launch too, with their
// scalar cursor broadcast to (B,).

#include "cache_update.cuh"

// k/v_new (B, Sn, K, D) in new_dtype; caches (B, S, K, D) in cache_dtype;
// index (B,) int32.  q and q_out (B, Sn, H, D) in new_dtype, and cos, sin
// (B, Sn, rot_dim / 2) float32: all null for the bare scatter, cos and sin
// without q rotating k alone.  dtypes: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cache_update(const void* k_new, const void* v_new, void* k_cache,
                            void* v_cache, const void* index, const void* q, void* q_out,
                            const void* cos, const void* sin, int B, int Sn, int S, int H,
                            int K, int D, int rot_dim, int new_dtype, int cache_dtype,
                            void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const rope_cache::Args a{q, q_out, k_new, v_new, k_cache, v_cache,
                           static_cast<const int*>(index), static_cast<const float*>(cos),
                           static_cast<const float*>(sin), B, Sn, H, K, D, rot_dim};
  return rope_cache::launch(a, rope_cache::DenseDest{S}, new_dtype, cache_dtype, stream);
}
