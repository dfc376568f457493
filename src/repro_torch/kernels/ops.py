"""Dispatch of the model's attention and cache operations, by device.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a tensor on CUDA goes to the hand-written kernel (``kernels/flash_attention.py``).
There is no mode switch and no fallback: a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention, ref


def attention(q, k, v, *, causal=True, local_window=None, softcap=None,
              scale=None):
    """Cache-free GQA attention. q: (B,S,H,D); k/v: (B,S,K,D).  On the CPU
    the full-matrix plain version; its kernel (the TPU's
    ``flash_attention``) is not ported yet."""
    if q.is_cuda:
        raise NotImplementedError("flash_attention: ROADMAP queue 2 item 5")
    return ref.attention_naive(q, k, v, causal=causal,
                               local_window=local_window, softcap=softcap,
                               scale=scale)


def decode_attention(q, k_cache, v_cache, kv_len, *, softcap=None,
                     local_window=None, scale=None):
    """Decode-step (Sq=1) or chunked-prefill (Sq>1) attention over a
    (B,S,K,D) cache with per-slot valid lengths kv_len (B,)."""
    return flash_attention.flash_decode(q, k_cache, v_cache, kv_len,
                                        softcap=softcap,
                                        local_window=local_window,
                                        scale=scale)


def kv_cache_update(k_cache, v_cache, k_new, v_new, index):
    """Write k/v_new (B,Sn,K,D) into the caches IN PLACE at per-slot
    offsets ``index`` (B,); slots whose write would cross the cache end
    are dropped whole (done-slot semantics).  Returns the caches."""
    return flash_attention.cache_update(k_cache, v_cache, k_new, v_new,
                                        index)


def decode_attention_paged(q, k_pool, v_pool, kv_len, block_tables, *,
                           softcap=None, local_window=None, scale=None):
    """Decode-step / chunked-prefill attention over a PAGED cache: the
    pools (n_blocks, bs, K, D) hold fixed-size blocks and each slot reads
    its rows through its ``block_tables`` row ((B, max_blocks) int32),
    ragged up to kv_len (B,)."""
    return flash_attention.flash_decode_paged(q, k_pool, v_pool, kv_len,
                                              block_tables, softcap=softcap,
                                              local_window=local_window,
                                              scale=scale)


def kv_cache_update_paged(k_pool, v_pool, k_new, v_new, index, block_tables):
    """Write k/v_new (B, Sn, K, D) into the paged pools IN PLACE at the
    (block, offset) destinations each slot's table maps rows
    [index, index + Sn) to; a slot whose write crosses its table's logical
    end is dropped whole (done-slot semantics, index = max_seq).  The
    engine keeps write destinations private (copy-on-write at admission),
    so no two slots write the same row.  Returns the pools."""
    return flash_attention.cache_update_paged(k_pool, v_pool, k_new, v_new,
                                              index, block_tables)
