"""Dispatch of the model's attention, cache and expert operations, by
device.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a tensor on CUDA goes to the hand-written kernel
(``kernels/flash_attention.py``, ``kernels/grouped_matmul.py``,
``kernels/ssd.py``).
There is no mode switch and no fallback: a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention, ref
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ssd as ssd_kernel


class FlashAttention(torch.autograd.Function):
    """Cache-free attention with its gradient.  The forward saves q, k, v,
    out and the f32 log-sum-exp; the backward is ``flash_attention_bwd``
    on them.  Under ``torch.utils.checkpoint`` the forward runs again in
    the backward pass, and autograd holds that recompute's ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, local_window, softcap, scale,
                naive_below):
        kw = dict(causal=causal, local_window=local_window, softcap=softcap,
                  scale=scale)
        if q.is_cuda:
            out, lse = flash_attention.flash_attention(q, k, v, **kw)
        else:
            # the reference's plain split (repro/kernels/ops.py:29-36)
            if q.shape[1] < naive_below and k.shape[1] < naive_below:
                out, lse = ref.attention_naive(q, k, v, return_lse=True, **kw)
            else:
                out, lse = ref.attention_blockwise(q, k, v, return_lse=True,
                                                   **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention.flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, causal=True, local_window=None, softcap=None,
              scale=None, naive_below=2049):
    """Cache-free GQA attention, differentiable. q: (B,S,H,D); k/v:
    (B,S,K,D).  On CUDA the ``flash_attention`` kernel (and
    ``flash_attention_bwd`` for the gradient); on the CPU the plain
    versions, full-matrix below ``naive_below`` rows and blockwise
    above."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, local_window,
                                softcap, scale, naive_below)


def decode_attention(q, k_cache, v_cache, kv_len, *, softcap=None,
                     local_window=None, scale=None):
    """Decode-step (Sq=1) or chunked-prefill (Sq>1) attention over a
    (B,S,K,D) cache with per-slot valid lengths kv_len (B,)."""
    return flash_attention.flash_decode(q, k_cache, v_cache, kv_len,
                                        softcap=softcap,
                                        local_window=local_window,
                                        scale=scale)


def kv_cache_update(k_cache, v_cache, k_new, v_new, index, **rope):
    """Write k/v_new (B,Sn,K,D) into the caches IN PLACE at per-slot
    offsets ``index`` (B,); slots whose write would cross the cache end
    are dropped whole (done-slot semantics).  Returns the caches.  With
    ``rope`` (q, cos, sin, rotary_pct) q and k_new are rotated first, in
    the same launch, and the rotated q is returned third."""
    return flash_attention.cache_update(k_cache, v_cache, k_new, v_new,
                                        index, **rope)


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


def kv_cache_update_paged(k_pool, v_pool, k_new, v_new, index, block_tables,
                          **rope):
    """Write k/v_new (B, Sn, K, D) into the paged pools IN PLACE at the
    (block, offset) destinations each slot's table maps rows
    [index, index + Sn) to; a slot whose write crosses its table's logical
    end is dropped whole (done-slot semantics, index = max_seq).  The
    engine keeps write destinations private (copy-on-write at admission),
    so no two slots write the same row.  Returns the pools; with ``rope``
    as ``kv_cache_update``'s, RoPE in the same launch and the rotated q
    third."""
    return flash_attention.cache_update_paged(k_pool, v_pool, k_new, v_new,
                                              index, block_tables, **rope)


def grouped_matmul(lhs, rhs):
    """(G, M, K) x (G, K, N) -> (G, M, N) in lhs's dtype with float32
    sums: the MoE expert product, one matmul per expert."""
    return gmm.grouped_matmul(lhs.contiguous(), rhs.contiguous())


def ssd(x, dt, A, B, C, D=None, h0=None, *, chunk=128, state_out=None):
    """Mamba-2 chunked SSD: x (Bb,S,H,P), dt (Bb,S,H), A (H,) f32, B/C
    (Bb,S,G,N), optional D (H,) f32 and h0 (Bb,H,P,N) f32.  Returns (y in
    x's dtype, the final f32 state), the state written into ``state_out``
    when given (which may be ``h0``: an in-place update of a cache lane)."""
    return ssd_kernel.ssd(x.contiguous(), dt.contiguous(), A.contiguous(),
                          B.contiguous(), C.contiguous(),
                          D.contiguous() if D is not None else None, h0,
                          chunk=chunk, state_out=state_out)
