"""Wrappers of the hand-written CUDA kernels that replace the Pallas TPU
kernels of ``repro/kernels/flash_attention.py`` on the serving and
training paths.

  flash_decode        csrc/decode_attention.cu
                      (TPU: flash_decode, _decode_kernel)
  flash_decode_paged  csrc/decode_attention_paged.cu
                      (TPU: flash_decode_paged, _decode_paged_kernel)
  cache_update        csrc/cache_update.cu (+ cache_update.cuh)
                      (TPU: cache_update, _cache_update_kernel; with q,
                      cos and sin also the serving step's RoPE of q and k)
  cache_update_paged  csrc/cache_update_paged.cu (+ cache_update.cuh)
                      (TPU: cache_update_paged, _cache_update_paged_kernel;
                      RoPE alike)
  flash_attention     csrc/flash_attention.cu
                      (TPU: flash_attention, _attn_kernel)
  flash_attention_bwd csrc/flash_attention_bwd.cu
                      (XLA's autodiff of the plain attention: the Pallas
                      kernel has no VJP)

A wrapper given CPU tensors runs the kernel's plain PyTorch version from
``kernels/ref.py``; given CUDA tensors it checks device, dtype, shape and
contiguity, allocates the output, launches the kernel on the current
stream and raises if the launch returns a CUDA error.  There is no other
path.  Each wrapper counts its kernel launches in ``<wrapper>.launches``;
a CUDA graph's replays add the launches its capture counted
(``serving/graphs.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.ssd import ssd

#: query rows of a kv head (Sq * H / K) up to which a call takes the
#: kernels' decode path, split-KV over spans of DECODE_SPAN kv rows (a
#: multiple of their 128-row tile); more rows take the prefill-chunk path
DECODE_ROWS = 4
DECODE_SPAN = 256

#: per device, the decode path's span counters: zeros, which every launch
#: leaves as it found them (one stream at a time may use them); a CUDA
#: graph holds their address, so a grown set keeps the old one alive
_counters: dict = {}
_outgrown: list = []


def _decode_scratch(q, K, D, limit):
    """The decode path's scratch for a call with ``limit`` kv rows per slot:
    the spans' (acc, m, l) states and the counters; (None, None) on the
    prefill-chunk path, which needs none.  The caller holds them until the
    launch is enqueued."""
    B, Sq, H = q.shape[:3]
    if Sq * (H // K) > DECODE_ROWS:
        return None, None
    n_spans = -(-limit // DECODE_SPAN)
    part = torch.empty(B * K * n_spans * DECODE_ROWS * (D + 2),
                       dtype=torch.float32, device=q.device)
    counters = _counters.get(q.device)
    if counters is None or counters.numel() < B * K:
        if counters is not None:
            _outgrown.append(counters)
        counters = torch.zeros(max(B * K, 1024), dtype=torch.int32,
                               device=q.device)
        _counters[q.device] = counters
    return part, counters


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_decode(q, k_cache, v_cache, kv_len, *, softcap=None,
                 local_window=None, scale=None):
    """q: (B, Sq, H, D); caches: (B, S, K, D); kv_len: (B,) int32 valid
    length INCLUDING the Sq new tokens, per slot (ragged; a done lane's
    S + 1 reads the S cache rows and nothing past them).  Returns
    (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_len,
                                        scale=scale, softcap=softcap,
                                        local_window=local_window)
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"flash_decode: dtype {q.dtype} not supported")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("flash_decode: caches must have q's dtype")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise TypeError("flash_decode: kv_len must be int32 of shape (B,)")
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or H % K):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}")
    if D not in (32, 64, 128):
        raise ValueError(f"flash_decode: head_dim {D} not in (32, 64, 128)")
    build.check_cuda("flash_decode", q.device, q=q, k_cache=k_cache,
                v_cache=v_cache, kv_len=kv_len)
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    part, counters = _decode_scratch(q, K, D, S)
    err = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), _ptr(part), _ptr(counters), B, Sq,
        H, S, K, D,
        build.DTYPE_CODE[q.dtype], float(scale),
        float(softcap) if softcap is not None else 0.0,
        int(local_window) if local_window is not None else 0, DECODE_SPAN,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("flash_decode", err)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_paged(q, k_pool, v_pool, kv_len, block_tables, *,
                       softcap=None, local_window=None, scale=None):
    """q: (B, Sq, H, D); pools: (n_blocks, bs, K, D); kv_len: (B,) int32
    valid length INCLUDING the Sq new tokens; block_tables: (B, max_blocks)
    int32, slot b's logical rows [i*bs, (i+1)*bs) living in pool block
    ``block_tables[b, i]`` (clipped into the pool).  Returns (B, Sq, H, D)
    in q's dtype, equal to ``flash_decode`` over the gathered cache."""
    B, Sq, H, D = q.shape
    n_blocks, bs, K = k_pool.shape[:3]
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        return ref.decode_attention_paged_ref(q, k_pool, v_pool, kv_len,
                                              block_tables, scale=scale,
                                              softcap=softcap,
                                              local_window=local_window)
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"flash_decode_paged: dtype {q.dtype} not supported")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("flash_decode_paged: pools must have q's dtype")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise TypeError("flash_decode_paged: kv_len must be int32 of shape "
                        "(B,)")
    if (block_tables.dtype != torch.int32 or block_tables.ndim != 2
            or block_tables.shape[0] != B):
        raise TypeError("flash_decode_paged: block_tables must be int32 of "
                        "shape (B, max_blocks)")
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != D or H % K:
        raise ValueError(f"flash_decode_paged: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}")
    if D not in (32, 64, 128):
        raise ValueError(f"flash_decode_paged: head_dim {D} not in "
                         "(32, 64, 128)")
    build.check_cuda("flash_decode_paged", q.device, q=q, k_pool=k_pool,
                v_pool=v_pool, kv_len=kv_len, block_tables=block_tables)
    out = torch.empty_like(q)
    lib = build.library("decode_attention_paged")
    max_blocks = block_tables.shape[1]
    part, counters = _decode_scratch(q, K, D, max_blocks * bs)
    err = lib.flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        kv_len.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        _ptr(part), _ptr(counters), B, Sq, H, K, D, bs, max_blocks, n_blocks,
        build.DTYPE_CODE[q.dtype],
        float(scale), float(softcap) if softcap is not None else 0.0,
        int(local_window) if local_window is not None else 0, DECODE_SPAN,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("flash_decode_paged", err)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def _rot_dim(name, k_new, q, cos, sin, rotary_pct):
    """rot_dim of a ``cache_update(_paged)`` call with RoPE, or None for
    the bare scatter (no q, cos or sin)."""
    if q is None and cos is None and sin is None:
        return None
    if q is None or cos is None or sin is None:
        raise TypeError(f"{name}: q, cos and sin come together")
    return int(k_new.shape[3] * rotary_pct) // 2 * 2


def _check_rope(name, k_new, q, cos, sin, rot_dim):
    """The kernel's RoPE operands: q (B, Sn, H, D) in k_new's dtype and
    cos/sin float32 (B, Sn, rot_dim / 2), rot_dim / 2 <= 128."""
    B, Sn, K, D = k_new.shape
    if q.dtype != k_new.dtype or q.ndim != 4 \
            or tuple(q.shape[:2]) + (q.shape[3],) != (B, Sn, D):
        raise TypeError(f"{name}: q {tuple(q.shape)} {q.dtype} must be "
                        f"(B, Sn, H, D) in k_new's dtype {k_new.dtype}")
    for arg, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, Sn,
                                                          rot_dim // 2):
            raise TypeError(f"{name}: {arg} must be float32 of shape "
                            f"{(B, Sn, rot_dim // 2)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if rot_dim // 2 > 128:
        raise ValueError(f"{name}: rot_dim {rot_dim} above 256")


def _refuse_grad(name, *tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{name} writes the cache in place and has no backward: "
            "training takes apply_rope and flash_attention")


def _check_scatter(name, k_cache, v_cache, k_new, v_new, index):
    B = k_new.shape[0]
    if (k_cache.dtype not in build.DTYPE_CODE
            or k_new.dtype not in build.DTYPE_CODE):
        raise TypeError(f"{name}: dtypes {k_new.dtype} -> "
                        f"{k_cache.dtype} not supported")
    if v_cache.dtype != k_cache.dtype or v_new.dtype != k_new.dtype:
        raise TypeError(f"{name}: k and v dtypes differ")
    if index.dtype != torch.int32 or tuple(index.shape) != (B,):
        raise TypeError(f"{name}: index must be int32 of shape (B,)")


def cache_update(k_cache, v_cache, k_new, v_new, index, *, q=None, cos=None,
                 sin=None, rotary_pct=1.0):
    """Write k/v_new (B, Sn, K, D) into the caches (B, S, K, D) IN PLACE at
    per-slot offsets ``index`` (B,) int32, cast to the cache dtype.  A slot
    with index < 0 or index + Sn > S is dropped whole (done-slot
    semantics).  Returns (k_cache, v_cache).

    With ``q`` (B, Sn, H, D) and ``cos``/``sin`` (B, Sn, rot_dim / 2)
    float32 (``rope_cos_sin``'s), the same launch first applies RoPE to q
    and k_new as ``ref.apply_rope`` does (``rotary_pct`` of each head) and
    writes the rotated k; q is rotated for every slot, dropped ones too.
    Returns (k_cache, v_cache, rotated q)."""
    rot_dim = _rot_dim("cache_update", k_new, q, cos, sin, rotary_pct)
    if not k_cache.is_cuda:
        if rot_dim is None:
            return ref.kv_cache_update_ref(k_cache, v_cache, k_new, v_new,
                                           index)
        return ref.rope_kv_cache_update_ref(k_cache, v_cache, k_new, v_new,
                                            index, q, cos, sin, rotary_pct)
    _refuse_grad("cache_update", q, k_new, v_new)
    B, Sn, K, D = k_new.shape
    S = k_cache.shape[1]
    _check_scatter("cache_update", k_cache, v_cache, k_new, v_new, index)
    if (v_new.shape != k_new.shape or k_cache.shape != v_cache.shape
            or tuple(k_cache.shape) != (B, S, K, D)):
        raise ValueError(f"cache_update: shapes new {tuple(k_new.shape)}, "
                         f"caches {tuple(k_cache.shape)}")
    rope = {}
    if rot_dim is not None:
        _check_rope("cache_update", k_new, q, cos, sin, rot_dim)
        rope = dict(q=q, cos=cos, sin=sin)
    build.check_cuda("cache_update", k_cache.device, k_cache=k_cache,
                     v_cache=v_cache, k_new=k_new, v_new=v_new, index=index,
                     **rope)
    q_out = None if rot_dim is None else torch.empty_like(q)
    err = build.library("cache_update").cache_update(
        k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), index.data_ptr(), _ptr(q), _ptr(q_out),
        _ptr(cos), _ptr(sin), B, Sn, S, 0 if q is None else q.shape[2], K,
        D, rot_dim or 0, build.DTYPE_CODE[k_new.dtype],
        build.DTYPE_CODE[k_cache.dtype],
        torch.cuda.current_stream(k_cache.device).cuda_stream)
    build.raise_on("cache_update", err)
    cache_update.launches += 1
    if q_out is None:
        return k_cache, v_cache
    return k_cache, v_cache, q_out


cache_update.launches = 0


def cache_update_paged(k_pool, v_pool, k_new, v_new, index, block_tables, *,
                       q=None, cos=None, sin=None, rotary_pct=1.0):
    """Write k/v_new (B, Sn, K, D) into the pools (n_blocks, bs, K, D) IN
    PLACE: row j of slot b lands at block ``block_tables[b, (index[b]+j)
    // bs]``, offset ``(index[b]+j) % bs``, cast to the pool dtype.  A slot
    with index < 0 or index + Sn > max_blocks * bs is dropped whole; a row
    whose block id lies outside the pool is dropped.  Returns the pools;
    with ``q``, ``cos`` and ``sin``, RoPE in the same launch, as
    ``cache_update``'s, and (k_pool, v_pool, rotated q)."""
    rot_dim = _rot_dim("cache_update_paged", k_new, q, cos, sin,
                       rotary_pct)
    if not k_pool.is_cuda:
        if rot_dim is None:
            return ref.kv_cache_update_paged_ref(k_pool, v_pool, k_new,
                                                 v_new, index, block_tables)
        return ref.rope_kv_cache_update_ref(k_pool, v_pool, k_new, v_new,
                                            index, q, cos, sin, rotary_pct,
                                            block_tables=block_tables)
    _refuse_grad("cache_update_paged", q, k_new, v_new)
    B, Sn, K, D = k_new.shape
    n_blocks, bs = k_pool.shape[:2]
    _check_scatter("cache_update_paged", k_pool, v_pool, k_new, v_new, index)
    if (block_tables.dtype != torch.int32 or block_tables.ndim != 2
            or block_tables.shape[0] != B):
        raise TypeError("cache_update_paged: block_tables must be int32 of "
                        "shape (B, max_blocks)")
    if (v_new.shape != k_new.shape or k_pool.shape != v_pool.shape
            or tuple(k_pool.shape[2:]) != (K, D)):
        raise ValueError(f"cache_update_paged: shapes new "
                         f"{tuple(k_new.shape)}, pools {tuple(k_pool.shape)}")
    rope = {}
    if rot_dim is not None:
        _check_rope("cache_update_paged", k_new, q, cos, sin, rot_dim)
        rope = dict(q=q, cos=cos, sin=sin)
    build.check_cuda("cache_update_paged", k_pool.device, k_pool=k_pool,
                     v_pool=v_pool, k_new=k_new, v_new=v_new, index=index,
                     block_tables=block_tables, **rope)
    q_out = None if rot_dim is None else torch.empty_like(q)
    err = build.library("cache_update_paged").cache_update_paged(
        k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), index.data_ptr(), block_tables.data_ptr(),
        _ptr(q), _ptr(q_out), _ptr(cos), _ptr(sin), B, Sn, bs,
        block_tables.shape[1], n_blocks, 0 if q is None else q.shape[2], K,
        D, rot_dim or 0, build.DTYPE_CODE[k_new.dtype],
        build.DTYPE_CODE[k_pool.dtype],
        torch.cuda.current_stream(k_pool.device).cuda_stream)
    build.raise_on("cache_update_paged", err)
    cache_update_paged.launches += 1
    if q_out is None:
        return k_pool, v_pool
    return k_pool, v_pool, q_out


cache_update_paged.launches = 0


def _check_attention(name, q, k, v):
    B, Sq, H, D = q.shape
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: k and v must have q's dtype")
    if (k.shape != v.shape or k.ndim != 4 or k.shape[0] != B
            or k.shape[3] != D or H % k.shape[2]):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if D not in (32, 64, 128):
        raise ValueError(f"{name}: head_dim {D} not in (32, 64, 128)")


def _flags(causal, local_window, softcap):
    return (int(bool(causal)), float(softcap) if softcap is not None else 0.0,
            int(local_window) if local_window is not None else 0)


def flash_attention(q, k, v, *, causal=True, local_window=None, softcap=None,
                    scale=None):
    """Cache-free GQA attention forward.  q: (B, Sq, H, D); k/v: (B, Sk, K,
    D).  Returns ``out`` (B, Sq, H, D) in q's dtype and the f32 log-sum-exp
    ``lse`` (B, H, Sq) of each query row's visible logits (the statistic
    ``flash_attention_bwd`` needs)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        kw = dict(causal=causal, local_window=local_window, softcap=softcap,
                  scale=scale)
        return ref.attention_naive(q, k, v, return_lse=True, **kw)
    _check_attention("flash_attention", q, k, v)
    build.check_cuda("flash_attention", q.device, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    causal_i, cap, window = _flags(causal, local_window, softcap)
    err = build.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, K, D, build.DTYPE_CODE[q.dtype],
        causal_i, float(scale), cap, window,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("flash_attention", err)
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        local_window=None, softcap=None, scale=None):
    """Gradient of ``flash_attention`` from its saved ``out`` and ``lse``
    and the output's cotangent ``dout`` (q's shape and dtype).  Returns
    (dq, dk, dv) shaped and typed like q, k, v; dk and dv sum over the
    query heads of each kv head, in a fixed order (no atomics)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    if not q.is_cuda:
        return ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                     local_window=local_window,
                                     softcap=softcap, scale=scale)
    _check_attention("flash_attention_bwd", q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: out and dout must have q's "
                        "shape and dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq):
        raise TypeError("flash_attention_bwd: lse must be float32 of shape "
                        "(B, H, Sq)")
    build.check_cuda("flash_attention_bwd", q.device, q=q, k=k, v=v, out=out,
                lse=lse, dout=dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    causal_i, cap, window = _flags(causal, local_window, softcap)
    err = build.library("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, K, D,
        build.DTYPE_CODE[q.dtype], causal_i, float(scale), cap, window,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0

#: Every kernel wrapper of the package, for launch counting: the six
#: above, ``kernels/grouped_matmul.py``'s (the MoE expert FFN) and
#: ``kernels/ssd.py``'s (the Mamba-2 scan).
KERNELS = (flash_decode, flash_decode_paged, cache_update, cache_update_paged,
           flash_attention, flash_attention_bwd, grouped_matmul, ssd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
