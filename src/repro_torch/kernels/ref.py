"""Plain PyTorch versions of the kernels on the port's path.

Each function mirrors its oracle in ``repro/kernels/ref.py`` line for
line.  The CPU path of every kernel wrapper runs these, the CPU tests
hold them against the JAX package, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  The CUDA path never calls them.

``bf16_parts``, ``attention_tc_emulated``,
``decode_attention_tc_emulated`` and ``ssd_tc_emulated`` have no oracle:
they redo the bf16 tensor-core kernels' arithmetic (the f32 operands, such
as P and dS, handed to the tensor cores in bf16 parts) so the CPU tests
and ``chip_smoke.py`` can show which choice the per-entry check accepts.  ``decode_attention_split`` has none either: it
is the decode kernels' split-KV order of sums (fixed spans of kv rows,
combined in span order), held against ``decode_attention_ref`` and the
JAX ``flash_decode`` by the CPU tests.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap is not None else x


def _mask(q_pos, k_pos, causal: bool, local_window):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if local_window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < local_window
    return m


def attention_naive(q, k, v, *, causal=True, local_window=None, softcap=None,
                    scale=None, kv_len=None, return_lse=False):
    """Full-matrix GQA attention.

    q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0.
    kv_len: optional (B,) active cache length (decode); when given, q
    positions are laid at the END of the kv window.
    return_lse: also return the f32 log-sum-exp (B, H, Sq) of each row's
    visible logits, the statistic the backward recomputes P from.
    """
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, K, G, D)
    kf = k.float()
    vf = v.float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    logits = _softcap(logits, softcap)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    if kv_len is not None:
        q_pos = q_pos[None, :] + kv_len.long()[:, None] - Sq    # (B, Sq)
        mask = q_pos[:, :, None] >= k_pos[None, None, :]
        if local_window is not None:
            mask &= q_pos[:, :, None] - k_pos[None, None, :] < local_window
        mask = mask[:, None, None, :, :]
    else:
        mask = _mask(q_pos, k_pos, causal, local_window)[None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(B, H, Sq)
    return out


def attention_blockwise(q, k, v, *, causal=True, local_window=None,
                        softcap=None, scale=None, block_kv=1024,
                        return_lse=False):
    """Online-softmax attention over kv blocks of ``block_kv`` rows: the
    reference's memory-safe path for long sequences (O(Sq * block_kv)
    logits instead of O(Sq * Sk)).  ``return_lse`` as ``attention_naive``
    (m + log l of the online softmax)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    block_kv = min(block_kv, Sk)
    nkv = (Sk + block_kv - 1) // block_kv
    pad = nkv * block_kv - Sk
    qf = (q.float() * scale).reshape(B, Sq, K, G, D)
    kb = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vb = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, K, G, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, K, G, Sq), device=q.device)
    acc = torch.zeros((B, K, G, Sq, D), device=q.device)
    for j in range(nkv):
        kc = kb[:, j * block_kv:(j + 1) * block_kv]
        vc = vb[:, j * block_kv:(j + 1) * block_kv]
        logits = _softcap(torch.einsum("bqkgd,bskd->bkgqs", qf, kc), softcap)
        k_pos = j * block_kv + torch.arange(block_kv, device=q.device)
        msk = _mask(q_pos, k_pos, causal, local_window) & (k_pos < Sk)[None]
        logits = torch.where(msk, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, H, Sq)
    return out


def _logits(q, k, causal, local_window, softcap, scale):
    """(B, K, G, Sq, Sk) f32 logits after scale and softcap, the raw
    tanh(s / softcap) (for the softcap's derivative) and the mask: what
    ``attention_bwd_ref`` recomputes P from."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _mask(torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, local_window)
    return s, t, mask


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True,
                      local_window=None, softcap=None, scale=None):
    """Gradient of the cache-free attention, by the FlashAttention
    formulas: P = exp(S - lse) on the visible keys, dV = P^T dO,
    dP = dO V^T, dS = P * (dP - rowsum(dO * O)), times the softcap's
    1 - tanh^2(s / c), dQ = dS K * scale, dK = dS^T Q * scale; dK and dV
    sum over the G query heads of each kv head.  f32 maths; each gradient
    in its input's dtype."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    s, t, mask = _logits(q, k, causal, local_window, softcap, scale)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, Sq, 1)),
                    torch.zeros_like(s))
    of = out.float().reshape(B, Sq, K, G, D)
    dof = dout.float().reshape(B, Sq, K, G, D)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)          # (B, K, G, Sq)
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    qf = q.float().reshape(B, Sq, K, G, D)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bf16_parts(x, parts: int):
    """f32 ``x`` as ``parts`` bf16 terms, each the bf16 rounding of what the
    earlier ones leave: 1 gives bf16(x); 2 gives hi = bf16(x) and lo =
    bf16(x - hi), whose sum carries x to ~2^-16 of itself."""
    terms, rest = [], x.float()
    for _ in range(parts):
        terms.append(rest.to(torch.bfloat16).float())
        rest = rest - terms[-1]
    return terms


def attention_tc_emulated(q, k, v, out, lse, dout, *, parts: int,
                          causal=True, local_window=None, softcap=None,
                          scale=None):
    """The bf16 tensor-core kernels' arithmetic in plain PyTorch: the f32
    probabilities P (exp(S - max), normalised by their sum after the
    product) and, for dq, dS are handed to their products with V and K as
    ``bf16_parts(., parts)``, one f32 product per term; the other operands
    are bf16 already.  ``out`` and ``lse`` are the forward's saved values
    (dq's P and delta come from them, as in the backward).  Returns (out,
    dq) in q's dtype.  With parts=2 this is the kernels' design; parts=1
    is the shortcut the checks must reject."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    s, t, mask = _logits(q, k, causal, local_window, softcap, scale)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    acc = sum(torch.einsum("bkgqs,bskd->bkgqd", part, v.float())
              for part in bf16_parts(e, parts))
    o = acc / e.sum(-1, keepdim=True).clamp(min=1e-30)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)

    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, Sq, 1)),
                    torch.zeros_like(s))
    dof = dout.float().reshape(B, Sq, K, G, D)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    delta = (dof * out.float().reshape(B, Sq, K, G, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = sum(torch.einsum("bkgqs,bskd->bqkgd", part, k.float())
             for part in bf16_parts(ds, parts)) * scale
    return o, dq.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, kv_len, *, scale=None,
                         softcap=None, local_window=None):
    """Decode/chunked-prefill attention: q (B, Sq, H, D) laid at the END of
    the valid kv window, cache (B, S, K, D), kv_len (B,) valid lengths
    INCLUDING the Sq current tokens (per-slot ragged).  A done lane's
    kv_len = S + 1 sees all S rows, like the kernel."""
    return attention_naive(q, k_cache, v_cache, causal=True,
                           local_window=local_window, softcap=softcap,
                           scale=scale, kv_len=kv_len)


def _decode_logits(q, k_cache, kv_len, scale, softcap, local_window):
    """(B, K, G, Sq, S) f32 logits of the decode layout (q at the END of
    each slot's kv_len window) after scale and softcap, and their mask, as
    ``attention_naive`` computes them with ``kv_len``."""
    B, Sq, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, K, H // K, D)
    s = _softcap(torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float())
                 * scale, softcap)
    q_pos = torch.arange(Sq, device=q.device)[None] + kv_len.long()[:, None] \
        - Sq
    k_pos = torch.arange(S, device=q.device)
    mask = q_pos[:, :, None] >= k_pos[None, None, :]
    if local_window is not None:
        mask &= q_pos[:, :, None] - k_pos[None, None, :] < local_window
    return s, mask[:, None, None]


def decode_attention_split(q, k_cache, v_cache, kv_len, *, span, scale=None,
                           softcap=None, local_window=None):
    """``decode_attention_ref`` in the decode kernels' order of sums:
    each slot's kv rows cut into fixed spans of ``span`` positions
    ([0, span), [span, 2 span), ...), an online-softmax state (m, l, acc)
    per span, the states combined in span order (M = max m, L = sum l
    e^(m - M), acc = sum acc e^(m - M), out = acc / max(L, 1e-30)).  The
    cache is zero-padded to whole spans, so a larger cache (a paged slot's
    max_blocks * bs rows) only adds spans no live row sees, which add
    exact zeros: the result does not depend on it."""
    B, Sq, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    pad = -S % span
    kp = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    s, mask = _decode_logits(q, kp, kv_len, scale, softcap, local_window)
    mask = mask & (torch.arange(S + pad, device=q.device) < S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    states = []
    for j in range(0, S + pad, span):
        sj, mj = s[..., j:j + span], mask[..., j:j + span]
        m = sj.amax(-1)
        e = torch.exp(sj - m[..., None]) * mj
        states.append((m, e.sum(-1),
                       torch.einsum("bkgqs,bskd->bkgqd", e, vp[:, j:j + span])))
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L = torch.zeros_like(M)
    acc = torch.zeros(M.shape + (D,), device=q.device)
    for m, l, a in states:
        sc = torch.exp(m - M)
        L = L + l * sc
        acc = acc + a * sc[..., None]
    out = acc / torch.clamp(L, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_tc_emulated(q, k_cache, v_cache, kv_len, *, parts: int,
                                 scale=None, softcap=None, local_window=None):
    """The bf16 prefill-chunk kernel's arithmetic in plain PyTorch: the f32
    probabilities P (exp(S - max), normalised by their sum after the
    product) handed to the product with V as ``bf16_parts(P, parts)``, one
    f32 product per term; q, K and V are bf16 already.  With parts=2 this
    is the kernel's design; parts=1 is the shortcut the checks must
    reject.  Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    s, mask = _decode_logits(q, k_cache, kv_len, scale, softcap,
                             local_window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    acc = sum(torch.einsum("bkgqs,bskd->bkgqd", part, v_cache.float())
              for part in bf16_parts(e, parts))
    o = acc / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def apply_rope(x, cos, sin, rotary_pct: float = 1.0):
    """RoPE (``repro/models/layers.py::apply_rope``): x (B, S, H, D), the
    first ``rot_dim`` dims of each head rotated by cos/sin (B, S,
    rot_dim / 2) float32, the tail kept.  Each product and sum is its own
    f32 rounding; the rotated values are rounded once to x's dtype."""
    D = x.shape[-1]
    rot_dim = int(D * rotary_pct) // 2 * 2
    half = rot_dim // 2
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., :half], xr[..., half:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    rotated = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], -1)
    return torch.cat([rotated.to(x.dtype), xp], -1)


def kv_cache_update_ref(k_cache, v_cache, k_new, v_new, index):
    """Per-slot-offset cache write: scatter k/v_new (B, Sn, K, D) into
    (B, S, K, D) at row offsets ``index`` (B,).  A slot whose write would
    cross the cache end (or start before it) is dropped WHOLE, not
    element-wise clipped.  Unlike the functional JAX oracle this writes
    IN PLACE, as the port's caches are updated in place; it returns the
    two caches."""
    Sn = k_new.shape[1]
    S = k_cache.shape[1]
    index = index.long()
    ok = (index >= 0) & (index + Sn <= S)
    rows = torch.nonzero(ok).flatten()
    pos = index[rows][:, None] + torch.arange(Sn, device=index.device)[None]
    k_cache[rows[:, None], pos] = k_new[rows].to(k_cache.dtype)
    v_cache[rows[:, None], pos] = v_new[rows].to(v_cache.dtype)
    return k_cache, v_cache


def paged_gather_ref(pool, block_tables):
    """The dense (B, max_blocks * bs, K, D) view of a paged pool
    (n_blocks, bs, K, D) that each slot's ``block_tables`` row
    ((B, max_blocks) int) describes.  Block ids are clipped into the pool,
    as the reference's ``mode="clip"``."""
    n_blocks, bs = pool.shape[:2]
    B, max_blocks = block_tables.shape
    ids = block_tables.long().clamp(0, n_blocks - 1).reshape(-1)
    return pool[ids].reshape((B, max_blocks * bs) + tuple(pool.shape[2:]))


def decode_attention_paged_ref(q, k_pool, v_pool, kv_len, block_tables, *,
                               scale=None, softcap=None, local_window=None):
    """Paged decode/chunked-prefill attention: gather each slot's blocks
    into the dense view, then ``decode_attention_ref`` -- so the result is
    bit-identical to the dense plain path over the gathered cache."""
    return decode_attention_ref(q, paged_gather_ref(k_pool, block_tables),
                                paged_gather_ref(v_pool, block_tables),
                                kv_len, scale=scale, softcap=softcap,
                                local_window=local_window)


def kv_cache_update_paged_ref(k_pool, v_pool, k_new, v_new, index,
                              block_tables):
    """Paged per-slot cache write: scatter k/v_new (B, Sn, K, D) into the
    pools (n_blocks, bs, K, D) at the (block, offset) each slot's table
    maps its rows [index, index + Sn) to.  A slot whose write would cross
    its table's logical end (max_blocks * bs rows) or start below 0 is
    dropped WHOLE; a row whose block id lies outside the pool is dropped,
    as the reference's ``mode="drop"``.  Writes IN PLACE (the reference is
    functional); returns the two pools."""
    Sn = k_new.shape[1]
    n_blocks, bs = k_pool.shape[:2]
    S = block_tables.shape[1] * bs
    index = index.long()
    ok = (index >= 0) & (index + Sn <= S)
    rows = torch.nonzero(ok).flatten()
    pos = index[rows][:, None] + torch.arange(Sn, device=index.device)[None]
    blk = block_tables.long()[rows[:, None], pos // bs]
    keep = (blk >= 0) & (blk < n_blocks)
    blk, off = blk[keep], (pos % bs)[keep]
    k_pool[blk, off] = k_new[rows][keep].to(k_pool.dtype)
    v_pool[blk, off] = v_new[rows][keep].to(v_pool.dtype)
    return k_pool, v_pool


def rope_kv_cache_update_ref(k_cache, v_cache, k_new, v_new, index, q, cos,
                             sin, rotary_pct=1.0, block_tables=None):
    """The serving step's RoPE and cache write as separate passes: q and
    k_new rotated by ``apply_rope``, then ``kv_cache_update_ref`` (or, with
    ``block_tables``, ``kv_cache_update_paged_ref``) of the rotated k and
    v_new.  The plain version of the ``cache_update(_paged)`` kernels
    called with q, cos and sin; returns (k_cache, v_cache, rotated q)."""
    q = apply_rope(q, cos, sin, rotary_pct)
    k = apply_rope(k_new, cos, sin, rotary_pct)
    if block_tables is None:
        kv_cache_update_ref(k_cache, v_cache, k, v_new, index)
    else:
        kv_cache_update_paged_ref(k_cache, v_cache, k, v_new, index,
                                  block_tables)
    return k_cache, v_cache, q


# ===========================================================================
# portable slot state: slot lanes and int8 payload compression
# ===========================================================================
#
# The reference routes these to XLA in every mode (``repro/kernels/
# ops.py:107-147``): no Pallas kernel to port, so the plain versions are
# the port's path on the card too.

def slot_gather(a, slot: int, axis: int = 1):
    """Lift one slot's lane out of a stacked cache leaf: drop ``axis`` (the
    batch/slot dim) at index ``slot``, (L, B, ...) -> (L, ...).  A COPY,
    as the reference's value: later writes to ``a`` do not reach it."""
    return a.select(axis, slot).clone()


def slot_scatter(a, sub, slot: int, axis: int = 1):
    """Install a lifted lane into a stacked cache leaf at index ``slot``
    along ``axis`` (cast to ``a``'s dtype), IN PLACE (the reference is
    functional); returns ``a``."""
    a.select(axis, slot).copy_(sub)
    return a


def int8_quantize(a, axis: int = -1):
    """Symmetric per-row int8 quantization (``int8_quantize_ref``): the
    scale is the row's absmax over ``axis`` in float32 divided by 127,
    floored at 1e-12 (f32, kept dim); q is round-half-to-even of the
    float32 value divided (not multiplied by a reciprocal) by the scale,
    clipped to +-127.  Bit-equal to the reference's q and scale."""
    f = a.float()
    scale = f.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(f / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale, dtype):
    """Inverse of ``int8_quantize``: q * scale in float32, cast to
    ``dtype``."""
    return (q.float() * scale).to(dtype)


# ===========================================================================
# grouped matmul (MoE expert GEMM)
# ===========================================================================

def grouped_matmul(lhs, rhs):
    """lhs: (G, M, K), rhs: (G, K, N) -> (G, M, N) in lhs's dtype, the
    products summed in float32 and rounded once (``grouped_matmul_ref``)."""
    return torch.einsum("gmk,gkn->gmn", lhs.float(),
                        rhs.float()).to(lhs.dtype)


# ===========================================================================
# mamba-2 SSD (state-space duality)
# ===========================================================================

def ssd_naive(x, dt, A, B, C, D=None, h0=None):
    """Sequential recurrence oracle (exact, O(S) steps).

    x: (Bb, S, H, P); dt: (Bb, S, H); A: (H,) negative; B/C: (Bb, S, G, N).
    Returns y: (Bb, S, H, P) and final state (Bb, H, P, N) in float32.
    """
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf, dtf = x.float(), dt.float()
    Bh = torch.repeat_interleave(B.float(), rep, dim=2)   # (Bb,S,H,N)
    Ch = torch.repeat_interleave(C.float(), rep, dim=2)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        a = torch.exp(A[None] * dtf[:, t])                 # (Bb,H)
        inc = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           Bh[:, t])
        h = h * a[..., None, None] + inc
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)                             # (Bb,S,H,P)
    if D is not None:
        y = y + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def _segsum(a):
    """Stable segment-sum: M[..., i, j] = sum_{j<k<=i} a[..., k], -inf j>i."""
    S = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    M = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=a.device))
    return M.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D=None, h0=None, chunk=128):
    """Chunked SSD (Mamba-2 Listing 1): quadratic intra-chunk + linear
    inter-chunk state passing.  Same math as ssd_naive; the ``D`` skip is
    added in float32 and y rounded once to x's dtype.  A float64 x sums
    everything in float64 (a reference no float32 order of sums moves)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    xf = x.to(acc).reshape(Bb, nc, chunk, H, P)
    dtf = dt.to(acc).reshape(Bb, nc, chunk, H)
    Bf = torch.repeat_interleave(B.to(acc), rep, 2).reshape(Bb, nc, chunk,
                                                            H, N)
    Cf = torch.repeat_interleave(C.to(acc), rep, 2).reshape(Bb, nc, chunk,
                                                            H, N)
    xdt = xf * dtf[..., None]
    a = A.to(acc)[None, None, None] * dtf             # (Bb,nc,Q,H) log-decay
    a = a.movedim(-1, -2)                             # (Bb,nc,H,Q)
    a_cs = torch.cumsum(a, dim=-1)

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(a))                         # (Bb,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf)
    y_diag = torch.einsum("bchqk,bchqk,bckhp->bcqhp", scores, L, xdt)

    # 2) per-chunk final states
    decay = torch.exp(a_cs[..., -1:] - a_cs)          # (Bb,nc,H,Q)
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn", decay, Bf, xdt)

    # 3) inter-chunk recurrence over chunk states (state BEFORE chunk t)
    chunk_decay = torch.exp(a_cs[..., -1])            # (Bb,nc,H)
    h = (torch.zeros((Bb, H, P, N), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    h_prevs = []
    for t in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, t][..., None, None] + states[:, t]
    h_prev = torch.stack(h_prevs, dim=1)              # (Bb,nc,H,P,N)

    # 4) inter-chunk contribution
    out_decay = torch.exp(a_cs)                       # (Bb,nc,H,Q)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cf, h_prev, out_decay)

    y = (y_diag + y_off).reshape(Bb, S, H, P)
    if D is not None:
        y = y + x.to(acc) * D.to(acc)[None, None, :, None]
    return y.to(x.dtype), h


def _f32_product(eq, *ops):
    """``torch.einsum`` of f32 operands summed in float64 and rounded once
    to f32: a product whose every term is exact (a bf16 part times a bf16
    input) comes out the same on any host, whatever order the host's BLAS
    sums in."""
    return torch.einsum(eq, *(o.double() for o in ops)).float()


def ssd_tc_emulated(x, dt, A, B, C, D=None, h0=None, *, chunk, parts: int):
    """The bf16 tensor-core ``ssd`` kernel's arithmetic in plain PyTorch,
    chunk by chunk as the kernel walks them: the scores C B^T from the
    inputs (exact products, f32 sums); the f32 operands of the three other
    products handed to them as ``bf16_parts(., parts)``, one f32 product
    per term -- the masked M = (C B^T) o L o dt for M x, the carried state
    for C state^T, and x o wd (wd = dt exp(a_cs[Q-1] - a_cs)) for the
    state update (x o wd)^T B; the state itself carried in f32, scaled by
    exp(a_cs[Q-1]) exactly.  D is added in f32 and y rounded once.  With
    parts=2 this is the kernel's design; parts=1 is the shortcut the
    checks must reject.  Each product is summed exactly and rounded once
    (``_f32_product``), so the emulation does not move with the host.
    Returns (y in x's dtype, the final f32 state)."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf, dtf = x.float(), dt.float()
    Bf = torch.repeat_interleave(B.float(), rep, 2)          # (Bb,S,H,N)
    Cf = torch.repeat_interleave(C.float(), rep, 2)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for s0 in range(0, S, chunk):
        xc, dc = xf[:, s0:s0 + chunk], dtf[:, s0:s0 + chunk]
        Bc, Cc = Bf[:, s0:s0 + chunk], Cf[:, s0:s0 + chunk]
        a_cs = torch.cumsum(A[None, None] * dc, dim=1)       # (Bb,Q,H)
        seg = a_cs[:, :, None] - a_cs[:, None, :]            # (Bb,i,j,H)
        L = torch.exp(torch.where(tri, seg, torch.full_like(seg, NEG_INF)))
        m = _f32_product("bihn,bjhn->bijh", Cc, Bc) * L * dc[:, None]
        y_off = sum(_f32_product("bihn,bhpn->bihp", Cc, part)
                    for part in bf16_parts(h, parts))
        y = torch.exp(a_cs)[..., None] * y_off + sum(
            _f32_product("bijh,bjhp->bihp", part, xc)
            for part in bf16_parts(m, parts))
        a_last = a_cs[:, -1]                                 # (Bb,H)
        xw = xc * (dc * torch.exp(a_last[:, None] - a_cs))[..., None]
        h = h * torch.exp(a_last)[..., None, None] + sum(
            _f32_product("bqhp,bqhn->bhpn", part, Bc)
            for part in bf16_parts(xw, parts))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if D is not None:
        y = y + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D=None):
    """One decode step of the SSM recurrence.  state: (Bb,H,P,N) float32;
    x_t: (Bb,H,P); dt_t: (Bb,H); B_t/C_t: (Bb,G,N).  Returns (y_t in x_t's
    dtype, the new state)."""
    H = x_t.shape[-2]
    G = B_t.shape[-2]
    rep = H // G
    a = torch.exp(A[None] * dt_t.float())             # (Bb,H)
    Bh = torch.repeat_interleave(B_t.float(), rep, dim=-2)
    Ch = torch.repeat_interleave(C_t.float(), rep, dim=-2)
    inc = torch.einsum("bhp,bhn->bhpn", x_t.float() * dt_t.float()[..., None],
                       Bh)
    state = state * a[..., None, None] + inc
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    if D is not None:
        y = y + x_t.float() * D[None, :, None]
    return y.to(x_t.dtype), state
