"""Sequence-chunked cross-entropy, ported from ``repro/train/loss.py``:
the logits are never materialized at (B, S, vocab).

The same chunk rule as the reference (``logits_chunk``, shrunk until it
divides S), the same pad-vocab mask and the same ``z_loss``.  The
reference scans over the chunks; here each chunk's projection and
log-sum-exp runs under its own non-reentrant ``torch.utils.checkpoint``
when gradients are on, so autograd keeps only each chunk's inputs and
recomputes its (B, chunk, vocab) f32 logits in the backward pass --
otherwise every chunk's logits would stay alive (1.05 GB per chunk of
1024 at B=2 and vocab 128256).

Under a mesh (``ctx.mesh``) with the vocab sharded over ``model`` (the
Megatron program) each rank computes its vocab columns' logits, and the
log-sum-exp and the gold logit come from a max and two sums over
``model`` (the reference's ``act_vocab`` reductions, which GSPMD
inserts).  Under sequence parallelism the unembedding is gathered whole
and each rank takes its rows of the sequence, whole logits per row.  Each
rank's loss is its tokens' summed cross-entropy over the global token
count (over the data-parallel axes, and ``model`` when the rows are
split over it), so the ranks' losses sum to the reference's mean
(``train/step.py`` sums the gradients).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx
from repro_torch.sharding import collectives as C


def _chunk_terms(cfg: ModelConfig, hh, W, ll, mesh=None, lo=0):
    """Per-token (lse - gold logit) and lse of one chunk.  With ``mesh``,
    ``W`` holds vocab columns [lo, lo + V_l) of this rank: the max is
    taken over ``model`` (without gradient: lse does not depend on it), the
    exponentials and the gold logit (held by one rank) are summed over it,
    each sum an all-reduce whose gradient is this rank's own."""
    logits = (hh @ W).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        cols = lo + torch.arange(W.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab, -1e30)
    if mesh is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll[..., None])[..., 0]
        return lse - gold, lse
    m = C.pmax(logits.detach().amax(-1), L.MODEL, mesh)
    total = C.reduce_from(torch.exp(logits - m[..., None]).sum(-1), L.MODEL,
                          mesh)
    lse = m + torch.log(total)
    ids = ll - lo
    mine = (ids >= 0) & (ids < W.shape[-1])
    gold = torch.gather(logits, -1, ids.clamp(0, W.shape[-1] - 1)[..., None])
    gold = C.reduce_from(gold[..., 0] * mine, L.MODEL, mesh)
    return lse - gold, lse


def chunked_cross_entropy(ctx: Ctx, cfg: ModelConfig, params, h, labels,
                          mask=None, z_loss: float = 0.0):
    """h: (B, S, D); labels: (B, S) int, -1 = padding; under sequence
    parallelism h is this rank's rows and the labels are cut to them.
    Returns (mean_ce, metrics_dict)."""
    B, S, D = h.shape
    seq = L.seq_parallel(ctx)
    if seq:
        rows = L.seq_rows(ctx, labels.shape[1])
        labels = labels[:, rows]
        mask = mask[:, rows] if mask is not None else None
        ctx = dataclasses.replace(ctx, seq_shard=True)
    W = lm.unembed_weight(ctx, cfg, params)
    lo, sharded = lm.vocab_shard(ctx, cfg, W)
    mesh = ctx.mesh if sharded else None
    if sharded:                 # a column-parallel product: dh sums over model
        h = C.copy_to(h, L.MODEL, ctx.mesh)
    chunk = min(ctx.run.logits_chunk, S)
    while S % chunk:
        chunk -= 1
    if mask is None:
        mask = labels >= 0
    maskf = mask.float()
    labels_safe = torch.clamp(labels, min=0).long()
    grad = torch.is_grad_enabled()
    tot = zt = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        hh, ll = h[:, c0:c0 + chunk], labels_safe[:, c0:c0 + chunk]
        mm = maskf[:, c0:c0 + chunk]
        if grad:
            nll, lse = torch.utils.checkpoint.checkpoint(
                _chunk_terms, cfg, hh, W, ll, mesh, lo, use_reentrant=False)
        else:
            nll, lse = _chunk_terms(cfg, hh, W, ll, mesh, lo)
        tot = tot + torch.sum(nll * mm)
        zt = zt + torch.sum(lse * lse * mm)
        cnt = cnt + torch.sum(mm)
    axes = L.token_axes(seq)
    dp = ctx.mesh is not None and ctx.mesh.axis_size(axes) > 1
    if dp:                      # the global token count (no gradient)
        cnt = C.psum(cnt, axes, ctx.mesh)
    cnt = torch.clamp(cnt, min=1.0)
    ce = tot / cnt
    loss = ce + z_loss * zt / cnt
    if dp:                      # this rank's share; the metric is the sum
        return loss, {"ce": C.psum(ce.detach(), axes, ctx.mesh),
                      "tokens": cnt}
    return loss, {"ce": ce, "tokens": cnt}
