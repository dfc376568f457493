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
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.layers import Ctx


def _chunk_terms(cfg: ModelConfig, hh, W, ll):
    """Per-token (lse - gold logit) and lse of one chunk."""
    logits = (hh @ W).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ll[..., None])[..., 0]
    return lse - gold, lse


def chunked_cross_entropy(ctx: Ctx, cfg: ModelConfig, params, h, labels,
                          mask=None, z_loss: float = 0.0):
    """h: (B, S, D); labels: (B, S) int, -1 = padding.
    Returns (mean_ce, metrics_dict)."""
    B, S, D = h.shape
    W = lm.unembed_matrix(cfg, params, ctx.cdtype)
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
                _chunk_terms, cfg, hh, W, ll, use_reentrant=False)
        else:
            nll, lse = _chunk_terms(cfg, hh, W, ll)
        tot = tot + torch.sum(nll * mm)
        zt = zt + torch.sum(lse * lse * mm)
        cnt = cnt + torch.sum(mm)
    cnt = torch.clamp(cnt, min=1.0)
    ce = tot / cnt
    loss = ce + z_loss * zt / cnt
    return loss, {"ce": ce, "tokens": cnt}
