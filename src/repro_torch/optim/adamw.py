"""Optimizers, ported from ``repro/optim/adamw.py``.

AdamW keeps f32 first and second moments per parameter; Adafactor keeps
factored second moments.  The state mirrors the parameter dict, as the
reference's does, so a JAX optimizer state loads leaf for leaf.

Unlike the reference, which is functional, ``update`` works IN PLACE,
leaf by leaf (``mul_``, ``addcmul_``, ``add_``): parameters, moments and
(for the clip) gradients are overwritten.  A whole-tree out-of-place
update of a 3.21 B-parameter f32 state needs another ~51 GB and does not
fit beside it on an 80 GB card.  AdamW walks each leaf in chunks of
``CHUNK`` elements, so its temporaries stay small too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map

CHUNK = 1 << 24      # elements per AdamW update chunk (64 MB in f32)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient IN PLACE by min(1, max_norm / global norm).
    Returns (grads, the global norm as a 0-d f32 tensor)."""
    gs = leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    with torch.no_grad():
        for g in gs:
            g.mul_(scale.to(g.dtype))
    return grads, gn


def _chunks(*tensors):
    """Matching flat chunks of equally shaped contiguous tensors, as views
    (writes reach the tensors)."""
    return zip(*(t.view(-1).split(CHUNK) for t in tensors))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """One AdamW step at ``step`` (0-based), in place.  Returns
        (params, state), the same objects."""
        lr = float(self.lr(step) if callable(self.lr) else self.lr)
        t = float(step) + 1.0
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                              leaves(state["v"]), leaves(params)):
            for gc, mc, vc, pc in _chunks(g, m, v, p):
                gf = gc.float()
                mc.mul_(self.b1).add_(gf, alpha=1 - self.b1)
                vc.mul_(self.b2).addcmul_(gf, gf, value=1 - self.b2)
                delta = (mc / bc1).div_((vc / bc2).sqrt_().add_(self.eps))
                delta.add_(pc.float(), alpha=self.weight_decay)
                pc.copy_(pc.float() - lr * delta)
        return params, state


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern 2018, simplified).

    Matrices (>=2D) store row/col second-moment vectors instead of a full
    moment tensor: O(n+m) state instead of O(nm)."""

    lr: Callable | float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params):
        def state_for(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.ndim >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(state_for, params)}

    @torch.no_grad()
    def update(self, grads, state, params, step):
        """One Adafactor step at ``step`` (0-based), in place, leaf by
        leaf.  Returns (params, state), the same objects."""
        lr = float(self.lr(step) if callable(self.lr) else self.lr)
        t = float(step) + 1.0
        beta = 1.0 - t ** -self.decay
        for g, s, p in zip(leaves(grads), _per_param(params, state["f"]),
                           leaves(params)):
            gf = g.float()
            g2 = gf * gf + self.eps
            if p.ndim >= 2:
                s["vr"].mul_(beta).add_(g2.mean(dim=-1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(g2.mean(dim=-2), alpha=1 - beta)
                vr, vc = s["vr"], s["vc"]
                denom = vr[..., None] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=self.eps)
                u = gf / torch.sqrt(torch.clamp(denom * vc[..., None, :],
                                                min=self.eps))
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                u = gf / torch.sqrt(torch.clamp(s["v"], min=self.eps))
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        return params, state


def _per_param(params, f):
    """The per-parameter state dicts ({"vr", "vc"} or {"v"}) of an
    Adafactor state ``f``, in parameter-leaf order."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _per_param(params[k], f[k])
    else:
        yield f
