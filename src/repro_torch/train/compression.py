"""Gradient compression, ported from ``repro/train/compression.py``:
``int8_compress_decompress`` only.  Its collective, ``compressed_psum``,
comes with the distributed slice (ROADMAP queue 1 item 14)."""

from __future__ import annotations

import torch

from repro_torch.tree import leaves


@torch.no_grad()
def int8_compress_decompress(grads, error=None):
    """Per-tensor symmetric int8 quantize->dequantize (+ optional error
    feedback), IN PLACE on ``grads`` (and ``error``).  Returns grads (and
    the error state when given), the same objects."""
    errs = leaves(error) if error is not None else [None] * len(leaves(grads))
    for g, e in zip(leaves(grads), errs):
        gf = g.float()
        if e is not None:
            gf = gf + e
        scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        dq = q.float() * scale
        if e is not None:
            e.copy_(gf - dq)
        g.copy_(dq)
    return grads if error is None else (grads, error)
