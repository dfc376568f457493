"""Gradient compression, ported from ``repro/train/compression.py``.

  * ``int8_compress_decompress``: per-tensor int8 quantize->dequantize of
    the gradients (the numerics of a compressed all-reduce), with optional
    error feedback; the train step applies it to the reduced gradients.
  * ``compressed_psum``: the collective itself over data-parallel mesh
    axes: a shared scale from a max all-reduce, the int8 payload summed as
    int32, dequantized and averaged.  As in the reference, nothing calls
    it: it is a function with its test.
"""

from __future__ import annotations

import torch

from repro_torch.sharding import collectives as C
from repro_torch.tree import leaves, tree_map


def _quant(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def int8_compress_decompress(grads, error=None, absmax=None):
    """Per-tensor symmetric int8 quantize->dequantize (+ optional error
    feedback), IN PLACE on ``grads`` (and ``error``).  Returns grads (and
    the error state when given), the same objects.  ``absmax(g)``, if
    given, is the max |entry| of the whole leaf ``g`` is a shard of."""
    errs = leaves(error) if error is not None else [None] * len(leaves(grads))
    for g, e in zip(leaves(grads), errs):
        gf = g.float()
        if e is not None:
            gf = gf + e
        amax = absmax(g) if absmax is not None else torch.max(torch.abs(gf))
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = _quant(gf, scale)
        dq = q.float() * scale
        if e is not None:
            e.copy_(gf - dq)
        g.copy_(dq)
    return grads if error is None else (grads, error)


@torch.no_grad()
def compressed_psum(grads, axis_names, mesh):
    """int8-wire all-reduce over the mesh axes ``axis_names`` (the
    reference's, ``repro/train/compression.py:53-72``, which runs inside
    ``shard_map``): sum_i g_i ~ s * sum_i q_i with one scale s = max_i
    max|g_i| / 127 agreed by a max all-reduce, the payload summed as int32,
    then divided by the number of ranks (a mean).  Returns a new tree."""
    n = mesh.axis_size(axis_names)

    def one(g):
        gf = g.float()
        scale = torch.clamp(C.pmax(torch.max(torch.abs(gf)), axis_names,
                                   mesh), min=1e-12) / 127.0
        total = C.psum(_quant(gf, scale).to(torch.int32), axis_names, mesh)
        return (total.float() * scale / n).to(g.dtype)

    return tree_map(one, grads)
