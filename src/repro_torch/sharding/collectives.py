"""Collectives over named mesh axes, for the port's explicit per-rank
program (the reference calls ``lax`` collectives inline under
``shard_map`` and leaves the rest to GSPMD).

Plain collectives (no gradient): ``psum``, ``pmax``, ``all_gather`` and
``all_to_all`` over one axis name or a tuple of them (``Mesh.group``).
An axis of one rank makes each of them the identity.

The autograd pairs that tensor parallelism needs, with activations
replicated over the ``model`` axis and every rank's gradient of a
replicated activation the whole gradient (Megatron's convention):
  copy_to       identity forward, all-reduce backward (the input of a
                column-parallel product);
  reduce_from   all-reduce forward, identity backward (the output of a
                row-parallel product, a vocab-parallel lookup);
  scatter_to    this rank's slice forward, all-gather backward;
  gather_from   all-gather forward, this rank's slice backward;
  all_reduce    all-reduce forward, all-reduce backward (a partial sum
                that every rank's output reads: the Mamba-2 gated norm's
                sum of squares over a ``d_inner`` split by heads, whose
                true cotangent is every rank's summed);
  AllToAll      all-to-all forward, all-to-all backward (an exchange of
                equal chunks along dim 0 is its own inverse).
``gather_from``'s backward is right only where every rank's cotangent of
the gathered tensor is the same (the Megatron case).  Where each rank's
cotangent is a different partial sum -- K and V gathered over the
sequence, a weight shard gathered before use (ZeRO-3, sequence
parallelism) -- the pair is:
  gather_sum    all-gather forward (over one or several dims, optionally
                of the input cast to the compute dtype), reduce-scatter
                backward: the cotangent summed in float32 over the axes,
                then this rank's slice, in the input's dtype.
Over the data-parallel axes each rank's loss is its share of the global
loss, and gradients are summed (``train/step.py``).

Backends: with ``nccl`` (every rank has its own card) a CUDA tensor goes
to the collective as it is.  That path cannot run on a host with one
card, where NCCL refuses two ranks on one device, and it has not been
run.  With ``gloo`` (ranks that share a card, and the CPU) a CUDA tensor
is copied to the host, reduced or exchanged there, and copied back: one
code path for every op, and ``STAGED_BYTES`` counts the bytes copied
each way.  The backend is the process group's, which the caller named;
nothing switches by itself and nothing catches a failed collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: bytes a gloo collective copied from the card to the host and back, by
#: op: {"psum": n, ...}; ``reset_staged()`` zeroes it
STAGED_BYTES: dict[str, int] = {}


def reset_staged() -> None:
    STAGED_BYTES.clear()


def staged_total() -> int:
    return sum(STAGED_BYTES.values())


def _stage(op: str, mesh, t: torch.Tensor):
    """The tensor the collective runs on: ``t`` itself, or under gloo a
    host copy of a CUDA tensor (counted), in pinned memory (the caching
    host allocator keeps the blocks), which the card copies to and from
    several times faster than pageable memory."""
    if mesh.backend == "gloo" and t.is_cuda:
        STAGED_BYTES[op] = STAGED_BYTES.get(op, 0) + t.numel() * t.element_size()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach())
        return host
    return t


def _unstage(op: str, like: torch.Tensor, t: torch.Tensor):
    if t.device != like.device:
        STAGED_BYTES[op] = STAGED_BYTES.get(op, 0) + t.numel() * t.element_size()
        return t.to(like.device)
    return t


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes``; a new tensor."""
    group = mesh.group(axes)
    if group is None:
        return x.clone()
    buf = _stage("psum", mesh, x)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _unstage("psum", x, buf)


def pmax(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks along ``axes``."""
    group = mesh.group(axes)
    if group is None:
        return x.clone()
    buf = _stage("pmax", mesh, x)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return _unstage("pmax", x, buf)


def all_gather(x: torch.Tensor, axes, mesh, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` along ``axes``, concatenated along ``dim`` in
    coordinate order."""
    group = mesh.group(axes)
    if group is None:
        return x
    buf = _stage("all_gather", mesh, x.contiguous())
    parts = [torch.empty_like(buf) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(parts, buf, group=group)
    return _unstage("all_gather", x, torch.cat(parts, dim=dim))


def all_to_all(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``x`` (n, ...) with n the ranks along ``axes``: chunk i goes to the
    rank of coordinate i, and chunk i of the result came from it."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.axis_size(axes)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} != {n} ranks")
    buf = _stage("all_to_all", mesh, x.contiguous())
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return _unstage("all_to_all", x, out)


def _slice(x: torch.Tensor, axes, mesh, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axes, ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return psum(x.contiguous(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return psum(x.contiguous(), axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axes, ctx.mesh), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return _slice(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.axes, ctx.mesh, ctx.dim),
                None, None, None)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.axes, ctx.mesh, ctx.dim = axes, mesh, dim
        return all_gather(x.contiguous(), axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.axes, ctx.mesh, ctx.dim), None, None, None


class _GatherSum(torch.autograd.Function):
    """All-gather of ``x`` (cast to ``dtype`` first) along each (dim, axes)
    of ``parts`` in turn; the backward is the reduce-scatter: one f32 sum
    of the cotangent over every axis of ``parts``, then this rank's slice
    along each dim, in ``x``'s dtype (an f32 master's gradient stays
    f32)."""

    @staticmethod
    def forward(ctx, x, parts, mesh, dtype):
        ctx.parts, ctx.mesh, ctx.dtype = parts, mesh, x.dtype
        y = x.to(dtype)
        for dim, axes in parts:
            y = all_gather(y.contiguous(), axes, mesh, dim)
        return y

    @staticmethod
    def backward(ctx, g):
        axes = tuple(a for _, part in ctx.parts
                     for a in ((part,) if isinstance(part, str) else part))
        g = psum(g.float().contiguous(), axes, ctx.mesh)
        for dim, part in ctx.parts:
            g = _slice(g, part, ctx.mesh, dim)
        return g.to(ctx.dtype), None, None, None


class AllToAll(torch.autograd.Function):
    """``all_to_all`` with its gradient, the same exchange of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_to_all(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.axes, ctx.mesh), None, None


def copy_to(x, axes, mesh):
    return x if mesh.axis_size(axes) == 1 else _CopyTo.apply(x, axes, mesh)


def reduce_from(x, axes, mesh):
    return x if mesh.axis_size(axes) == 1 else _ReduceFrom.apply(x, axes, mesh)


def all_reduce(x, axes, mesh):
    return x if mesh.axis_size(axes) == 1 else _AllReduce.apply(x, axes, mesh)


def scatter_to(x, axes, mesh, dim):
    if mesh.axis_size(axes) == 1:
        return x
    return _ScatterTo.apply(x, axes, mesh, dim)


def gather_from(x, axes, mesh, dim):
    if mesh.axis_size(axes) == 1:
        return x
    return _GatherFrom.apply(x, axes, mesh, dim)


def gather_sum(x, axes, mesh, dim):
    """``x`` gathered over ``axes`` along ``dim``, whose gradient is the
    reduce-scatter of the ranks' cotangents (``_GatherSum``)."""
    return gather_dims(x, ((dim, axes),), mesh)


def gather_dims(x, parts, mesh, dtype=None):
    """``x`` cast to ``dtype`` (default its own) and gathered along every
    (dim, axes) of ``parts``; the gradient is summed over all those axes
    and sliced back (``_GatherSum``).  Parts over one rank drop out."""
    parts = tuple((d, a) for d, a in parts if mesh.axis_size(a) > 1)
    dtype = x.dtype if dtype is None else dtype
    if not parts:
        return x.to(dtype)
    return _GatherSum.apply(x, parts, mesh, dtype)


def all_to_all_grad(x, axes, mesh):
    return x if mesh.axis_size(axes) == 1 else AllToAll.apply(x, axes, mesh)
