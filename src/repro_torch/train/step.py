"""Train-step builder, ported from ``repro/train/step.py``: loss -> grads
-> (int8 compression) -> clip -> optimizer, with optional gradient
accumulation over microbatches.

The state is the reference's tree ``{"params", "opt_state", "step"}``:
f32 master parameters on the device, the optimizer state mirroring them,
and ``step`` a 0-d int32 tensor kept on the host.  ``train_step`` updates
it IN PLACE (gradients by autograd into ``.grad``, then the optimizer's
in-place update) and returns the same dict.

Under a mesh (``ctx.mesh``, ``ctx.rules``) every leaf is this rank's
shard, cut by ``state_logical_axes`` under the rules (``state_specs``);
``init_state`` draws each full leaf from the seed and keeps its slice, so
the shards are the one-device weights'.  The step is the reference's
pjit step as one rank runs it: the layers' collectives make the forward
and backward, and each rank's loss is its share of the global loss
(``train/loss.py``).  A leaf's gradient is summed over the axes its
tokens are split over (the data-parallel axes, and ``model`` under
sequence parallelism) but those its spec shards it over: a leaf
gathered at use over an axis (``fsdp``'s embed dim over data, a weight
over ``model`` under sequence parallelism) was already reduce-scattered
over it by the gather's backward, and a ``model`` shard the program
consumes as it lies (Megatron's, the experts') holds its whole gradient.
``grad_compression="int8"`` then acts on the reduced
gradients, with each leaf's scale from its global max, as the
reference's acts on pjit's global gradients; the global norm of the clip
sums each leaf's squared norm over the axes the leaf is sharded on and
counts a replicated leaf once.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.models.layers import Ctx, seq_parallel, token_axes
from repro_torch.models.params import (abstract_params, init_params,
                                       logical_axes)
from repro_torch.optim import Adafactor, AdamW, clip_by_global_norm, \
    warmup_cosine
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import local_slice, spec_axes, tree_shardings
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.tree import leaves, leaves_with_paths, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step}

    @classmethod
    def from_tree(cls, t):
        return cls(params=t["params"], opt_state=t["opt_state"],
                   step=t["step"])


def make_optimizer(run: RunConfig):
    lr = warmup_cosine(run.learning_rate, run.warmup_steps, run.total_steps)
    if run.optimizer == "adafactor":
        return Adafactor(lr=lr, weight_decay=run.weight_decay)
    return AdamW(lr=lr, b1=run.beta1, b2=run.beta2,
                 weight_decay=run.weight_decay)


def init_state(cfg: ModelConfig, run: RunConfig, generator: torch.Generator,
               device="cuda", ctx: Ctx | None = None) -> TrainState:
    """Seeded f32 parameters on ``device`` (drawn from ``generator``),
    zero optimizer state beside them, step 0 on the host.  With a mesh
    (``ctx.mesh``), each leaf is drawn whole, as on one device, and only
    this rank's shard is kept."""
    prepare = None
    if ctx is not None and ctx.mesh is not None:
        specs = dict(leaves_with_paths(state_specs(cfg, run, ctx)["params"]))
        prepare = lambda path, t: local_slice(ctx.mesh, specs[path],
                                              t).clone()
    params = init_params(lm.model_decls(cfg), generator, device,
                         prepare=prepare)
    return TrainState(params=params, opt_state=make_optimizer(run).init(params),
                      step=torch.zeros((), dtype=torch.int32))


def abstract_state(cfg: ModelConfig, run: RunConfig) -> dict:
    """The state tree as meta-device tensors (shapes and dtypes, no
    storage), the reference's ``ShapeDtypeStruct`` tree."""
    params = abstract_params(lm.model_decls(cfg))
    return {"params": params, "opt_state": make_optimizer(run).init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_logical_axes(cfg: ModelConfig, run: RunConfig | None = None) -> dict:
    """Logical axes of every state leaf (``repro/train/step.py:70-85``):
    the optimizer's moments take their parameter's; Adafactor's factored
    rows and columns drop the last or the second-to-last axis."""
    axes = logical_axes(lm.model_decls(cfg))
    if run is not None and run.optimizer == "adafactor":
        def f_axes(a):
            if len(a) >= 2:
                return {"vr": tuple(a[:-1]), "vc": tuple(a[:-2]) + (a[-1],)}
            return {"v": tuple(a)}
        opt_axes = {"f": tree_map(f_axes, axes)}
    else:
        opt_axes = {"m": axes, "v": axes}
    return {"params": axes, "opt_state": opt_axes, "step": ()}


def state_specs(cfg: ModelConfig, run: RunConfig, ctx: Ctx) -> dict:
    """Each state leaf's ``PartitionSpec`` under ``ctx.rules`` on
    ``ctx.mesh`` (``sharding.tree_shardings`` of the logical axes and the
    global shapes)."""
    return tree_shardings(ctx.rules, ctx.mesh, state_logical_axes(cfg, run),
                          abstract_state(cfg, run))


def make_loss_fn(cfg: ModelConfig, run: RunConfig, ctx: Ctx):
    """Cross-entropy, plus ``router_aux_weight`` times the layers' summed
    load-balancing loss for an MoE model (reported as ``aux``)."""
    def loss_fn(params, batch):
        h, aux, _ = lm.forward(ctx, cfg, params, batch)
        loss, metrics = chunked_cross_entropy(ctx, cfg, params, h,
                                              batch["labels"])
        if cfg.n_experts:
            loss = loss + cfg.router_aux_weight * aux
            metrics = dict(metrics, aux=aux)
        return loss, metrics
    return loss_fn


def make_train_step(cfg: ModelConfig, run: RunConfig, ctx: Ctx):
    """Returns train_step(state_tree, batch) -> (state_tree, metrics);
    ``batch`` holds (B, S) int tensors ``tokens`` (``frames`` (B, S,
    frontend_dim) for the audio encoder; a vlm batch may add
    ``vision_embeds`` and ``positions``) and ``labels`` on the
    parameters' device.  Metrics are 0-d tensors: ``loss``, ``ce``,
    ``grad_norm`` (and ``tokens`` without accumulation)."""
    opt = make_optimizer(run)
    loss_fn = make_loss_fn(cfg, run, ctx)
    mesh = ctx.mesh
    axes = sums = None
    if mesh is not None:
        axes = [spec_axes(s) for s in
                leaves(state_specs(cfg, run, ctx)["params"])]
        split = mesh.present(token_axes(seq_parallel(ctx)))
        sums = [grad_sum_axes(split, ax) for ax in axes]

    def compute_grads(params, batch):
        if run.grad_accum <= 1:
            loss, metrics = loss_fn(params, batch)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}
        # microbatch accumulation: the reference's scan over
        # batch.reshape(grad_accum, b // grad_accum, ...); autograd sums
        # each microbatch's gradients into .grad
        n = run.grad_accum
        mb = batch["labels"].shape[0] // n
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
        for i in range(n):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _ = loss_fn(params, micro)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / n
        with torch.no_grad():
            for p in leaves(params):
                p.grad.mul_(inv)
        loss = loss_sum * inv
        return loss, {"ce": loss}

    def train_step(state, batch):
        params, opt_state, step = (state["params"], state["opt_state"],
                                   state["step"])
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = compute_grads(params, batch)
        grads = tree_map(lambda p: p.grad, params)
        if mesh is not None and mesh.axis_size(split) > 1:
            with torch.no_grad():
                for g, ax in zip(leaves(grads), sums):
                    if mesh.axis_size(ax) > 1:
                        g.copy_(C.psum(g, ax, mesh))
            loss = C.psum(loss, split, mesh)
            if "aux" in metrics:
                metrics["aux"] = C.psum(metrics["aux"], split, mesh)
        if run.grad_compression == "int8":
            from repro_torch.train.compression import int8_compress_decompress
            int8_compress_decompress(grads, absmax=None if mesh is None else
                                     _sharded_absmax(mesh, leaves(grads),
                                                     axes))
        grads, gnorm = clip_by_global_norm(
            grads, run.grad_clip, sq_norm=None if mesh is None else
            lambda gs: _sharded_sq_norm(mesh, gs, axes))
        opt.update(grads, opt_state, params, step)
        for p in ps:
            p.grad = None
        state["step"] = step + 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def grad_sum_axes(split, spec_ax) -> tuple[str, ...]:
    """The axes a leaf's gradient is summed over after the backward: those
    of the token axes ``split`` its spec does not shard it over
    (``spec_ax``)."""
    return tuple(a for a in split if a not in spec_ax)


def _sharded_sq_norm(mesh, gs, axes):
    """The squared global norm of sharded gradients: each leaf's squared
    norm summed over the mesh axes it is sharded on (one all-reduce per
    distinct set of axes), a replicated leaf counted once."""
    by_axes: dict = {}
    for g, ax in zip(gs, axes):
        sq = torch.sum(torch.square(g.float()))
        by_axes[ax] = by_axes.get(ax, 0) + sq
    total = 0
    for ax, sq in sorted(by_axes.items()):
        total = total + (C.psum(sq, ax, mesh) if ax else sq)
    return total


def _sharded_absmax(mesh, gs, axes):
    """Each gradient leaf's max |entry| over the whole (global) leaf."""
    of = {id(g): ax for g, ax in zip(gs, axes)}

    def absmax(g):
        m = torch.max(torch.abs(g.float()))
        return C.pmax(m, of[id(g)], mesh) if of[id(g)] else m
    return absmax

