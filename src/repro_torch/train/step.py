"""Train-step builder, ported from ``repro/train/step.py``: loss -> grads
-> (int8 compression) -> clip -> optimizer, with optional gradient
accumulation over microbatches.

The state is the reference's tree ``{"params", "opt_state", "step"}``:
f32 master parameters on the device, the optimizer state mirroring them,
and ``step`` a 0-d int32 tensor kept on the host.  ``train_step`` updates
it IN PLACE (gradients by autograd into ``.grad``, then the optimizer's
in-place update) and returns the same dict.  The reference's
``abstract_state`` and ``state_logical_axes`` serve sharding and the
dry-run only and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import init_params
from repro_torch.optim import Adafactor, AdamW, clip_by_global_norm, \
    warmup_cosine
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.tree import leaves, tree_map


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
               device="cuda") -> TrainState:
    """Seeded f32 parameters on ``device`` (drawn from ``generator``),
    zero optimizer state beside them, step 0 on the host."""
    params = init_params(lm.model_decls(cfg), generator, device)
    return TrainState(params=params, opt_state=make_optimizer(run).init(params),
                      step=torch.zeros((), dtype=torch.int32))


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
        if run.grad_compression == "int8":
            from repro_torch.train.compression import int8_compress_decompress
            int8_compress_decompress(grads)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        opt.update(grads, opt_state, params, step)
        for p in ps:
            p.grad = None
        state["step"] = step + 1
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step

