"""The port's side of ``tests/test_torch_distributed.py``: the cases'
configs and inputs, the programs each gloo rank runs on a (2, 2) mesh,
and the one-device runs they are held against.  It imports no JAX (the
ranks are spawned processes; the JAX oracle is
``tests/_jax_mesh_oracle.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_model_config, get_run_config
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import (gather_params, init_params,
                                       logical_axes, shard_params)
from repro_torch.serving.engine import make_decode_step, make_prefill_step
from repro_torch.sharding import RULE_SETS, collectives as C, tree_shardings
from repro_torch.train.compression import compressed_psum
from repro_torch.train.step import (make_loss_fn, make_optimizer,
                                    make_train_step, state_specs)
from repro_torch.tree import leaves, leaves_with_paths, tree_map

RULES = RULE_SETS["default"]
F32 = dict(compute_dtype="float32", remat="none")
MESH = (2, 2)
DECODE = {"llama": ("llama3.2-3b", {}), "qwen2vl": ("qwen2-vl-72b", {}),
          "gemma2": ("gemma2-2b", {"local_window": 8}),
          "olmoe": ("olmoe-1b-7b", {})}
PROMPT, MAX_SEQ, DECODE_B = 32, 64, 2
# olmoe's decode step takes the experts-sharded branch (one token does not
# divide over model); at 8 rows its capacity, 3, binds, and counting only
# a data-parallel rank's 4 rows would give 2
DECODE_BATCH = {"olmoe": 8}


def train_cfg():
    cfg = reduced(get_model_config("llama3.2-3b"), n_heads=4, n_kv_heads=2)
    run = get_run_config("llama3.2-3b", logits_chunk=16,
                         rules_name="default", warmup_steps=0, **F32)
    return cfg, run


def decode_cfg(name):
    arch, over = DECODE[name]
    return (reduced(get_model_config(arch), **over),
            get_run_config(arch, logits_chunk=16, **F32))


def moe_cfg(a2a="bf16"):
    cfg = dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")),
                              capacity_factor=8.0)
    return cfg, get_run_config("olmoe-1b-7b", moe_a2a_dtype=a2a, **F32)


def _flat(tree, prefix):
    return {f"{prefix}/{'/'.join(p)}": t.numpy()
            for p, t in leaves_with_paths(tree)}


def tree_of(flat, prefix):
    out: dict = {}
    for key, a in flat.items():
        if key.startswith(prefix + "/"):
            node = out
            *parents, last = key[len(prefix) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = torch.from_numpy(np.array(a))
    return out


def train_batches(cfg, n=3, B=4, S=32):
    rng = np.random.default_rng(7)
    return [{k: rng.integers(0, cfg.vocab, (B, S), dtype=np.int64)
             for k in ("tokens", "labels")} for _ in range(n)]


def make_inputs(path) -> dict:
    """Every case's weights and inputs, drawn here from seeds, saved to
    ``path`` for the JAX oracle and returned."""
    out: dict = {}
    cfg, _ = train_cfg()
    out.update(_flat(init_params(lm.model_decls(cfg),
                                 torch.Generator().manual_seed(0), "cpu"),
                     "train/params"))
    for k, v in train_batches(cfg)[0].items():
        out[f"train/batch/{k}"] = v.astype(np.int32)
    rng = np.random.default_rng(11)
    for i, name in enumerate(DECODE):
        cfg, _ = decode_cfg(name)
        out.update(_flat(init_params(lm.model_decls(cfg),
                                     torch.Generator().manual_seed(10 + i),
                                     "cpu"), f"decode/{name}/params"))
        B = DECODE_BATCH.get(name, DECODE_B)
        out[f"decode/{name}/batch/tokens"] = rng.integers(
            0, cfg.vocab, (B, PROMPT), dtype=np.int32)
        if name == "qwen2vl":
            out[f"decode/{name}/batch/vision_embeds"] = rng.normal(
                size=(B, cfg.vision_tokens, cfg.d_model)).astype(
                    np.float32)
            out[f"decode/{name}/batch/positions"] = np.broadcast_to(
                np.arange(PROMPT, dtype=np.int32)[None, None],
                (3, B, PROMPT)).copy()
        out[f"decode/{name}/max_seq"] = np.int32(MAX_SEQ)
        for j in range(2):
            out[f"decode/{name}/tok{j}"] = rng.integers(
                0, cfg.vocab, (B, 1), dtype=np.int32)
    cfg, _ = moe_cfg()
    out.update(_flat(init_params(L.moe_decls(cfg),
                                 torch.Generator().manual_seed(1), "cpu"),
                     "moe/params"))
    out["moe/x"] = (rng.normal(size=(4, 16, cfg.d_model)) * 0.3).astype(
        np.float32)
    out["psum/g"] = rng.normal(size=(4, 3, 40)).astype(np.float32)
    np.savez(path, **out)
    return out


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

def _grads(cfg, run, ctx, params, batch):
    ps = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss, _ = make_loss_fn(cfg, run, ctx)(ps, batch)
    loss.backward()
    return tree_map(lambda t: t.grad, ps)


def one_device(inp) -> dict:
    """The port's one-device runs of every case."""
    out: dict = {}
    cfg, run = train_cfg()
    ctx = Ctx(run, "cpu")
    params = tree_of(inp, "train/params")
    batch = {k: torch.from_numpy(inp[f"train/batch/{k}"]).long()
             for k in ("tokens", "labels")}
    out["train/grads"] = _grads(cfg, run, ctx, params, batch)
    state = {"params": params, "opt_state": make_optimizer(run).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = make_train_step(cfg, run, ctx)(state, batch)
    out["train/loss"], out["train/grad_norm"] = float(m["loss"]), float(
        m["grad_norm"])
    out["train/new_params"] = state["params"]
    run8 = run.replace(grad_compression="int8")
    params = tree_of(inp, "train/params")
    state = {"params": params, "opt_state": make_optimizer(run8).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = make_train_step(cfg, run8, Ctx(run8, "cpu"))(state, batch)
    out["int8/loss"], out["int8/new_params"] = float(m["loss"]), state[
        "params"]
    for name in DECODE:
        out.update(_decode(inp, name, None))
    cfg, run = moe_cfg()
    params = tree_of(inp, "moe/params")
    x = torch.from_numpy(inp["moe/x"])
    ps = tree_map(lambda t: t.clone().requires_grad_(True), params)
    y, _ = L.apply_moe(Ctx(run, "cpu"), cfg, ps, x)
    y.sum().backward()
    out["moe/y0"] = y.detach()
    out["moe/grads"] = tree_map(lambda t: t.grad, ps)
    return out


def _decode(inp, name, mesh):
    """Prefill on one device, then two decode steps of the fixed tokens:
    unsharded (``mesh`` None) or on this rank's shard of the cache."""
    cfg, run = decode_cfg(name)
    params = tree_of(inp, f"decode/{name}/params")
    batch = {k[len(f"decode/{name}/batch/"):]: torch.from_numpy(np.array(a))
             for k, a in inp.items() if k.startswith(f"decode/{name}/batch/")}
    ctx0 = Ctx(run, "cpu")
    with torch.no_grad():
        cache, _ = make_prefill_step(cfg, run, ctx0, MAX_SEQ)(params, batch)
    ctx, rows = ctx0, slice(None)
    if mesh is not None:
        ctx = Ctx(run, "cpu", RULES, mesh)
        specs = tree_shardings(RULES, mesh, logical_axes(lm.model_decls(cfg)),
                               params)
        params = shard_params(params, specs, mesh)
        cache = lm.shard_cache(ctx, cfg, cache)
        n = batch["tokens"].shape[0] // mesh.shape["data"]
        rows = slice(mesh.coord("data") * n, (mesh.coord("data") + 1) * n)
    step = make_decode_step(cfg, run, ctx)
    out = {}
    with torch.no_grad():
        for i in range(2):
            tok = torch.from_numpy(inp[f"decode/{name}/tok{i}"])[rows]
            cache, logits = step(params, cache, tok, PROMPT + i)
            out[f"decode/{name}/logits_{i}"] = logits
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _mesh():
    torch.set_num_threads(1)
    return make_mesh_for(MESH, ("data", "model"))


def rank_cases(rank, world, inp) -> dict:
    """Every case on this rank of the (2, 2) mesh; rank 0 also returns the
    gathered gradients and parameters."""
    mesh = _mesh()
    d = mesh.coord("data")
    out: dict = {"coords": dict(mesh.coords)}
    cfg, run = train_cfg()
    ctx = Ctx(run, "cpu", RULES, mesh)
    specs = state_specs(cfg, run, ctx)
    full = tree_of(inp, "train/params")
    params = shard_params(full, specs["params"], mesh)
    back = gather_params(params, specs["params"], mesh)
    out["roundtrip_equal"] = all(
        torch.equal(a, b) for a, b in zip(leaves(back), leaves(full)))
    batch = {k: torch.from_numpy(inp[f"train/batch/{k}"]).long()[
        2 * d:2 * d + 2] for k in ("tokens", "labels")}
    grads = _grads(cfg, run, ctx, params, batch)
    for g in leaves(grads):
        g.copy_(C.psum(g, ("data",), mesh))
    full_grads = gather_params(grads, specs["params"], mesh)
    state = {"params": params, "opt_state": make_optimizer(run).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = make_train_step(cfg, run, ctx)(state, batch)
    out["train/loss"], out["train/grad_norm"] = float(m["loss"]), float(
        m["grad_norm"])
    new_params = gather_params(state["params"], specs["params"], mesh)
    if rank == 0:
        out["train/grads"], out["train/new_params"] = full_grads, new_params
    # the same step with int8 gradient compression (each leaf's scale from
    # its global max, after the data-parallel sum)
    run8 = run.replace(grad_compression="int8")
    p8 = shard_params(full, specs["params"], mesh)
    state = {"params": p8, "opt_state": make_optimizer(run8).init(p8),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = make_train_step(cfg, run8, Ctx(run8, "cpu", RULES, mesh))(
        state, batch)
    out["int8/loss"] = float(m["loss"])
    new8 = gather_params(state["params"], specs["params"], mesh)
    if rank == 0:
        out["int8/new_params"] = new8
    for name in DECODE:
        out.update(_decode(inp, name, mesh))
    # MoE: expert parallelism, the bf16 (plain) and int8 wires
    x = torch.from_numpy(inp["moe/x"])[2 * d:2 * d + 2]
    for a2a in ("bf16", "int8"):
        cfg, run = moe_cfg(a2a)
        ctx = Ctx(run, "cpu", RULES, mesh)
        decls = L.moe_decls(cfg)
        specs = tree_shardings(RULES, mesh, logical_axes(decls),
                               tree_of(inp, "moe/params"))
        ps = shard_params(tree_of(inp, "moe/params"), specs, mesh)
        ps = tree_map(lambda t: t.requires_grad_(True), ps)
        y, _ = L.apply_moe(ctx, cfg, ps, x)
        y.sum().backward()
        out[f"moe/y_{a2a}"] = C.all_gather(y.detach(), "data", mesh, 0)
        g = tree_map(lambda t: t.grad, ps)
        for t in leaves(g):
            t.copy_(C.psum(t, ("data",), mesh))
        g = gather_params(g, specs, mesh)
        if rank == 0:
            out[f"moe/grads_{a2a}"] = g
    g = torch.from_numpy(inp["psum/g"])[rank]
    for name, axes in (("data_model", ("data", "model")), ("data", ("data",))):
        out[f"psum/{name}"] = compressed_psum({"g": g}, axes, mesh)["g"]
    return out


def rank_elastic(rank, world, shape, ckpt_dir, phase) -> dict:
    """Phase "train": two steps on ``shape``, a checkpoint, and the third
    step straight through.  Phase "restart": the state restored from the
    checkpoint as this (smaller) mesh's slices, and the third step."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.train.step import init_state
    torch.set_num_threads(1)
    mesh = make_mesh_for(shape, ("data", "model"))
    cfg, run = train_cfg()
    ctx = Ctx(run, "cpu", RULES, mesh)
    specs = state_specs(cfg, run, ctx)
    state = init_state(cfg, run, torch.Generator().manual_seed(0), "cpu",
                       ctx).tree()
    dp, d = mesh.shape["data"], mesh.coord("data")
    batches = train_batches(cfg)

    def local(i):
        n = 4 // dp
        return {k: torch.from_numpy(v[d * n:(d + 1) * n])
                for k, v in batches[i].items()}

    step = make_train_step(cfg, run, ctx)
    if phase == "train":
        for i in range(2):
            state, _ = step(state, local(i))
        checkpoint.save(state, 2, ckpt_dir, shardings=specs, mesh=mesh)
        _, m = step(state, local(2))
        return {"loss": float(m["loss"])}
    restored, start = checkpoint.restore(ckpt_dir, state, shardings=specs,
                                         mesh=mesh)
    with torch.no_grad():
        for dst, src in zip(leaves(state), leaves(restored)):
            dst.copy_(src)
    _, m = step(state, local(start))
    return {"loss": float(m["loss"]), "start": start}
