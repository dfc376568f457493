"""The port's side of ``tests/test_torch_distributed.py``: the cases'
configs and inputs, the programs each gloo rank runs on a (2, 2) mesh
(and, over the same ranks, a (1, 4) one), and the one-device runs they
are held against.  It imports no JAX (the ranks are spawned processes;
the JAX oracle is ``tests/_jax_mesh_oracle.py``, which reads the cases'
archs and rule sets from the inputs file)."""

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
from repro_torch.serving.engine import (Request, ServeEngine,
                                        make_decode_step,
                                        make_prefill_chunk_step,
                                        make_prefill_chunk_step_paged,
                                        make_prefill_step)
from repro_torch.sharding import (RULE_SETS, collectives as C, spec_axes,
                                  tree_shardings)
from repro_torch.train.compression import compressed_psum
from repro_torch.train.step import (grad_sum_axes, make_loss_fn,
                                    make_optimizer, make_train_step,
                                    state_specs)
from repro_torch.tree import leaves, leaves_with_paths, tree_map

RULES = RULE_SETS["default"]
F32 = dict(compute_dtype="float32", remat="none")
MESH = (2, 2)
DECODE = {"llama": ("llama3.2-3b", {}), "qwen2vl": ("qwen2-vl-72b", {}),
          "gemma2": ("gemma2-2b", {"local_window": 8}),
          "olmoe": ("olmoe-1b-7b", {}), "mamba2": ("mamba2-370m", {}),
          "zamba2": ("zamba2-1.2b", {})}
PROMPT, MAX_SEQ, DECODE_B = 32, 64, 2
# olmoe's decode step takes the experts-sharded branch (one token does not
# divide over model); at 8 rows its capacity, 3, binds, and counting only
# a data-parallel rank's 4 rows would give 2
DECODE_BATCH = {"olmoe": 8}
#: the train steps under the other rule sets: (arch, rule set, the
#: inputs' prefix).  The llama cases take the default case's weights and
#: batch (``train/``), so the one-device step is the same; phi3.5-moe's
#: MoE is expert parallelism over each rank's rows at a capacity factor
#: of 8, so nothing drops on either side; qwen2-vl's batch carries
#: ``vision_embeds`` and (3, B, S) positions; the Mamba-2 stack runs
#: head-parallel under ``default`` and ``fsdp`` on one set of weights
#: (reduced mamba2's 560 ``in_proj`` columns split 280 / 280, across the
#: z/x boundary), and reduced zamba2 (4 layers, two shared invocations)
#: under ``default`` with ``lora_b`` drawn nonzero (its init is zeros,
#: which would leave ``lora_a``'s gradient zero)
RULE_CASES = {
    "seq_llama": ("llama3.2-3b", "seqparallel", "train"),
    "seq_phi": ("phi3.5-moe-42b-a6.6b", "seqparallel", "rule/seq_phi"),
    "fsdp_qwen2vl": ("qwen2-vl-72b", "fsdp", "rule/fsdp_qwen2vl"),
    "fsdpseq_llama": ("llama3.2-3b", "fsdp_seqparallel", "train"),
    "mamba2": ("mamba2-370m", "default", "rule/mamba2"),
    "fsdp_mamba2": ("mamba2-370m", "fsdp", "rule/mamba2"),
    "zamba2": ("zamba2-1.2b", "default", "rule/zamba2")}
#: the gated norm's case: (B, S) rows of reduced mamba2's d_inner
NORM_ROWS = (2, 8)
#: llama's decode step under its serve rules
SEQ_DECODE = "seqparallel"
#: the serving step functions under a mesh (item 14b (d)), each arch under
#: its serve rules and llama under ``default`` too, on the ``decode/<name>``
#: weights: a 40-row prompt over MAX_SEQ 64 (slices of 32 rows, so it
#: crosses the edge), chunks of 24 and 16 rows at offsets 0 and 24 (the
#: second straddles it), two per-slot decode steps at offsets on each side
#: of it with one done lane, and for llama the paged pool.  olmoe's
#: whole-batch prefill is expert parallelism, which counts each rank's
#: tokens for its capacity (queue 3's quirk), so it is held against JAX's
#: sharded step alone
SERVE_CASES = (("llama", "default"), ("llama", "seqparallel"),
               ("gemma2", "seqparallel"), ("mamba2", "default"),
               ("zamba2", "default"), ("olmoe", "default"))
#: llama under the fsdp rule sets, held against one device
SERVE_FSDP = (("llama", "fsdp"), ("llama", "fsdp_seqparallel"))
SERVE_B, SERVE_ROWS = 4, 40
SERVE_CHUNKS = ((0, 24), (24, 16))
SERVE_INDEX = ((40, 28, MAX_SEQ, 35), (41, 29, MAX_SEQ, 36))
SERVE_BLOCK = 16
#: the eager engine on the mesh: reduced llama under its serve rules,
#: dense and paged (prefix sharing), against one device's engine
ENGINE = dict(batch_size=4, max_seq=64, prefill_chunk=16, decode_chunk=4,
              block_size=8)


def train_cfg():
    cfg = reduced(get_model_config("llama3.2-3b"), n_heads=4, n_kv_heads=2)
    run = get_run_config("llama3.2-3b", logits_chunk=16,
                         rules_name="default", warmup_steps=0, **F32)
    return cfg, run


def rule_cfg(case):
    """(cfg, run) of a ``RULE_CASES`` entry, f32."""
    arch, rules, _ = RULE_CASES[case]
    if arch == "llama3.2-3b":
        cfg, run = train_cfg()
    else:
        cfg = reduced(get_model_config(arch))
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        run = get_run_config(arch, logits_chunk=16, warmup_steps=0, **F32)
    return cfg, run.replace(rules_name=rules)


def _batch(inp, prefix):
    return {k[len(prefix) + 7:]: torch.from_numpy(np.array(a)).long()
            if k.endswith(("tokens", "labels", "positions"))
            else torch.from_numpy(np.array(a))
            for k, a in inp.items() if k.startswith(prefix + "/batch/")}


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
        if cfg.family == "hybrid":         # lora_b's init is zeros
            lb = out[f"decode/{name}/params/shared/lora_b"]
            out[f"decode/{name}/params/shared/lora_b"] = (
                rng.normal(size=lb.shape) * 0.05).astype(np.float32)
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
    for i, (case, (arch, rules, prefix)) in enumerate(RULE_CASES.items()):
        out[f"case/{case}/arch"] = np.array(arch)
        out[f"case/{case}/rules"] = np.array(rules)
        out[f"case/{case}/prefix"] = np.array(prefix)
        if prefix == "train" or f"{prefix}/batch/tokens" in out:
            continue
        cfg, _ = rule_cfg(case)
        out.update(_flat(init_params(lm.model_decls(cfg),
                                     torch.Generator().manual_seed(20 + i),
                                     "cpu"), f"{prefix}/params"))
        if cfg.family == "hybrid":
            lb = out[f"{prefix}/params/shared/lora_b"]
            out[f"{prefix}/params/shared/lora_b"] = (
                rng.normal(size=lb.shape) * 0.05).astype(np.float32)
        for k, v in train_batches(cfg)[0].items():
            out[f"{prefix}/batch/{k}"] = v.astype(np.int32)
        if cfg.family == "vlm":
            B, S = v.shape
            out[f"{prefix}/batch/vision_embeds"] = rng.normal(
                size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
            out[f"{prefix}/batch/positions"] = rng.integers(
                0, S, (3, B, S), dtype=np.int32)
    for name in dict(SERVE_CASES):
        cfg, _ = decode_cfg(name)
        out[f"serve/{name}/tokens"] = rng.integers(
            0, cfg.vocab, (SERVE_B, SERVE_ROWS), dtype=np.int32)
        for j in range(len(SERVE_INDEX)):
            out[f"serve/{name}/tok{j}"] = rng.integers(
                0, cfg.vocab, (SERVE_B, 1), dtype=np.int32)
    out["serve/table"] = rng.permutation(
        SERVE_B * MAX_SEQ // SERVE_BLOCK).reshape(SERVE_B, -1).astype(
            np.int32)
    out["serve/cases"] = np.array([f"{n}/{r}" for n, r in SERVE_CASES])
    cfg, _ = decode_cfg("llama")
    shared = rng.integers(0, cfg.vocab, 20)
    for i in range(10):
        p = rng.integers(0, cfg.vocab, int(rng.integers(5, 40)))
        out[f"engine/prompt{i}"] = (np.concatenate([shared, p[:10]])
                                    if i % 3 == 0 else p).astype(np.int32)
        out[f"engine/new{i}"] = np.int32(rng.integers(3, 12))
    # the gather pair's case: rank r's cotangent weights of the gathered
    # (8, 6) rows
    out["pair/x"] = rng.normal(size=(8, 6)).astype(np.float32)
    out["pair/w"] = rng.normal(size=(4, 8, 6)).astype(np.float32)
    din = rule_cfg("mamba2")[0].d_inner
    for k in ("y", "z", "g"):
        out[f"norm/{k}"] = rng.normal(size=NORM_ROWS + (din,)).astype(
            np.float32)
    out["norm/scale"] = (1 + 0.1 * rng.normal(size=(din,))).astype(
        np.float32)
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
    for case, (_, _, prefix) in RULE_CASES.items():
        if prefix == "train" or f"{prefix}/loss" in out:
            continue
        cfg, run = rule_cfg(case)
        ctx = Ctx(run, "cpu")
        batch = _batch(inp, prefix)
        out[f"{prefix}/grads"] = _grads(cfg, run, ctx,
                                        tree_of(inp, f"{prefix}/params"),
                                        batch)
        params = tree_of(inp, f"{prefix}/params")
        state = {"params": params,
                 "opt_state": make_optimizer(run).init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        state, m = make_train_step(cfg, run, ctx)(state, batch)
        out[f"{prefix}/loss"] = float(m["loss"])
        out[f"{prefix}/grad_norm"] = float(m["grad_norm"])
        out[f"{prefix}/new_params"] = state["params"]
    for name in dict(SERVE_CASES):
        out[f"serve/{name}"] = serve_steps(inp, name, None, None)
    out["engine"] = engine_streams(inp, None)
    y, z = (torch.from_numpy(inp[f"norm/{k}"]).requires_grad_(True)
            for k in ("y", "z"))
    (L.rmsnorm_gated(torch.from_numpy(inp["norm/scale"]), y, z)
     * torch.from_numpy(inp["norm/g"])).sum().backward()
    out["norm/grad_y"], out["norm/grad_z"] = y.grad, z.grad
    return out


def _decode(inp, name, mesh, rules=RULES):
    """Prefill on one device, then two decode steps of the fixed tokens:
    unsharded (``mesh`` None) or on this rank's shard of the cache, under
    ``rules``."""
    cfg, run = decode_cfg(name)
    params = tree_of(inp, f"decode/{name}/params")
    batch = {k[len(f"decode/{name}/batch/"):]: torch.from_numpy(np.array(a))
             for k, a in inp.items() if k.startswith(f"decode/{name}/batch/")}
    ctx0 = Ctx(run, "cpu")
    with torch.no_grad():
        cache, _ = make_prefill_step(cfg, run, ctx0, MAX_SEQ)(params, batch)
    ctx, rows = ctx0, slice(None)
    if mesh is not None:
        ctx = Ctx(run, "cpu", rules, mesh)
        specs = tree_shardings(rules, mesh, logical_axes(lm.model_decls(cfg)),
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


def serve_steps(inp, name, rules, mesh) -> dict:
    """The serving step functions on ``decode/<name>``'s weights, on one
    device (``mesh`` None) or on this rank under ``rules``: the
    whole-batch prefill (last logits and the cache), two per-slot decode
    steps, two prefill chunks into slot 1 of a fresh cache (their logits
    and the cache) and, for llama, the paged pool (chunks into slots 1
    and 0, a per-slot decode step; logits and the pool).  Caches come back
    as this rank's state."""
    cfg, run = decode_cfg(name)
    params = tree_of(inp, f"decode/{name}/params")
    tokens = torch.from_numpy(inp[f"serve/{name}/tokens"]).long()
    ctx, rows = Ctx(run, "cpu"), slice(None)
    if mesh is not None:
        ctx = Ctx(run, "cpu", RULE_SETS[rules], mesh)
        params = shard_params(params, tree_shardings(
            ctx.rules, mesh, logical_axes(lm.model_decls(cfg)), params),
            mesh)
        n = SERVE_B // mesh.shape["data"]
        rows = slice(mesh.coord("data") * n, (mesh.coord("data") + 1) * n)
    out: dict = {}
    with torch.no_grad():
        cache, lg = make_prefill_step(cfg, run, ctx, MAX_SEQ)(
            params, {"tokens": tokens[rows]})
        out["prefill"], out["cache"] = lg, _np_tree(cache)
        step = make_decode_step(cfg, run, ctx)
        for j, idx in enumerate(SERVE_INDEX):
            tok = torch.from_numpy(inp[f"serve/{name}/tok{j}"]).long()[rows]
            cache, out[f"decode{j}"] = step(
                params, cache, tok, torch.tensor(idx, dtype=torch.int32)[rows])
        fresh = lm.init_cache(ctx, cfg, SERVE_B, MAX_SEQ)
        chunk = make_prefill_chunk_step(cfg, run, ctx)
        for j, (o, n) in enumerate(SERVE_CHUNKS):
            _, out[f"chunk{j}"] = chunk(params, fresh, tokens[1:2, o:o + n],
                                        1, o)
        out["chunk_cache"] = _np_tree(fresh)
        if name == "llama":
            pc = lm.init_paged_cache(ctx, cfg, SERVE_B, MAX_SEQ, SERVE_BLOCK)
            pc["block_tables"].copy_(torch.from_numpy(inp["serve/table"])[
                rows if pc["block_tables"].shape[0] < SERVE_B
                else slice(None)])
            paged = make_prefill_chunk_step_paged(cfg, run, ctx)
            for j, (o, n) in enumerate(SERVE_CHUNKS):
                _, out[f"paged{j}"] = paged(params, pc, tokens[1:2, o:o + n],
                                            1, o)
            _, out["paged2"] = paged(params, pc, tokens[0:1], 0, 0)
            _, out["paged_decode"] = step(
                params, pc, torch.from_numpy(inp["serve/llama/tok0"]).long()[
                    rows], torch.tensor(SERVE_INDEX[0], dtype=torch.int32)[
                        rows])
            out["pool"] = _np_tree({"kv": pc["kv"]})
    return out


def _np_tree(cache):
    return {f"{key}/{k}": a.numpy().copy() for key, leaves in cache.items()
            if key != "block_tables" for k, a in leaves.items()}


def engine_streams(inp, mesh) -> dict:
    """The eager engine on reduced llama (``decode/llama``'s weights)
    under its serve rules, dense and paged with prefix sharing, on one
    device (``mesh`` None) or on this rank: each request's stream."""
    cfg, run = decode_cfg("llama")
    params = tree_of(inp, "decode/llama/params")
    ctx = Ctx(run, "cpu")
    if mesh is not None:
        ctx = Ctx(run, "cpu", RULE_SETS[SEQ_DECODE], mesh)
        params = shard_params(params, tree_shardings(
            ctx.rules, mesh, logical_axes(lm.model_decls(cfg)), params),
            mesh)
    out = {}
    for mode, kw in (("dense", {}), ("paged", dict(paged=True,
                                                   prefix_sharing=True))):
        eng = ServeEngine(cfg, run, ctx, params, eager=True, **ENGINE, **kw)
        done = eng.generate([
            Request(uid=i, prompt=inp[f"engine/prompt{i}"].tolist(),
                    max_new_tokens=int(inp[f"engine/new{i}"]),
                    prefix_len=20 if i % 3 == 0 else 0)
            for i in range(10)])
        out[mode] = {r.uid: list(r.generated) for r in done}
        if kw:
            out["pool"] = eng._cache["kv"]["k"].clone()
            out["skipped"] = eng.prefill_tokens_skipped
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _mesh():
    torch.set_num_threads(1)
    return make_mesh_for(MESH, ("data", "model"))


def _rule_step(rank, inp, case, mesh, rules=None) -> dict:
    """One train step of ``RULE_CASES[case]`` (under ``rules`` if given)
    on this rank of ``mesh`` from the full weights' shards: loss and grad
    norm, and on rank 0 the reduced gradients (each leaf summed as
    ``train_step`` sums it) and the new parameters, gathered whole."""
    _, own, prefix = RULE_CASES[case]
    rules = rules or own
    cfg, run = rule_cfg(case)
    ctx = Ctx(run, "cpu", RULE_SETS[rules], mesh)
    specs = state_specs(cfg, run, ctx)["params"]
    full = tree_of(inp, f"{prefix}/params")
    dp, d = mesh.axis_size(L.DP_AXES), mesh.index(L.DP_AXES)
    batch = {k: v[:, d * 4 // dp:(d + 1) * 4 // dp] if k == "positions"
             else v[d * 4 // dp:(d + 1) * 4 // dp]
             for k, v in _batch(inp, prefix).items()}
    params = shard_params(full, specs, mesh)
    grads = _grads(cfg, run, ctx, params, batch)
    split = mesh.present(L.token_axes(L.seq_parallel(ctx)))
    for g, spec in zip(leaves(grads), leaves(specs)):
        ax = grad_sum_axes(split, spec_axes(spec))
        if mesh.axis_size(ax) > 1:
            g.copy_(C.psum(g, ax, mesh))
    grads = gather_params(grads, specs, mesh)
    state = {"params": params, "opt_state": make_optimizer(run).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = make_train_step(cfg, run, ctx)(state, batch)
    new = gather_params(state["params"], specs, mesh)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if rank == 0:
        out.update(grads=grads, new_params=new)
    return out


def _pair_grads(rank, inp, mesh) -> dict:
    """x's rows split over ``model``, gathered, and rank r's loss
    sum(y * w_r): the gradient of the summed loss w.r.t. x is sum_r w_r,
    which ``gather_sum`` gives each rank's rows and ``gather_from`` (one
    rank's cotangent, sliced) does not."""
    x = torch.from_numpy(inp["pair/x"])
    w = torch.from_numpy(inp["pair/w"])[rank]
    rows = L.seq_rows(Ctx(None, "cpu", RULE_SETS["seqparallel"], mesh), 8)
    out = {}
    for name, fn in (("gather_sum", C.gather_sum),
                     ("gather_from", C.gather_from)):
        xl = x[rows].clone().requires_grad_(True)
        (fn(xl, "model", mesh, 0) * w).sum().backward()
        out[f"pair/{name}"] = xl.grad
    return out


def _norm_grads(inp, mesh) -> dict:
    """The gated norm over reduced mamba2's d_inner split over ``model``,
    loss sum(out * g): this rank's gradients of its y and z slices with
    the all-reduce pair (``C.all_reduce``) and with ``reduce_from`` (an
    identity backward) in its place."""
    n, m = mesh.axis_size("model"), mesh.coord("model")
    din = inp["norm/y"].shape[-1]
    cols = slice(m * din // n, (m + 1) * din // n)
    out = {}
    real = C.all_reduce
    for name, fn in (("all_reduce", real), ("reduce_from", C.reduce_from)):
        y, z = (torch.from_numpy(inp[f"norm/{k}"][..., cols]).clone()
                .requires_grad_(True) for k in ("y", "z"))
        C.all_reduce = fn
        try:
            o = L.rmsnorm_gated(torch.from_numpy(inp["norm/scale"][cols]),
                                y, z, mesh=mesh, width=din)
        finally:
            C.all_reduce = real
        (o * torch.from_numpy(inp["norm/g"][..., cols])).sum().backward()
        out[f"norm/{name}"] = {"y": y.grad, "z": z.grad, "cols": cols}
    return out


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
    for case in RULE_CASES:
        out[f"rule/{case}"] = _rule_step(rank, inp, case, mesh)
    for k, v in _decode(inp, "llama", mesh, RULE_SETS[SEQ_DECODE]).items():
        out["seqdecode/" + k.rsplit("/", 1)[1]] = v
    for name, rules in SERVE_CASES + SERVE_FSDP:
        out[f"serve/{name}/{rules}"] = serve_steps(inp, name, rules, mesh)
    out["engine"] = engine_streams(inp, mesh)
    out.update(_pair_grads(rank, inp, mesh))
    out.update(_norm_grads(inp, mesh))
    # (1, 4) over the same ranks: reduced llama's 2 kv heads cut in
    # storage (half a head a rank); the Megatron program refuses the cut,
    # the sequence-parallel one gathers the weights whole
    wide = make_mesh_for((1, 4), ("data", "model"))
    try:
        _rule_step(rank, inp, "seq_llama", wide, rules="default")
        out["wide/default"] = "ran"
    except NotImplementedError as e:
        out["wide/default"] = str(e)
    out["wide/seq_llama"] = _rule_step(rank, inp, "seq_llama", wide)
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
