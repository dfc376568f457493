"""The JAX package's sharded paths on a (2, 2) mesh of forced host
devices, for ``tests/test_torch_distributed.py``:

    python tests/_jax_mesh_oracle.py INPUTS.npz OUTPUTS.npz

Run in a subprocess of its own, since the device count must be set before
JAX starts.  Besides the ``default`` rule set's paths it runs the train
step under each rule set of the inputs' ``case/<name>/rules`` (its arch
in ``case/<name>/arch``, its weights and batch under ``case/<name>/
prefix``: among them reduced mamba2 under ``default`` and ``fsdp`` and
reduced zamba2 under ``default``) and llama's decode step under
``seqparallel``; the Mamba-2 families' decode caches are placed by
``cache_logical_axes``.  For the serving step functions under a mesh it
runs the reference's own ``make_prefill_step``, ``make_prefill_chunk_step``,
``make_prefill_chunk_step_paged`` (llama under its serve rules) and
``make_decode_step`` with a (B,) index, each jitted on ``Ctx(run, rules,
mesh)`` under the case's rules, every cache placed by
``cache_logical_axes`` and the paged pool replicated (``serve/cases``).
The mesh is a ``jax.sharding.Mesh`` built here, whose axes
are Auto: ``repro.launch.mesh.make_mesh_for`` calls ``jax.make_mesh``,
whose Explicit axes ``with_sharding_constraint`` rejects under jax 0.9.
Nothing of ``repro`` is changed.  Inputs (weights, batches, gradients)
come from the test, so the port computes on the same numbers; outputs
are flat ``/``-joined keys.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_model_config, get_run_config  # noqa: E402
from repro.models import layers as L  # noqa: E402
from repro.models.layers import Ctx  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models.lm import cache_logical_axes  # noqa: E402
from repro.models.params import logical_axes  # noqa: E402
from repro.serving.engine import (make_decode_step,  # noqa: E402
                                  make_prefill_chunk_step,
                                  make_prefill_chunk_step_paged,
                                  make_prefill_step)
from repro.sharding import RULE_SETS, tree_shardings  # noqa: E402
from repro.train.compression import compressed_psum  # noqa: E402
from repro.train.step import (abstract_state, make_loss_fn,  # noqa: E402
                              make_optimizer, make_train_step,
                              state_logical_axes)

RULES = RULE_SETS["default"]
F32 = dict(compute_dtype="float32", remat="none")
LLAMA_HEADS = dict(n_heads=4, n_kv_heads=2)


def tree_of(flat, prefix):
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, last = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(a)
    return out


def flat_of(tree, prefix, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)


def train(inp, mesh, out, key="train", arch="llama3.2-3b", rules="default",
          prefix="train"):
    """The pjit train step of ``arch`` (reduced, f32) under ``rules`` on
    the weights and batch under ``prefix``: outputs under ``key``."""
    if arch == "llama3.2-3b":
        cfg = reduced(get_model_config(arch), **LLAMA_HEADS)
    else:
        cfg = reduced(get_model_config(arch))
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    run = get_run_config(arch, logits_chunk=16, rules_name=rules,
                         warmup_steps=0, **F32)
    lr = RULE_SETS[rules]
    params = tree_of(inp, f"{prefix}/params")
    batch = {k[len(prefix) + 7:]: jnp.asarray(a) for k, a in inp.items()
             if k.startswith(f"{prefix}/batch/")}
    state = {"params": params, "opt_state": make_optimizer(run).init(params),
             "step": jnp.zeros((), jnp.int32)}
    sh = tree_shardings(lr, mesh, state_logical_axes(cfg),
                        abstract_state(cfg, run))
    state = jax.device_put(state, sh)
    ctx = Ctx(run, lr, mesh)
    grads, _ = jax.jit(jax.grad(make_loss_fn(cfg, run, ctx), has_aux=True))(
        state["params"], batch)
    new, m = jax.jit(make_train_step(cfg, run, ctx))(state, batch)
    out[f"{key}/loss"] = np.float32(m["loss"])
    out[f"{key}/grad_norm"] = np.float32(m["grad_norm"])
    flat_of(grads, f"{key}/grads", out)
    flat_of(new["params"], f"{key}/new_params", out)


DECODE = {
    "llama": ("llama3.2-3b", {}),
    "qwen2vl": ("qwen2-vl-72b", {}),
    "gemma2": ("gemma2-2b", {"local_window": 8}),
    "olmoe": ("olmoe-1b-7b", {}),
    "mamba2": ("mamba2-370m", {}),
    "zamba2": ("zamba2-1.2b", {}),
}


def decode(inp, mesh, out, name, rules=RULES, key=None):
    """Prefill, then two decode steps unsharded and on the mesh under
    ``rules``; outputs under ``key`` (default ``decode/<name>``)."""
    key = key or f"decode/{name}"
    arch, over = DECODE[name]
    cfg = reduced(get_model_config(arch), **over)
    run = get_run_config(arch, logits_chunk=16, **F32)
    params = tree_of(inp, f"decode/{name}/params")
    batch = {k[len(f"decode/{name}/batch/"):]: jnp.asarray(a)
             for k, a in inp.items()
             if k.startswith(f"decode/{name}/batch/")}
    max_seq = int(inp[f"decode/{name}/max_seq"])
    ctx0, ctx_m = Ctx(run, rules, None), Ctx(run, rules, mesh)
    cache0, lg0 = jax.jit(make_prefill_step(cfg, run, ctx0, max_seq))(
        params, batch)
    S = batch["tokens"].shape[1]
    dec0 = jax.jit(make_decode_step(cfg, run, ctx0))
    dec1 = jax.jit(make_decode_step(cfg, run, ctx_m))
    if cfg.family in ("ssm", "hybrid"):
        # the Mamba state by its own axes: heads and conv channels over
        # model (the shared block's KV rows as every KV cache)
        cache1 = jax.device_put(cache0, tree_shardings(
            rules, mesh, cache_logical_axes(cfg), cache0))
    else:
        sh = NamedSharding(mesh, P(None, "data", "model", None, None))
        cache1 = jax.tree.map(lambda a: jax.device_put(a, sh), cache0)
    out[f"{key}/prefill_logits"] = np.asarray(lg0[:, 0])
    for i in range(2):
        idx = jnp.asarray(S + i, jnp.int32)
        tok = jnp.asarray(inp[f"decode/{name}/tok{i}"])
        cache0, o0 = dec0(params, cache0, tok, idx)
        cache1, o1 = dec1(params, cache1, tok, idx)
        out[f"{key}/logits0_{i}"] = np.asarray(o0)
        out[f"{key}/logits1_{i}"] = np.asarray(o1)


MAX_SEQ, SERVE_CHUNKS, SERVE_BLOCK = 64, ((0, 24), (24, 16)), 16
SERVE_INDEX = ((40, 28, MAX_SEQ, 35), (41, 29, MAX_SEQ, 36))


def _placed(cache, cfg, rules, mesh):
    return jax.device_put(cache, tree_shardings(
        rules, mesh, cache_logical_axes(cfg), cache))


def serve(inp, mesh, out, name, rules_name):
    """The serving step functions of ``decode/<name>`` under
    ``rules_name`` on the mesh (``_dist_cases.serve_steps``' sequence):
    outputs under ``serve/<name>/<rules_name>``."""
    key = f"serve/{name}/{rules_name}"
    arch, over = DECODE[name]
    cfg = reduced(get_model_config(arch), **over)
    run = get_run_config(arch, logits_chunk=16, **F32)
    rules = RULE_SETS[rules_name]
    ctx = Ctx(run, rules, mesh)
    params = tree_of(inp, f"decode/{name}/params")
    tokens = jnp.asarray(inp[f"serve/{name}/tokens"])
    B = tokens.shape[0]
    cache, lg = jax.jit(make_prefill_step(cfg, run, ctx, MAX_SEQ))(
        params, {"tokens": tokens})
    out[f"{key}/prefill"] = np.asarray(lg)
    flat_of(cache, f"{key}/cache", out)
    dec = jax.jit(make_decode_step(cfg, run, ctx))
    for j, idx in enumerate(SERVE_INDEX):
        cache, lg = dec(params, cache, jnp.asarray(inp[f"serve/{name}/tok{j}"]),
                        jnp.asarray(idx, jnp.int32))
        out[f"{key}/decode{j}"] = np.asarray(lg)
    fresh = _placed(lm.init_cache(ctx, cfg, B, MAX_SEQ), cfg, rules, mesh)
    chunk = jax.jit(make_prefill_chunk_step(cfg, run, ctx))
    for j, (o, n) in enumerate(SERVE_CHUNKS):
        fresh, lg = chunk(params, fresh, tokens[1:2, o:o + n],
                          jnp.asarray(1, jnp.int32), jnp.asarray(o, jnp.int32))
        out[f"{key}/chunk{j}"] = np.asarray(lg)
    flat_of(fresh, f"{key}/chunk_cache", out)
    if (name, rules_name) != ("llama", "seqparallel"):
        return
    pc = lm.init_paged_cache(ctx, cfg, B, MAX_SEQ, SERVE_BLOCK)
    pc["block_tables"] = jnp.asarray(inp["serve/table"])
    pc = jax.device_put(pc, NamedSharding(mesh, P()))
    paged = jax.jit(make_prefill_chunk_step_paged(cfg, run, ctx))
    for j, (slot, o, n) in enumerate(((1, 0, 24), (1, 24, 16), (0, 0, 40))):
        pc, lg = paged(params, pc, tokens[slot:slot + 1, o:o + n],
                       jnp.asarray(slot, jnp.int32), jnp.asarray(o, jnp.int32))
        out[f"{key}/paged{j}"] = np.asarray(lg)
    pc, lg = dec(params, pc, jnp.asarray(inp["serve/llama/tok0"]),
                 jnp.asarray(SERVE_INDEX[0], jnp.int32))
    out[f"{key}/paged_decode"] = np.asarray(lg)
    flat_of({"kv": pc["kv"]}, f"{key}/pool", out)


def moe(inp, mesh, out):
    cfg = dataclasses.replace(reduced(get_model_config("olmoe-1b-7b")),
                              capacity_factor=8.0)
    decls = L.moe_decls(cfg)
    params = tree_of(inp, "moe/params")
    x = jnp.asarray(inp["moe/x"])
    p_sh = tree_shardings(RULES, mesh, logical_axes(decls), params)
    params_s = jax.device_put(params, p_sh)
    x_s = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
    run = get_run_config("olmoe-1b-7b", **F32)
    run_q = get_run_config("olmoe-1b-7b", moe_a2a_dtype="int8", **F32)
    y0, _ = L.apply_moe(Ctx(run, RULES, None), cfg, params, x)
    y1, _ = jax.jit(lambda p, xx: L.apply_moe(Ctx(run, RULES, mesh), cfg, p,
                                              xx))(params_s, x_s)
    yq, _ = jax.jit(lambda p, xx: L.apply_moe(Ctx(run_q, RULES, mesh), cfg,
                                              p, xx))(params_s, x_s)
    out["moe/y0"] = np.asarray(y0)
    out["moe/y1"] = np.asarray(y1)
    out["moe/yq"] = np.asarray(yq)
    out["moe/q_rel"] = np.float32(jnp.linalg.norm(yq - y1)
                                  / jnp.linalg.norm(y1))


def psum_int8(inp, mesh, out):
    g = jnp.asarray(inp["psum/g"])            # (4, ...): rank r's gradient
    for name, axes in (("data_model", ("data", "model")), ("data", ("data",))):
        spec = P(("data", "model"))
        f = jax.shard_map(lambda t: compressed_psum({"g": t[0]}, axes)["g"][None],
                          mesh=mesh, in_specs=spec, out_specs=spec)
        out[f"psum/{name}"] = np.asarray(jax.jit(f)(g))


def main():
    inp = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out: dict = {}
    train(inp, mesh, out)
    moe(inp, mesh, out)
    psum_int8(inp, mesh, out)
    for k in inp:
        if k.startswith("case/") and k.endswith("/arch"):
            case = k[len("case/"):-len("/arch")]
            train(inp, mesh, out, f"rule/{case}", str(inp[k]),
                  str(inp[f"case/{case}/rules"]),
                  str(inp[f"case/{case}/prefix"]))
    decode(inp, mesh, out, "llama", RULE_SETS["seqparallel"], "seqdecode")
    # the decode and serving cases in threads, whose programs XLA compiles
    # side by side (the results are the same as one after another)
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(decode, inp, mesh, out, name) for name in DECODE]
        jobs += [pool.submit(serve, inp, mesh, out, *str(case).split("/"))
                 for case in inp["serve/cases"]]
        for job in jobs:
            job.result()
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
