"""The port's sharding rules against the JAX package's, in one process:
``resolve_spec`` entry for entry on every rule set, every architecture's
parameter, optimizer-state and cache leaves at their real dimensions, on
shape-only meshes of (2, 4), (16, 16) and (2, 16, 16) (the reference's
``resolve_spec`` reads only ``mesh.shape``, so a stub serves it);
``plan_mesh_shape`` over a range of device counts; every rank's shards
reassembling the full leaves bit for bit; and a checkpoint saved full
restoring into another mesh's slices.  The gloo ranks' tests are in
``tests/test_torch_distributed.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.supervisor import plan_mesh_shape as j_plan  # noqa: E402
from repro.sharding import RULE_SETS as J_RULES  # noqa: E402
from repro.sharding import resolve_spec as j_resolve  # noqa: E402
from repro.train.step import state_logical_axes as j_state_axes  # noqa: E402

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.launch.mesh import Mesh, make_mesh_for  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import (init_params, logical_axes,  # noqa: E402
                                       shard_params)
from repro_torch.runtime.supervisor import plan_mesh_shape  # noqa: E402
from repro_torch.sharding import (RULE_SETS, local_slice,  # noqa: E402
                                  resolve_spec, shard_shape, tree_shardings)
from repro_torch.train.step import (abstract_state, init_state,  # noqa: E402
                                    state_logical_axes)
from repro_torch.tree import leaves_with_paths  # noqa: E402


class _Stub:
    """A mesh with only ``.shape``, as the reference's tests use."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"2x4": {"data": 2, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _pairs(axes_tree, shapes):
    """(path, logical axes, dims) of every leaf."""
    dims = dict(leaves_with_paths(shapes))
    return [(p, a, tuple(dims[p])) for p, a in leaves_with_paths(axes_tree)]


def _decl_shapes(decls):
    return {k: _decl_shapes(v) if isinstance(v, dict) else v.shape
            for k, v in decls.items()}


def _cache_dims(cfg, B=128, S=32768):
    """Every cache leaf's dims at the decode cell's batch and length."""
    n_super = lm.zamba_structure(cfg)[0]
    kv = lambda n: (n, B, S, cfg.n_kv_heads, cfg.head_dim)
    out = {}
    for key, axes in lm.cache_logical_axes(cfg).items():
        if key == "mamba":
            out[key] = {"ssm": (cfg.n_layers, B, cfg.ssm_heads,
                                cfg.ssm_headdim, cfg.ssm_state),
                        "conv": (cfg.n_layers, B, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)}
        else:
            n = (n_super if key == "kv_shared" else
                 cfg.n_layers // 2 if key in ("kv_local", "kv_global")
                 else cfg.n_layers)
            out[key] = {k: kv(n) for k in axes}
    return out


def _same(rules, mesh, pairs):
    stub = _Stub(mesh)
    for path, axes, dims in pairs:
        got = tuple(resolve_spec(RULE_SETS[rules], stub, axes, dims))
        want = tuple(j_resolve(J_RULES[rules], stub, axes, dims))
        assert got == want, (rules, path, axes, dims, got, want)
        got = tuple(resolve_spec(RULE_SETS[rules], stub, axes))
        assert got == tuple(j_resolve(J_RULES[rules], stub, axes)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULE_SETS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_equals_reference(arch, rules, mesh):
    cfg = get_model_config(arch)
    assert set(RULE_SETS) == set(J_RULES)
    assert dict(RULE_SETS[rules].rules) == dict(J_RULES[rules].rules)
    shapes = _decl_shapes(lm.model_decls(cfg))
    pairs = _pairs(state_logical_axes(cfg), {"params": shapes, "opt_state": {
        "m": shapes, "v": shapes}, "step": ()})
    assert [a for _, a, _ in pairs] == [
        a for _, a in leaves_with_paths(j_state_axes(jreg.get_model_config(
            arch)))]
    run = get_run_config(arch, optimizer="adafactor")
    ada = {k: tuple(v.shape) for k, v in leaves_with_paths(
        abstract_state(cfg, run)["opt_state"])}
    ada_pairs = [(p, a, ada[p]) for p, a in leaves_with_paths(
        state_logical_axes(cfg, run)["opt_state"])]
    j_ada = j_state_axes(jreg.get_model_config(arch),
                         jreg.get_run_config(arch, optimizer="adafactor"))
    assert [a for _, a, _ in ada_pairs] == [
        a for _, a in leaves_with_paths(j_ada["opt_state"])]
    if cfg.family != "audio":
        cache = lm.cache_logical_axes(cfg)
        assert cache == jlm.cache_logical_axes(jreg.get_model_config(arch))
        pairs += _pairs(cache, _cache_dims(cfg))
    _same(rules, MESHES[mesh], pairs + ada_pairs)


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_plan_mesh_shape_equals_reference(mp):
    for n in range(mp, 1025, mp):
        assert plan_mesh_shape(n, model_parallel=mp) == j_plan(
            n, model_parallel=mp), n
    with pytest.raises(ValueError):
        plan_mesh_shape(2 * mp + 1, model_parallel=2 * mp)


def _ranks(shape, axes):
    return [Mesh(shape, axes, rank=r) for r in range(int(np.prod(shape)))]


def _assemble(mesh0, spec, shards, full_shape):
    """The full tensor put back from every rank's shard."""
    out = torch.full(full_shape, float("nan"))
    for m, s in shards:
        local_slice(m, spec, out).copy_(s)
    return out


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 1, 2)])
def test_shards_reassemble_the_full_leaves(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    cfg = reduced(get_model_config("olmoe-1b-7b"))
    decls = lm.model_decls(cfg)
    full = init_params(decls, torch.Generator().manual_seed(0), "cpu")
    meshes = _ranks(shape, axes)
    specs = tree_shardings(RULE_SETS["default"], meshes[0],
                           logical_axes(decls), full)
    per_rank = [shard_params(full, specs, m) for m in meshes]
    flat_specs = dict(leaves_with_paths(specs))
    sharded = 0
    for path, t in leaves_with_paths(full):
        spec = flat_specs[path]
        shards = [(m, dict(leaves_with_paths(pr))[path])
                  for m, pr in zip(meshes, per_rank)]
        for m, s in shards:
            assert tuple(s.shape) == shard_shape(m, spec, t.shape)
        back = _assemble(meshes[0], spec, shards, t.shape)
        assert torch.equal(back, t), path
        sharded += any(p is not None for p in spec)
    assert sharded > 0


def test_checkpoint_saved_full_restores_into_another_meshs_slices(tmp_path):
    cfg = reduced(get_model_config("llama3.2-3b"))
    run = get_run_config("llama3.2-3b", rules_name="default")
    state = init_state(cfg, run, torch.Generator().manual_seed(3), "cpu").tree()
    checkpoint.save(state, 5, str(tmp_path))
    meshes = _ranks((1, 2), ("data", "model"))
    specs = tree_shardings(RULE_SETS["default"], meshes[0],
                           state_logical_axes(cfg, run),
                           abstract_state(cfg, run))
    full = dict(leaves_with_paths(state))
    for m in meshes:
        got, step = checkpoint.restore(str(tmp_path), state, shardings=specs,
                                       mesh=m)
        assert step == 5
        for path, t in leaves_with_paths(got):
            spec = dict(leaves_with_paths(specs))[path]
            assert torch.equal(t, local_slice(m, spec, full[path])), path
    wq = dict(leaves_with_paths(got))[("params", "layers", "attn", "wq")]
    assert wq.shape[-1] * 2 == cfg.n_heads * cfg.head_dim


def test_shape_only_mesh_without_a_process_group():
    mesh = make_mesh_for((16, 16), ("data", "model"))
    assert mesh.shape == {"data": 16, "model": 16} and not mesh.live
    assert make_mesh_for("2x16x16").axis_names == ("pod", "data", "model")
