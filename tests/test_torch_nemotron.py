"""minitron-4b and nemotron-4-15b in the port on the CPU against the JAX
package, on the same numpy weights: the config copies and their
declarations, layernorm1p and the squared-ReLU MLP, the reduced models'
forward logits, and the f32 greedy streams of the serving engine (dense
and paged), at the reduced configs' heads and at a GQA group of 6 (12
query heads over 2 kv heads, nemotron-4-15b's 48 over 8); and the bf16
weights cast leaf by leaf as drawn, as the card's arms make them."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs import minitron_4b, nemotron4_15b  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS,  # noqa: E402
                                          get_model_config, get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, init_params,  # noqa: E402
                                       load_numpy_params, param_count)
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCHS = ["minitron-4b", "nemotron-4-15b"]
# full-size parameter counts, from the declarations
PARAMS = {"minitron-4b": 4_190_509_056, "nemotron-4-15b": 15_628_775_424}
F32_TOL = 1e-4        # model forward: same weights, other summation order
NORM_TOL = 1e-6       # one layer's norm or MLP in f32
# reduced heads (4 over 2) and a GQA group of 6, as nemotron-4-15b's
HEADS = {"reduced": {}, "group6": dict(n_heads=12, n_kv_heads=2)}
KW = dict(batch_size=3, max_seq=48, prefill_chunk=8, decode_chunk=4)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8)}


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _pair(arch, heads="reduced"):
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) on one f32 weight
    set of the reduced config; the norms' scales and biases are moved off
    their init (zeros under layernorm1p), so the +1 and the bias count."""
    jcfg = jreduced(jget_cfg(arch), **HEADS[heads])
    jrun = jget_run(arch, remat="none", compute_dtype="float32")
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    rng = np.random.default_rng(1)

    def perturb(path, a):
        if path[-1].key in ("scale", "bias"):
            return a + jnp.asarray(0.3 * rng.standard_normal(a.shape),
                                   a.dtype)
        return a

    jparams = jax.tree_util.tree_map_with_path(
        perturb, jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0)))
    cfg = reduced(get_model_config(arch), **HEADS[heads])
    run = get_run_config(arch, remat="none", compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_decls_mirror_the_reference(arch):
    """The copies equal the reference's configs, full and reduced, with
    the same RUN_OVERRIDES (rules names carried), the same declared
    shapes, and the parameter counts reckoned from them."""
    assert arch in ARCH_IDS
    module = {"minitron-4b": minitron_4b, "nemotron-4-15b": nemotron4_15b}
    assert "A copy of" in module[arch].__doc__
    assert dataclasses.asdict(get_model_config(arch)) \
        == dataclasses.asdict(jget_cfg(arch))
    assert dataclasses.asdict(get_run_config(arch)) \
        == dataclasses.asdict(jget_run(arch))
    for heads in HEADS:
        for cut in (True, False):
            cfg, jcfg = get_model_config(arch), jget_cfg(arch)
            if cut:
                cfg = reduced(cfg, **HEADS[heads])
                jcfg = jreduced(jcfg, **HEADS[heads])
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            shapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init),
                                  lm.model_decls(cfg),
                                  is_leaf=lambda x: isinstance(x, PD))
            jshapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init),
                                   jlm.model_decls(jcfg),
                                   is_leaf=lambda x: hasattr(x, "axes"))
            assert shapes == jshapes
    cfg = get_model_config(arch)
    assert (cfg.norm, cfg.mlp, cfg.rotary_pct) == ("layernorm1p",
                                                  "squared_relu", 0.5)
    assert param_count(lm.model_decls(cfg)) == PARAMS[arch]
    if arch == "nemotron-4-15b":
        assert cfg.n_heads // cfg.n_kv_heads == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_layernorm1p_and_squared_relu_match_jax(arch):
    """One layer's layernorm1p (scale + 1, with bias) and squared-ReLU MLP
    on the same inputs and weights, f32."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = _pair(arch)
    x = np.random.default_rng(2).standard_normal((2, 9, cfg.d_model)) \
        .astype(np.float32)
    jln = jax.tree.map(lambda a: a[0], jparams["layers"]["ln1"])
    ln = {k: v[0] for k, v in params["layers"]["ln1"].items()}
    assert set(ln) == {"scale", "bias"}
    _close(L.apply_norm(cfg, ln, torch.from_numpy(x)),
           jL.apply_norm(jcfg, jln, jnp.asarray(x)), NORM_TOL)
    jmlp = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    mlp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    assert "w_gate" not in mlp
    _close(L.apply_mlp(ctx, cfg, mlp, torch.from_numpy(x)),
           jL.apply_mlp(jctx, jcfg, jmlp, jnp.asarray(x)), NORM_TOL)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=tol * max(1.0, np.abs(want).max()),
                               rtol=tol)


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, heads):
    """The whole reduced model, cache-free: last hidden state and logits
    (partial rotary, layernorm1p, squared ReLU, untied unembedding)."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = _pair(arch, heads)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40),
                                             dtype=np.int32)
    jh, _, _ = jlm.forward(jctx, jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    h, _, _ = lm.forward(ctx, cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
    np.testing.assert_allclose(lm.logits_for(ctx, cfg, params, h).numpy(),
                               np.asarray(jlog), atol=F32_TOL)


def _reqs(cls):
    rng = np.random.default_rng(4)
    lens = [13, 3, 21, 9, 30]
    return [cls(uid=i, prompt=rng.integers(1, 500, n).tolist(),
                max_new_tokens=int(rng.integers(3, 9)))
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_the_jax_engine(arch, heads, mode):
    """f32 greedy token streams of the port's engine (chunked prefill,
    continuous batching, slots reused) equal the JAX engine's."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = _pair(arch, heads)
    want = {r.uid: list(r.generated) for r in JServeEngine(
        jcfg, jrun, jctx, jparams, **MODES[mode], **KW).generate(
            _reqs(JRequest))}
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    got = {r.uid: list(r.generated) for r in eng.generate(_reqs(Request))}
    assert got == want
    assert {u: len(s) for u, s in got.items()} == {
        r.uid: r.max_new_tokens for r in _reqs(Request)}



@pytest.mark.parametrize("arch", ARCHS + ["mamba2-370m", "olmoe-1b-7b"])
def test_weights_cast_as_drawn_equal_the_cast_masters(arch):
    """``init_params(..., prepare=lm.prepare_leaf)`` (each f32 leaf cast as
    soon as it is drawn, so the masters never exist whole) gives exactly
    ``lm.prepare_params`` of the masters from the same seed: bf16
    matrices, the ``layers.F32_LEAVES`` kept float32."""
    cfg = reduced(get_model_config(arch))
    ctx = Ctx(get_run_config(arch, remat="none"), "cpu")
    decls = lm.model_decls(cfg)
    want = dict(leaves_with_paths(lm.prepare_params(
        ctx, init_params(decls, torch.Generator().manual_seed(3), "cpu"))))
    got = dict(leaves_with_paths(init_params(
        decls, torch.Generator().manual_seed(3), "cpu",
        functools.partial(lm.prepare_leaf, ctx))))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path
    assert {w.dtype for w in want.values()} == {torch.bfloat16,
                                                torch.float32}
