"""The port's dense model on the CPU against the JAX package, on the same
weights: the JAX parameters go through ``np.asarray`` into
``repro_torch.models.params.load_numpy_params``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, init_params,  # noqa: E402
                                       load_numpy_params, param_count)
from repro_torch.serving import engine  # noqa: E402

ARCH = "llama3.2-3b"
F32_TOL = 1e-4        # same weights, f32 maths, other summation order
BF16_TOL = 0.15       # the reference's own bf16 bound (tests/test_serving.py:63)


def _pair(dtype="float32"):
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) on one weight set."""
    jcfg = jreduced(jget_cfg(ARCH))
    jrun = jget_run(ARCH, remat="none", compute_dtype=dtype)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none", compute_dtype=dtype)
    ctx = Ctx(run, device="cpu")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def test_config_and_decls_mirror_the_reference():
    (jcfg, _, _, jparams), (cfg, _, _, params) = _pair()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = dataclasses.asdict(get_model_config(ARCH))
    assert full == dataclasses.asdict(jget_cfg(ARCH))
    decls = lm.model_decls(cfg)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda pd: tuple(pd.shape), decls,
                           is_leaf=lambda x: isinstance(x, PD))
    assert tshapes == jshapes
    assert param_count(decls) == sum(a.size for a in jax.tree.leaves(jparams))


def test_init_params_std_rule_matches_reference():
    """Same init kinds and stds, including the fan-in quirk that counts the
    layer-stack dim of undecorated stacked leaves (w_up: fan = L * d)."""
    cfg = reduced(get_model_config(ARCH), n_layers=4, d_model=256, d_ff=512)
    gen = torch.Generator().manual_seed(0)
    p = init_params(lm.model_decls(cfg), gen, "cpu")
    assert torch.equal(p["layers"]["ln1"]["scale"],
                       torch.ones(4, cfg.d_model))
    std_up = p["layers"]["mlp"]["w_up"].std().item()
    assert std_up == pytest.approx((4 * cfg.d_model) ** -0.5, rel=0.05)
    std_q = p["layers"]["attn"]["wq"].std().item()
    assert std_q == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    assert p["embed"]["table"].std().item() == pytest.approx(0.02, rel=0.05)


def test_forward_and_logits_match_reference():
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = _pair()
    toks = _tokens(2, 12, cfg.vocab)
    jh, _, _ = jlm.forward(jctx, jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    h, _, _ = lm.forward(ctx, cfg, params, {"tokens": torch.from_numpy(toks)})
    logits = lm.logits_for(ctx, cfg, params, h)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_and_decode_steps_match_reference(dtype, tol):
    """make_prefill_step, then two decode steps: a scalar-index one and a
    per-slot (B,) one (the cache_update path, with a done lane)."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = _pair(dtype)
    B, S, MAX = 3, 9, 32
    toks = _tokens(B, S, cfg.vocab)
    jpre = jengine.make_prefill_step(jcfg, jrun, jctx, MAX)
    jdec = jengine.make_decode_step(jcfg, jrun, jctx)
    params = lm.prepare_params(ctx, params)
    pre = engine.make_prefill_step(cfg, run, ctx, MAX)
    dec = engine.make_decode_step(cfg, run, ctx)

    jcache, jlog = jpre(jparams, {"tokens": jnp.asarray(toks)})
    cache, log = pre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=tol)

    nxt = np.array(jnp.argmax(jlog[:, 0], -1), np.int32)[:, None]
    jcache, jlog = jdec(jparams, jcache, jnp.asarray(nxt),
                        jnp.asarray(S, jnp.int32))
    cache, log = dec(params, cache, torch.from_numpy(nxt), S)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=tol)

    idx = np.array([S + 1, S + 1, MAX], np.int32)      # last lane: done
    jcache, jlog = jdec(jparams, jcache, jnp.asarray(nxt), jnp.asarray(idx))
    cache, log = dec(params, cache, torch.from_numpy(nxt),
                     torch.from_numpy(idx))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            cache["kv"][key].float().numpy(),
            np.asarray(jcache["kv"][key].astype(jnp.float32)), atol=tol)


def test_other_families_name_their_roadmap_item():
    """Every family of the reference is ported now (ROADMAP queue 1 item
    12 brought the vlm and audio ones): the port's ``ARCH_IDS`` equal the
    reference's, and no architecture's config, run config or declarations
    raise ``NotImplementedError``; the reduced config of each declares the
    same parameters as the reference's."""
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    from repro_torch.configs.registry import ARCH_IDS
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        cfg = reduced(get_model_config(arch))
        get_run_config(arch)
        assert param_count(lm.model_decls(cfg)) \
            == param_count(jlm.model_decls(jreduced(jget_cfg(arch))))
    for family in ("vlm", "audio"):
        cfg = dataclasses.replace(reduced(get_model_config(ARCH)),
                                  family=family)
        lm.model_decls(cfg)
    with pytest.raises(ValueError):
        lm.model_decls(dataclasses.replace(reduced(get_model_config(ARCH)),
                                           family="unknown"))
