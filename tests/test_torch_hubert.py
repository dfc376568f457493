"""hubert-xlarge in the port on the CPU against the JAX package, on the same
numpy weights: the config copy and its declarations (the audio
``frontend`` in place of ``embed``), the encoder's forward (a frame
projection, the learned position table, bidirectional attention, GELU,
LayerNorm) at head_dim 32 and at hubert's 80, the D = 80 model also
against the Pallas ``flash_attention`` in interpret mode, the plain
attention and its gradient at D = 80 against ``repro/kernels/ref.py`` and
``jax.vjp``, two AdamW steps against JAX's ``make_train_step``, the
encode that ``make_prefill_step`` runs, and the refusals of a decode path
(the cache, the engine, the serve launcher)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving.engine import make_prefill_step as jmake_prefill  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro.train.step import init_state as jinit_state  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import hubert_xlarge  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS,  # noqa: E402
                                          get_model_config, get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, load_numpy_params,  # noqa: E402
                                       load_numpy_state, param_count)
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.engine import make_prefill_step  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "hubert-xlarge"
# full-size parameter count, from the declarations: ~1.03 B (the 65536-row
# position table is 84 M of it)
PARAMS = 1_029_163_520
F32_TOL = 1e-4        # model forward: same weights, other summation order
ATTN_TOL = 1e-5       # one attention call in f32
# the reduced config (head_dim 32) and hubert's head_dim 80 at 2 layers,
# d 160, 2 heads
HEADS = {"d32": {}, "d80": dict(d_model=160, n_heads=2, n_kv_heads=2,
                                head_dim=80)}
# as tests/test_torch_remat.py: metrics 1e-4 relative, parameters after two
# AdamW steps (lr 1e-3) within 5e-6
PARAM_TOL = 5e-6
RUN_KW = dict(logits_chunk=16, learning_rate=1e-3, warmup_steps=2,
              total_steps=10)
B, S = 2, 32          # tests/test_models.py's batch


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _pair(heads, jmode="reference"):
    """(JAX cfg/ctx/params, port cfg/ctx/params) on one f32 weight set of
    the reduced config; the JAX side's attention in ``jmode``.  The norms'
    scales and biases are moved off their init, so the LayerNorm counts."""
    jcfg = jreduced(jget_cfg(ARCH), **HEADS[heads])
    jrun = jget_run(ARCH, remat="none", compute_dtype="float32",
                    kernel_mode=jmode)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    rng = np.random.default_rng(1)

    def perturb(path, a):
        if path[-1].key in ("scale", "bias"):
            return a + jnp.asarray(0.3 * rng.standard_normal(a.shape),
                                   a.dtype)
        return a

    jparams = jax.tree_util.tree_map_with_path(
        perturb, jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0)))
    cfg = reduced(get_model_config(ARCH), **HEADS[heads])
    run = get_run_config(ARCH, remat="none", compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jctx, jparams), (cfg, Ctx(run, "cpu"), params)


def _frames(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).standard_normal(
        (batch, seq, cfg.frontend_dim)).astype(np.float32)


def test_config_and_decls_mirror_the_reference():
    """The copy equals the reference's config, full and reduced (and at
    head_dim 80), with the same RUN_OVERRIDES and the same declared shapes
    (``frontend.proj``, ``frontend.pos``, no ``embed``); the port's
    ``ARCH_IDS`` equal the reference's, and none of them is refused."""
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        get_model_config(arch)
        get_run_config(arch)
    assert "A copy of" in hubert_xlarge.__doc__
    assert dataclasses.asdict(get_run_config(ARCH)) \
        == dataclasses.asdict(jget_run(ARCH))
    for heads in (None, *HEADS):
        cfg, jcfg = get_model_config(ARCH), jget_cfg(ARCH)
        if heads is not None:
            cfg = reduced(cfg, **HEADS[heads])
            jcfg = jreduced(jcfg, **HEADS[heads])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        decls = lm.model_decls(cfg)
        shapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init, pd.scale),
                              decls, is_leaf=lambda x: isinstance(x, PD))
        jshapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init,
                                           pd.scale),
                               jlm.model_decls(jcfg),
                               is_leaf=lambda x: hasattr(x, "axes"))
        assert shapes == jshapes
        assert "embed" not in decls
        assert decls["frontend"]["pos"].shape == (cfg.max_wavelength_pos,
                                                  cfg.d_model)
    cfg = get_model_config(ARCH)
    assert (cfg.head_dim, cfg.causal, cfg.use_rope) == (80, False, False)
    assert param_count(lm.model_decls(cfg)) == PARAMS


@pytest.mark.parametrize("heads,jmode", [("d32", "reference"),
                                         ("d80", "reference"),
                                         ("d80", "pallas_interpret")])
def test_encoder_logits_match_jax(heads, jmode):
    """The reduced encoder, 40 frames (bidirectional: every frame sees the
    later ones), last hidden state and logits against the reference's on
    the same weights and frames, at head_dim 32 and 80; at 80 also against
    the reference run through its Pallas ``flash_attention`` in interpret
    mode.  A frame changed at the end moves the first row's output: the
    attention is not causal."""
    (jcfg, jctx, jparams), (cfg, ctx, params) = _pair(heads, jmode)
    frames = _frames(cfg, seq=40)
    jh, _, _ = jlm.forward(jctx, jcfg, jparams,
                           {"frames": jnp.asarray(frames)})
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    h, _, cache = lm.forward(ctx, cfg, params,
                             {"frames": torch.from_numpy(frames)})
    assert cache is None and h.shape == (B, 40, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
    np.testing.assert_allclose(lm.logits_for(ctx, cfg, params, h).numpy(),
                               np.asarray(jlog), atol=F32_TOL)
    later = frames.copy()
    later[:, -1] += 1.0
    h2, _, _ = lm.forward(ctx, cfg, params, {"frames": torch.from_numpy(later)})
    assert (h2[:, 0] - h[:, 0]).abs().max() > 1e-4


# (Sq, Sk, causal): hubert's bidirectional self-attention, odd lengths,
# Sq != Sk, and one causal case
ATTN_CASES = {"square": (64, 64, False), "odd": (50, 37, False),
              "causal": (45, 45, True)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_attention_and_gradient_at_head_dim_80(case):
    """The port's plain attention (with its lse) and its gradient at D =
    80, 16 query heads over 16 kv heads as hubert's: ``attention_naive``
    against the reference's, and ``attention_bwd_ref`` from the saved
    output and lse against ``jax.vjp`` of the reference's
    ``attention_naive``; the blockwise version alike.  The cache-free
    wrappers take D = 80 (on the CPU their plain versions)."""
    Sq, Sk, causal = ATTN_CASES[case]
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((2, Sq, 16, 80)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 16, 80)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, scale=80 ** -0.5)
    jout, vjp = jax.vjp(lambda a, b, c: jref.attention_naive(a, b, c, **kw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tfa.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATTN_TOL)
    np.testing.assert_allclose(
        ref.attention_blockwise(tq, tk, tv, block_kv=16, **kw).numpy(),
        np.asarray(jout), atol=ATTN_TOL)
    grads = tfa.flash_attention_bwd(tq, tk, tv, out, lse,
                                    torch.from_numpy(dout), **kw)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=ATTN_TOL, err_msg=name)


@pytest.mark.parametrize("heads", list(HEADS))
def test_two_adamw_steps_match_jax(heads):
    """Two AdamW steps of the reduced encoder in f32 from JAX's initial
    state (frames and labels over vocab 504, tests/test_models.py's batch
    shapes): loss and grad norm per step, then every parameter and
    optimizer moment."""
    jcfg = jreduced(jget_cfg(ARCH), **HEADS[heads])
    jrun = jget_run(ARCH, remat="full", compute_dtype="float32", **RUN_KW)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jstate = jinit_state(jcfg, jrun, jax.random.PRNGKey(0)).tree()
    cfg = reduced(get_model_config(ARCH), **HEADS[heads])
    run = get_run_config(ARCH, remat="full", compute_dtype="float32",
                         **RUN_KW)
    state = load_numpy_state(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jmake_step(jcfg, jrun, jctx))
    step = make_train_step(cfg, run, Ctx(run, "cpu"))
    rng = np.random.default_rng(7)
    for i in range(2):
        batch = {"frames": _frames(cfg, seed=10 + i),
                 "labels": rng.integers(0, cfg.vocab, (B, S),
                                        dtype=np.int32)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]),
                                                  rel=F32_TOL), key
    jl = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
    mine = leaves(state["params"])
    assert len(jl) == len(mine)
    for (path, a), b in zip(jl, mine):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=PARAM_TOL, err_msg=str(path))
    jo = jax.tree_util.tree_flatten_with_path(jstate["opt_state"])[0]
    for (path, a), b in zip(jo, leaves(state["opt_state"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=F32_TOL, atol=1e-6, err_msg=str(path))
    assert int(state["step"]) == int(jstate["step"]) == 2


def test_prefill_step_is_the_reference_encode():
    """``make_prefill_step`` of the audio encoder is a whole encode with no
    cache: (None, the last frame's logits), equal to the reference's."""
    (jcfg, jctx, jparams), (cfg, ctx, params) = _pair("d80")
    frames = _frames(cfg, seed=3)
    jrun = jget_run(ARCH, compute_dtype="float32")
    jcache, jlog = jmake_prefill(jcfg, jrun, jctx, 64)(
        jparams, {"frames": jnp.asarray(frames)})
    cache, logits = make_prefill_step(cfg, ctx.run, ctx, 64)(
        params, {"frames": torch.from_numpy(frames)})
    assert cache is None and jcache is None
    assert logits.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=F32_TOL)


def test_decode_paths_refuse_the_encoder_as_the_reference():
    """No decode cache (``init_cache``, ``init_paged_cache``,
    ``cache_slot_spec``), no engine and no serve launcher for the audio
    family, each with the reference's message."""
    (jcfg, jctx, _), (cfg, ctx, _) = _pair("d32")
    msg = "audio has no decode cache (encoder-only)"
    with pytest.raises(ValueError) as jerr:
        jlm.init_cache(jctx, jcfg, 2, 64)
    assert str(jerr.value) == msg
    for make in (lambda: lm.init_cache(ctx, cfg, 2, 64),
                 lambda: lm.init_paged_cache(ctx, cfg, 2, 64, 16),
                 lambda: lm.cache_slot_spec(cfg)):
        with pytest.raises(ValueError, match=msg.replace("(", r"\(")
                           .replace(")", r"\)")):
            make()
    with pytest.raises(ValueError, match="encoder-only arch has no decode "
                                         "path"):
        ServeEngine(cfg, ctx.run, ctx, {})
    from repro_torch.launch import serve
    for flags in ([], ["--no-reduced"]):
        with pytest.raises(SystemExit,
                           match="encoder-only arch has no decode path"):
            serve.main(["--arch", ARCH, "--device", "cpu", *flags])
