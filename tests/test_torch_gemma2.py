"""gemma2-2b in the port on the CPU against the JAX package, on the same
numpy weights: the config copy and its declarations (local and global
layer stacks, sandwich norms), the sandwich-norm block, the reduced
model's forward logits with the local window acting (and at head_dim
256), the f32 greedy streams of the serving engine (dense, paged, prefix
sharing) over prompts and decodes that cross the window, a slot's drain
and restore and its int8 payload round trip, and the engine's refusal of
the audio family."""

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
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs import gemma2_2b  # noqa: E402
from repro_torch.configs.base import ModelConfig, reduced  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS,  # noqa: E402
                                          get_model_config, get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, load_numpy_params,  # noqa: E402
                                       param_count)
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "gemma2-2b"
# full-size parameter count, from the declarations: ~2.61 B
PARAMS = 2_614_341_888
F32_TOL = 1e-4        # model forward: same weights, other summation order
# reduced heads (head_dim 32) and gemma2's own head_dim 256
HEADS = {"reduced": {}, "d256": dict(head_dim=256)}
# max_seq past the reduced window (64): prompts and decodes cross it
KW = dict(batch_size=3, max_seq=160, prefill_chunk=32, decode_chunk=4)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8),
         "prefix": dict(paged=True, block_size=8, prefix_sharing=True)}


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _pair(heads="reduced"):
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) on one f32 weight
    set of the reduced config; the norms' scales are moved off their init
    (ones), so the sandwich norms count."""
    jcfg = jreduced(jget_cfg(ARCH), **HEADS[heads])
    jrun = jget_run(ARCH, remat="none", compute_dtype="float32")
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    rng = np.random.default_rng(1)

    def perturb(path, a):
        if path[-1].key == "scale":
            return a + jnp.asarray(0.3 * rng.standard_normal(a.shape),
                                   a.dtype)
        return a

    jparams = jax.tree_util.tree_map_with_path(
        perturb, jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0)))
    cfg = reduced(get_model_config(ARCH), **HEADS[heads])
    run = get_run_config(ARCH, remat="none", compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


def test_config_and_decls_mirror_the_reference():
    """The copy equals the reference's config, full and reduced (and at
    head_dim 256), with the same RUN_OVERRIDES, the same declared shapes
    (``layers_local``, ``layers_global``, ``post_ln1``, ``post_ln2``), and
    the parameter count reckoned from them."""
    assert ARCH in ARCH_IDS
    assert "A copy of" in gemma2_2b.__doc__
    assert dataclasses.asdict(get_model_config(ARCH)) \
        == dataclasses.asdict(jget_cfg(ARCH))
    assert dataclasses.asdict(get_run_config(ARCH)) \
        == dataclasses.asdict(jget_run(ARCH))
    for heads in (None, *HEADS):
        cfg, jcfg = get_model_config(ARCH), jget_cfg(ARCH)
        if heads is not None:
            cfg = reduced(cfg, **HEADS[heads])
            jcfg = jreduced(jcfg, **HEADS[heads])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        decls = lm.model_decls(cfg)
        shapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init), decls,
                              is_leaf=lambda x: isinstance(x, PD))
        jshapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init),
                               jlm.model_decls(jcfg),
                               is_leaf=lambda x: hasattr(x, "axes"))
        assert shapes == jshapes
        assert "layers" not in decls
        for stack in ("layers_local", "layers_global"):
            assert {"post_ln1", "post_ln2"} <= set(decls[stack])
            assert decls[stack]["ln1"]["scale"].shape[0] == cfg.n_layers // 2
    cfg = get_model_config(ARCH)
    assert (cfg.head_dim, cfg.local_window, cfg.query_scale) \
        == (256, 4096, 256.0)
    assert reduced(cfg).local_window == 64
    assert param_count(lm.model_decls(cfg)) == PARAMS


def test_sandwich_norms_and_window_in_one_block_match_jax(f32_pair):
    """One local block (window 64, sandwich norms, GeGLU, softcap 50,
    query scale) on the same input and weights as the reference's
    ``_tf_block``, 150 rows so the window masks; and the same block with
    its post-norms removed differs, so they take part."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = f32_pair
    from repro.models import layers as jL
    from repro_torch.models import layers as L
    x = np.random.default_rng(2).standard_normal((2, 150, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(150, dtype=np.int32), (2, 150))
    jcos, jsin = jL.rope_cos_sin(jcfg, jnp.asarray(pos))
    cos, sin = L.rope_cos_sin(cfg, torch.from_numpy(pos.copy()))
    jp = jax.tree.map(lambda a: a[0], jparams["layers_local"])
    p = {k: {kk: vv[0] for kk, vv in v.items()}
         for k, v in params["layers_local"].items()}
    jh, _, _ = jlm._tf_block(jctx, jcfg, jp, jnp.asarray(x), jcos, jsin,
                             local_window=jcfg.local_window)
    h, _, _ = lm._tf_block(ctx, cfg, p, torch.from_numpy(x), cos, sin,
                           local_window=cfg.local_window)
    want = np.asarray(jh)
    np.testing.assert_allclose(h.numpy(), want, atol=F32_TOL)
    bare = {k: v for k, v in p.items() if not k.startswith("post_ln")}
    h2, _, _ = lm._tf_block(ctx, cfg, bare, torch.from_numpy(x), cos, sin,
                            local_window=cfg.local_window)
    assert np.abs(h2.numpy() - want).max() > 1e-2
    # the window masks: the global block gives another output
    h3, _, _ = lm._tf_block(ctx, cfg, p, torch.from_numpy(x), cos, sin)
    assert np.abs(h3.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("heads", list(HEADS))
def test_forward_logits_match_jax(heads):
    """The whole reduced model, cache-free, 150 rows past the window of 64:
    last hidden state and logits (local/global pairs, sandwich norms,
    attention and final softcaps, query scale, embed scaling, tied
    embeddings), at head_dim 32 and 256.  The blockwise plain attention
    (``naive_below``) at 150 rows takes the same numbers."""
    (jcfg, _, jctx, jparams), (cfg, run, ctx, params) = _pair(heads)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 150),
                                             dtype=np.int32)
    jh, _, _ = jlm.forward(jctx, jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    for naive_below in (2049, 64):
        run_n = run.replace(naive_attn_below=naive_below)
        ctx_n = Ctx(run_n, "cpu")
        h, _, _ = lm.forward(ctx_n, cfg, params,
                             {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
        np.testing.assert_allclose(
            lm.logits_for(ctx_n, cfg, params, h).numpy(), np.asarray(jlog),
            atol=F32_TOL)


def test_chunked_cache_forward_equals_the_cache_free_one(f32_pair):
    """Prefill in 32-row chunks into ``init_cache``'s two stacks (each
    layer's rows in its own ``kv_local``/``kv_global``), then decode steps
    past the window: the last hidden state equals the cache-free
    forward's over the whole sequence; paged alike."""
    _, (cfg, _, ctx, params) = f32_pair
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 100), dtype=np.int32))
    full, _, _ = lm.forward(ctx, cfg, params, {"tokens": toks})
    for paged in (False, True):
        if paged:
            cache = lm.init_paged_cache(ctx, cfg, 1, 128, 8)
            cache["block_tables"][0] = torch.arange(16, dtype=torch.int32)
        else:
            cache = lm.init_cache(ctx, cfg, 1, 128)
        assert set(cache) - {"block_tables"} == {"kv_local", "kv_global"}
        assert lm.cache_slot_spec(cfg) == {"kv_local": "rows",
                                           "kv_global": "rows"}
        for i in range(0, 96, 32):
            h, _, _ = lm.forward(ctx, cfg, params,
                                 {"tokens": toks[:, i:i + 32]}, cache=cache,
                                 cache_index=i)
            np.testing.assert_allclose(h.numpy(),
                                       full[:, i:i + 32].numpy(),
                                       atol=F32_TOL)
        for i in range(96, 100):
            h, _, _ = lm.forward(ctx, cfg, params,
                                 {"tokens": toks[:, i:i + 1]}, cache=cache,
                                 cache_index=torch.tensor([i]))
            np.testing.assert_allclose(h[:, 0].numpy(), full[:, i].numpy(),
                                       atol=F32_TOL)


def _reqs(cls, prefix_len=0):
    """Five requests; three prompts longer than the window (64), and
    decodes that cross it.  With ``prefix_len`` every prompt starts with
    the same 70 tokens."""
    rng = np.random.default_rng(4)
    lens = [70, 13, 95, 40, 110]
    prefix = rng.integers(1, 500, 70).tolist()
    out = []
    for i, n in enumerate(lens):
        prompt = rng.integers(1, 500, n).tolist()
        if prefix_len:
            prompt = prefix + prompt[:max(n - 70, 3)]
        out.append(cls(uid=i, prompt=prompt,
                       max_new_tokens=int(rng.integers(3, 12)),
                       prefix_len=prefix_len))
    return out


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_streams_equal_the_jax_engine(f32_pair, mode):
    """f32 greedy token streams of the port's engine (chunked prefill,
    continuous batching, slots reused) equal the JAX engine's, dense,
    paged and with prefix sharing (70 shared rows, past the window); the
    prefix-shared streams also equal the dense engine's."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    prefix = 70 if mode == "prefix" else 0
    jeng = JServeEngine(jcfg, jrun, jctx, jparams, **MODES[mode], **KW)
    want = _streams(jeng.generate(_reqs(JRequest, prefix)))
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    got = _streams(eng.generate(_reqs(Request, prefix)))
    assert got == want
    assert {u: len(s) for u, s in got.items()} == {
        r.uid: r.max_new_tokens for r in _reqs(Request, prefix)}
    if prefix:
        assert eng.prefill_tokens_skipped == jeng.prefill_tokens_skipped > 0
        dense = ServeEngine(cfg, run, ctx, params, **KW)
        assert _streams(dense.generate(_reqs(Request, prefix))) == got


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_drain_and_restore_equal_staying_put(f32_pair, paged):
    """A gemma2 engine drained mid-decode (both rows keys exported per
    slot) and restored into another engine finishes with the streams of
    an engine that was never drained."""
    _, (cfg, run, ctx, params) = f32_pair
    mode = MODES["paged" if paged else "dense"]
    want = _streams(ServeEngine(cfg, run, ctx, params, **mode, **KW)
                    .generate(_reqs(Request)))
    src = ServeEngine(cfg, run, ctx, params, **mode, **KW)
    src.start(_reqs(Request))
    src.step()
    snaps = src.drain()
    assert any(s.warm for s in snaps)
    for s in snaps:
        if s.warm:
            assert set(s.payload) == {"kv_local", "kv_global"}
    dst = ServeEngine(cfg, run, ctx, params, **mode, **KW)
    dst.restore(snaps)
    while dst.pending:
        dst.step()
    assert _streams(src.finished + dst.finished) == want


def test_int8_payload_round_trip_equals_the_reference(f32_pair):
    """A slot's int8 payload (both rows keys) exported and imported gives,
    bit for bit, the plain int8 round trip of its rows, and the JAX
    package's export/import of the same cache the same lane."""
    (jcfg, _, jctx, _), (cfg, _, ctx, _) = f32_pair
    rng = np.random.default_rng(5)
    cache = lm.init_cache(ctx, cfg, 2, 96)
    for key in cache:
        for k in cache[key]:
            cache[key][k].copy_(torch.from_numpy(rng.standard_normal(
                cache[key][k].shape).astype(np.float32)))
    jcache = {key: {k: jnp.asarray(v.numpy()) for k, v in leaves.items()}
              for key, leaves in cache.items()}
    payload = lm.export_slot(cfg, cache, 1, 80, quantize=True)
    assert lm.payload_is_quantized(payload)
    out = lm.init_cache(ctx, cfg, 2, 96)
    lm.import_slot(cfg, out, payload, 0)
    jpay = jlm.export_slot(jcfg, jcache, 1, 80, quantize=True)
    jout = jlm.import_slot(jcfg, jlm.init_cache(jctx, jcfg, 2, 96), jpay, 0)
    for key in ("kv_local", "kv_global"):
        for k in ("k", "v"):
            rows = cache[key][k][:, 1, :80]
            want = ref.int8_dequantize(*ref.int8_quantize(rows), rows.dtype)
            assert torch.equal(out[key][k][:, 0, :80], want)
            assert not out[key][k][:, 0, 80:].any()
            np.testing.assert_array_equal(out[key][k].numpy(),
                                          np.asarray(jout[key][k]))


#: hubert-xlarge's config (``repro/configs/hubert_xlarge.py``), as the
#: port's registry lists it
HUBERT = dict(name="hubert-xlarge", family="audio", n_layers=48,
              d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
              d_ff=5120, vocab=504, mlp="gelu", norm="layernorm",
              causal=False, use_rope=False, frontend="audio",
              frontend_dim=512, max_wavelength_pos=65536)


def test_engine_refuses_the_audio_family_as_the_reference():
    """A reduced hubert-xlarge config is refused by the engine before
    anything is built, with the JAX engine's error."""
    from repro.configs.base import ModelConfig as JModelConfig
    assert dataclasses.asdict(JModelConfig(**HUBERT)) \
        == dataclasses.asdict(jget_cfg("hubert-xlarge")) \
        == dataclasses.asdict(get_model_config("hubert-xlarge"))
    cfg = reduced(ModelConfig(**HUBERT))
    jcfg = jreduced(JModelConfig(**HUBERT))
    run = get_run_config("llama3.2-3b", compute_dtype="float32")
    jrun = jget_run("llama3.2-3b", compute_dtype="float32")
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jrun, JCtx(jrun, RULE_SETS[jrun.rules_name], None),
                     {})
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, run, Ctx(run, "cpu"), {})
    assert str(err.value) == str(jerr.value) \
        == "encoder-only arch has no decode path"
