"""qwen2-vl-72b in the port on the CPU against the JAX package, on the same
numpy weights: the config copy and its declarations, M-RoPE's cos/sin on a
3-D grid of positions (and plain RoPE's, bit for bit, when the three rows
are equal), the reduced decoder's logits with ``vision_embeds`` merged
into the leading rows and (3, B, S) positions, two AdamW steps against
JAX's ``make_train_step``, ``make_prefill_step`` and ``make_decode_step``
against the reference's, the f32 greedy streams of the serving engine
(dense and paged, and paged == dense) against the JAX engine's, and a
slot drained and restored."""

import dataclasses

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
from repro.serving.engine import make_decode_step as jmake_decode  # noqa: E402
from repro.serving.engine import make_prefill_step as jmake_prefill  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro.train.step import init_state as jinit_state  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import qwen2_vl_72b  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS,  # noqa: E402
                                          get_model_config, get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, load_numpy_params,  # noqa: E402
                                       load_numpy_state, param_count)
from repro_torch.serving.engine import (Request, ServeEngine,  # noqa: E402
                                        make_decode_step, make_prefill_step)
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "qwen2-vl-72b"
# full-size parameter count, from the declarations: ~72.7 B; 20 of its 80
# layers (what one card serves) ~20.0 B
PARAMS = 72_705_384_448
PARAMS_20 = 20_044_914_688
F32_TOL = 1e-4        # model forward: same weights, other summation order
ROPE_TOL = 1e-6       # cos/sin of the same f32 angles, two libraries
PARAM_TOL = 5e-6      # as tests/test_torch_remat.py
RUN_KW = dict(logits_chunk=16, learning_rate=1e-3, warmup_steps=2,
              total_steps=10)
B, S = 2, 32          # tests/test_models.py's batch
KW = dict(batch_size=3, max_seq=96, prefill_chunk=16, decode_chunk=4)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8)}


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


@pytest.fixture(scope="module")
def f32_pair():
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) on one f32 weight
    set of the reduced config (M-RoPE sections (4, 6, 6))."""
    jcfg = jreduced(jget_cfg(ARCH))
    jrun = jget_run(ARCH, remat="none", compute_dtype="float32")
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none", compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


def grid_positions(batch, n_vision, grid_w, seq):
    """(3, batch, seq) M-RoPE positions: ``n_vision`` patch rows on a grid
    ``grid_w`` wide at (t 0, h i, w j), then text at max(h, w) + 1 + k in
    all three sections."""
    pos = np.zeros((3, seq), np.int32)
    r = np.arange(n_vision)
    pos[1, :n_vision], pos[2, :n_vision] = r // grid_w, r % grid_w
    start = int(pos[:, :n_vision].max()) + 1 if n_vision else 0
    pos[:, n_vision:] = start + np.arange(seq - n_vision)
    return np.broadcast_to(pos[:, None], (3, batch, seq)).copy()


def _vlm_batch(cfg, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq),
                                   dtype=np.int32),
            "vision_embeds": rng.standard_normal(
                (batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32),
            "positions": grid_positions(batch, cfg.vision_tokens, 4, seq)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_config_and_decls_mirror_the_reference():
    """The copy equals the reference's config, full and reduced, with the
    same RUN_OVERRIDES and the same declared shapes; the parameter count
    of the full model and of the 20 layers the card serves."""
    assert ARCH in ARCH_IDS
    assert "A copy of" in qwen2_vl_72b.__doc__
    assert dataclasses.asdict(get_run_config(ARCH)) \
        == dataclasses.asdict(jget_run(ARCH))
    for red in (False, True):
        cfg, jcfg = get_model_config(ARCH), jget_cfg(ARCH)
        if red:
            cfg, jcfg = reduced(cfg), jreduced(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        shapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init),
                              lm.model_decls(cfg),
                              is_leaf=lambda x: isinstance(x, PD))
        jshapes = jax.tree.map(lambda pd: (tuple(pd.shape), pd.init),
                               jlm.model_decls(jcfg),
                               is_leaf=lambda x: hasattr(x, "axes"))
        assert shapes == jshapes
    cfg = get_model_config(ARCH)
    assert cfg.mrope_sections == (16, 24, 24)
    assert reduced(cfg).mrope_sections == (4, 6, 6)
    assert param_count(lm.model_decls(cfg)) == PARAMS
    assert param_count(lm.model_decls(
        dataclasses.replace(cfg, n_layers=20))) == PARAMS_20


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
def test_mrope_cos_sin_match_jax_on_a_3d_grid(red):
    """cos/sin of a vision grid (32 x 32 patches at (0, i, j)) followed by
    text positions, against the reference's ``rope_cos_sin``; each section
    reads its own row (a changed h row moves only the h section)."""
    cfg, jcfg = get_model_config(ARCH), jget_cfg(ARCH)
    if red:
        cfg, jcfg = reduced(cfg), jreduced(jcfg)
    pos = grid_positions(2, 1024, 32, 1100)
    cos, sin = L.rope_cos_sin(cfg, torch.from_numpy(pos))
    jcos, jsin = jL.rope_cos_sin(jcfg, jnp.asarray(pos))
    half = cfg.head_dim // 2
    assert cos.shape == (2, 1100, half) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=ROPE_TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=ROPE_TOL)
    t, h, _ = cfg.mrope_sections
    moved = pos.copy()
    moved[1] += 3
    cos2, _ = L.rope_cos_sin(cfg, torch.from_numpy(moved))
    assert torch.equal(cos2[..., :t], cos[..., :t])
    assert torch.equal(cos2[..., t + h:], cos[..., t + h:])
    assert not torch.equal(cos2[..., t:t + h], cos[..., t:t + h])


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
def test_broadcast_positions_give_plain_rope_bit_for_bit(red):
    """Three equal position rows give plain RoPE's cos/sin bit for bit
    (the engine's decode and prefill, which pass no positions, rely on
    it); the model's default positions are those three rows."""
    cfg = get_model_config(ARCH)
    if red:
        cfg = reduced(cfg)
    plain = dataclasses.replace(cfg, mrope_sections=None)
    pos = torch.arange(3000, dtype=torch.int32)[None].expand(2, 3000) \
        + torch.tensor([[0], [517]], dtype=torch.int32)
    cos, sin = L.rope_cos_sin(cfg, pos[None].expand(3, 2, 3000))
    pcos, psin = L.rope_cos_sin(plain, pos)
    assert torch.equal(cos, pcos) and torch.equal(sin, psin)
    with pytest.raises(ValueError, match="M-RoPE"):
        L.rope_cos_sin(cfg, pos)


def test_decoder_logits_match_jax_with_vision_rows(f32_pair):
    """The reduced decoder on a batch whose first 16 rows are
    ``vision_embeds`` at grid positions: hidden state and logits against
    the reference's; the embeddings and the 3-D positions both take part,
    and without them the default positions are plain RoPE's (the same
    logits as broadcast 1-D positions)."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = f32_pair
    batch = _vlm_batch(cfg)
    jh, _, _ = jlm.forward(jctx, jcfg, jparams, _j(batch))
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    h, _, _ = lm.forward(ctx, cfg, params, _t(batch))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
    np.testing.assert_allclose(lm.logits_for(ctx, cfg, params, h).numpy(),
                               np.asarray(jlog), atol=F32_TOL)
    for drop in ("vision_embeds", "positions"):
        other = {k: v for k, v in batch.items() if k != drop}
        h2, _, _ = lm.forward(ctx, cfg, params, _t(other))
        assert (h2 - h).abs().max() > 1e-3, drop
    bare = {"tokens": batch["tokens"]}
    h3, _, _ = lm.forward(ctx, cfg, params, _t(bare))
    flat = dict(bare, positions=np.ascontiguousarray(np.broadcast_to(
        np.arange(S, dtype=np.int32), (3, B, S))))
    h4, _, _ = lm.forward(ctx, cfg, params, _t(flat))
    assert torch.equal(h3, h4)
    jh3, _, _ = jlm.forward(jctx, jcfg, jparams, _j(bare))
    np.testing.assert_allclose(h3.numpy(), np.asarray(jh3), atol=F32_TOL)


def test_two_adamw_steps_match_jax():
    """Two AdamW steps of the reduced decoder in f32 from JAX's initial
    state, on tests/test_models.py's vlm batch (vision embeddings, 3-D
    positions, labels): loss and grad norm per step, then every parameter
    and optimizer moment."""
    jcfg = jreduced(jget_cfg(ARCH))
    jrun = jget_run(ARCH, remat="full", compute_dtype="float32", **RUN_KW)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jstate = jinit_state(jcfg, jrun, jax.random.PRNGKey(0)).tree()
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="full", compute_dtype="float32",
                         **RUN_KW)
    state = load_numpy_state(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jmake_step(jcfg, jrun, jctx))
    step = make_train_step(cfg, run, Ctx(run, "cpu"))
    for i in range(2):
        batch = _vlm_batch(cfg, seed=20 + i)
        batch["labels"] = np.random.default_rng(30 + i).integers(
            0, cfg.vocab, (B, S), dtype=np.int32)
        jstate, jm = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
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


def test_prefill_and_decode_steps_match_the_reference(f32_pair):
    """``make_prefill_step`` on a vision batch (embeddings and grid
    positions), then three ``make_decode_step`` steps whose M-RoPE
    positions are the index broadcast to (3, B, 1), as the reference's;
    also a per-slot (B,) index, each slot at its own position."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    batch = _vlm_batch(cfg, seed=5)
    jcache, jlog = jmake_prefill(jcfg, jrun, jctx, 64)(jparams, _j(batch))
    cache, logits = make_prefill_step(cfg, run, ctx, 64)(params, _t(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=F32_TOL)
    jdecode = jmake_decode(jcfg, jrun, jctx)
    decode = make_decode_step(cfg, run, ctx)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (3, B, 1),
                                             dtype=np.int32)
    for i in range(3):
        jcache, jl = jdecode(jparams, jcache, jnp.asarray(toks[i]),
                             jnp.asarray(S + i, jnp.int32))
        cache, lo = decode(params, cache, torch.from_numpy(toks[i]), S + i)
        np.testing.assert_allclose(lo.numpy(), np.asarray(jl), atol=F32_TOL)
    # per-slot positions: slot b at S + 3 + b, each alone as the reference
    idx = torch.tensor([S + 3, S + 4], dtype=torch.int32)
    _, lo = decode(params, cache, torch.from_numpy(toks[0]), idx)
    for b in range(B):
        sub = tree_slot(jcache, b)
        _, jl = jdecode(jparams, sub, jnp.asarray(toks[0][b:b + 1]),
                        jnp.asarray(S + 3 + b, jnp.int32))
        np.testing.assert_allclose(lo[b:b + 1].numpy(), np.asarray(jl),
                                   atol=F32_TOL)


def tree_slot(cache, b):
    """Slot ``b`` of a JAX (layers, B, ...) cache, batch 1."""
    return jax.tree.map(lambda a: a[:, b:b + 1], cache)


def _reqs(cls):
    rng = np.random.default_rng(4)
    return [cls(uid=i, prompt=rng.integers(1, 500, n).tolist(),
                max_new_tokens=int(rng.integers(3, 10)))
            for i, n in enumerate([20, 7, 45, 33, 12])]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_streams_equal_the_jax_engine(f32_pair, mode):
    """f32 greedy token streams of the port's engine (chunked prefill,
    continuous batching, slots reused; M-RoPE over the default positions)
    equal the JAX engine's, dense and paged; paged equal dense."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    jeng = JServeEngine(jcfg, jrun, jctx, jparams, **MODES[mode], **KW)
    want = _streams(jeng.generate(_reqs(JRequest)))
    got = _streams(ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
                   .generate(_reqs(Request)))
    assert got == want
    assert {u: len(s) for u, s in got.items()} == {
        r.uid: r.max_new_tokens for r in _reqs(Request)}
    if mode == "paged":
        dense = ServeEngine(cfg, run, ctx, params, **KW)
        assert _streams(dense.generate(_reqs(Request))) == got


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_drain_and_restore_equal_staying_put(f32_pair, paged):
    """A vlm engine drained mid-decode (its ``kv`` rows exported per slot)
    and restored into another engine finishes with the streams of an
    engine that was never drained."""
    _, (cfg, run, ctx, params) = f32_pair
    mode = MODES["paged" if paged else "dense"]
    assert lm.cache_slot_spec(cfg) == {"kv": "rows"}
    want = _streams(ServeEngine(cfg, run, ctx, params, **mode, **KW)
                    .generate(_reqs(Request)))
    src = ServeEngine(cfg, run, ctx, params, **mode, **KW)
    src.start(_reqs(Request))
    src.step()
    snaps = src.drain()
    assert any(s.warm for s in snaps)
    dst = ServeEngine(cfg, run, ctx, params, **mode, **KW)
    dst.restore(snaps)
    while dst.pending:
        dst.step()
    assert _streams(src.finished + dst.finished) == want
