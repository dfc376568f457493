"""The port's Mamba-2 slice on the CPU against the JAX package, on the same
numpy inputs and bridged weights: the plain SSD against the reference's
``ssd_chunked``, ``ssd_naive`` and the Pallas kernel (interpret mode), the
decode step, the Mamba block in its three modes, the mamba2 and zamba2
forwards with a cache, the serving engine's token streams (mamba2 dense,
zamba2 dense and paged, with slot reuse), the engine's refusals, the f32
leaves of ``prepare_params``, and the CUDA branch of the ``ssd`` wrapper
(on a card, the kernel against its plain version)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd as jssd  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, init_params,  # noqa: E402
                                       load_numpy_params, param_count)
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import chunk_plan  # noqa: E402

ARCHS = ["mamba2-370m", "zamba2-1.2b"]
# the plain SSD against the JAX package's ssd_chunked in f32: the same
# algorithm from the same inputs, summed in another order
CHUNKED_TOL = 1e-5
# against ssd_naive (a sequential scan) and the Pallas kernel: f32 1e-4;
# bf16 the reference's own 5e-2 (tests/test_kernels.py:262), which covers
# the Pallas wrapper's second rounding (y rounded, D added, rounded again)
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
F32_TOL = 1e-4        # model forward: same weights, other summation order
# the reference's SSD_SHAPES (tests/test_kernels.py:243-247) plus the
# reduced configs' (H = 2 * 128 / 16 = 16 heads of P = 16, N = 16, chunk 16)
SSD_SHAPES = [
    # B, S, H, P, G, N, chunk
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 96, 4, 16, 1, 32, 32),
    (1, 32, 16, 16, 1, 16, 16),
]


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _ssd_inputs(B, S, H, P, G, N, seed=0, with_h0=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, D, h0


def _both(arrays, dtype):
    """(jax arrays, torch tensors): x, dt, B, C in ``dtype``; A, D, h0 f32."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x, dt, A, Bm, Cm, D, h0 = arrays
    j = [jnp.asarray(x, jd), jnp.asarray(dt, jd), jnp.asarray(A),
         jnp.asarray(Bm, jd), jnp.asarray(Cm, jd),
         None if D is None else jnp.asarray(D),
         None if h0 is None else jnp.asarray(h0)]
    t = [torch.from_numpy(x).to(td), torch.from_numpy(dt).to(td),
         torch.from_numpy(A), torch.from_numpy(Bm).to(td),
         torch.from_numpy(Cm).to(td),
         None if D is None else torch.from_numpy(D),
         None if h0 is None else torch.from_numpy(h0)]
    return j, t


def _close(got, want, tol):
    """|got - want| <= tol |want| + tol max|want|: the same algorithm from
    the same inputs differs by f32 rounding relative to the largest terms
    it sums (the cumulative log-decays reach ~-40 within a chunk, so
    exp(a_cs[i] - a_cs[j]) carries their rounding), ~1.5e-6 of max|want|
    between the two packages' ssd_chunked at these shapes."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol * np.abs(want).max(), rtol=tol)


# ===========================================================================
# the plain SSD against the JAX package
# ===========================================================================

@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_D", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_jax(B, S, H, P, G, N, chunk, with_D, with_h0):
    arrays = list(_ssd_inputs(B, S, H, P, G, N, S + H, with_h0))
    if not with_D:
        arrays[5] = None
    (jx, jdt, jA, jB, jC, jD, jh0), (x, dt, A, Bm, Cm, D, h0) = \
        _both(arrays, "float32")
    jy, jst = jref.ssd_chunked(jx, jdt, jA, jB, jC, jD, jh0, chunk=chunk)
    y, st = ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    _close(y, jy, CHUNKED_TOL)
    _close(st, jst, CHUNKED_TOL)
    # the wrapper's CPU path is the plain version
    y2, st2 = ops.ssd(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0,with_D", [(False, True), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_naive_and_pallas(B, S, H, P, G, N, chunk,
                                            with_h0, with_D, dtype):
    arrays = list(_ssd_inputs(B, S, H, P, G, N, 7 * S + H, with_h0))
    if not with_D:
        arrays[5] = None
    (jx, jdt, jA, jB, jC, jD, jh0), (x, dt, A, Bm, Cm, D, h0) = \
        _both(arrays, dtype)
    y, st = ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    assert y.dtype == x.dtype and st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    jy, jst = jref.ssd_naive(jx, jdt, jA, jB, jC, jD, jh0)
    _close(y, jy, tol)
    _close(st, jst, tol)
    ky, kst = jssd(jx, jdt, jA, jB, jC, jD, jh0, chunk=chunk, interpret=True)
    _close(y, ky, tol)
    _close(st, kst, tol)
    ny, nst = ref.ssd_naive(x, dt, A, Bm, Cm, D, h0)
    _close(ny, jy, tol)
    _close(nst, jst, tol)


def test_ssd_state_out_may_be_h0():
    """The cache's in-place update: writing the final state over h0 gives
    what a fresh output would, and the chunked result equals one call per
    half with the state carried."""
    x, dt, A, Bm, Cm, D, h0 = (torch.from_numpy(a) if a is not None else a
                               for a in _ssd_inputs(1, 64, 4, 16, 1, 32, 3))
    y, st = ops.ssd(x, dt, A, Bm, Cm, D, h0, chunk=16)
    lane = h0.clone()
    y1, st1 = ops.ssd(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], D,
                      lane, chunk=16, state_out=lane)
    y2, st2 = ops.ssd(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], D,
                      lane, chunk=16, state_out=lane)
    assert st1 is lane and st2 is lane
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lane.numpy(), st.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_jax(G):
    B, H, P, N = 3, 4, 8, 16
    rng = np.random.default_rng(G)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x_t = rng.standard_normal((B, H, P)).astype(np.float32)
    dt_t = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    B_t = rng.standard_normal((B, G, N)).astype(np.float32)
    C_t = rng.standard_normal((B, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    jy, jst = jref.ssd_decode_step(*map(jnp.asarray, (state, x_t, dt_t, A,
                                                      B_t, C_t, D)))
    y, st = ref.ssd_decode_step(*map(torch.from_numpy, (state, x_t, dt_t, A,
                                                        B_t, C_t, D)))
    _close(y, jy, CHUNKED_TOL)
    _close(st, jst, CHUNKED_TOL)


# ===========================================================================
# the Mamba-2 block
# ===========================================================================

def _jax_side(arch, dtype="float32"):
    jcfg = jreduced(jget_cfg(arch))
    jrun = jget_run(arch, remat="none", compute_dtype=dtype)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    return jcfg, jrun, jctx, jparams


def _pair(arch, dtype="float32"):
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) on one weight
    set, reduced config."""
    jcfg, jrun, jctx, jparams = _jax_side(arch, dtype)
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat="none", compute_dtype=dtype)
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


@pytest.fixture(scope="module", params=ARCHS)
def f32_pair(request):
    return _pair(request.param)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_apply_mamba_three_modes_match_jax():
    """Cache-free; two prefill chunks into zero states (the second
    continues through the carried conv window and SSM state); one decode
    step.  Outputs and states in f32."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = _pair(ARCHS[0])
    jp = _layer(jparams["layers"]["mamba"], 1)
    p = {k: v[1] for k, v in params["layers"]["mamba"].items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jy, _ = jL.apply_mamba(jctx, jcfg, jp, jnp.asarray(x))
    y, _ = L.apply_mamba(ctx, cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL)

    jst = jL.empty_mamba_state(jcfg, 2, jnp.float32)
    st = L.empty_mamba_state(cfg, 2, torch.float32)
    jstate = (jst["ssm"], jst["conv"])
    for lo, hi in ((0, 16), (16, 24), (24, 25)):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) \
            if lo == 24 else x[:, lo:hi]
        jy, jstate = jL.apply_mamba(jctx, jcfg, jp, jnp.asarray(xs),
                                    ssm_state=jstate[0],
                                    conv_state=jstate[1])
        y, (s_ssm, s_conv) = L.apply_mamba(ctx, cfg, p, torch.from_numpy(xs),
                                           ssm_state=st["ssm"],
                                           conv_state=st["conv"])
        assert s_ssm is st["ssm"] and s_conv is st["conv"]     # in place
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL)
        np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jstate[0]),
                                   atol=F32_TOL)
        np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jstate[1]),
                                   atol=F32_TOL)
    # the two chunks reproduce the cache-free pass over all 24 rows
    full, _ = L.apply_mamba(ctx, cfg, p, torch.from_numpy(x))
    st2 = L.empty_mamba_state(cfg, 2, torch.float32)
    parts = [L.apply_mamba(ctx, cfg, p, torch.from_numpy(x[:, lo:hi]),
                           ssm_state=st2["ssm"], conv_state=st2["conv"])[0]
             for lo, hi in ((0, 16), (16, 24))]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(),
                               atol=F32_TOL)


@pytest.mark.parametrize("ssm_chunk,chunk", [(64, 37), (16, 1)])
def test_whole_prompt_prefill_of_a_prime_length_matches_jax(monkeypatch,
                                                            ssm_chunk, chunk):
    """A cache-free 37-row prefill: the largest divisor of 37 up to
    ``ssm_chunk`` is 37 itself (``ssm_chunk`` 64) or 1 (16), chunks that
    are no power of two.  The port's block equals the JAX
    package's in f32, and the SSD ran at that chunk."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = _pair(ARCHS[0])
    jcfg = dataclasses.replace(jcfg, ssm_chunk=ssm_chunk)
    cfg = dataclasses.replace(cfg, ssm_chunk=ssm_chunk)
    jp = _layer(jparams["layers"]["mamba"], 0)
    p = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    seen = []
    real_ssd = ops.ssd

    def spy(*args, chunk, **kw):
        seen.append(chunk)
        return real_ssd(*args, chunk=chunk, **kw)

    monkeypatch.setattr(ops, "ssd", spy)
    x = np.random.default_rng(7).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    jy, _ = jL.apply_mamba(jctx, jcfg, jp, jnp.asarray(x))
    y, _ = L.apply_mamba(ctx, cfg, p, torch.from_numpy(x))
    assert seen == [chunk]
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL)


def test_rmsnorm_gated_matches_jax():
    rng = np.random.default_rng(1)
    scale, y, z = (rng.standard_normal(s).astype(np.float32)
                   for s in ((32,), (2, 5, 32), (2, 5, 32)))
    want = jL.rmsnorm_gated(*map(jnp.asarray, (scale, y, z)))
    got = L.rmsnorm_gated(*map(torch.from_numpy, (scale, y, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_decls_mirror_the_reference(arch):
    assert dataclasses.asdict(get_model_config(arch)) \
        == dataclasses.asdict(jget_cfg(arch))
    assert dataclasses.asdict(get_run_config(arch)) \
        == dataclasses.asdict(jget_run(arch))
    for cut in (reduced, lambda c: c):
        cfg = cut(get_model_config(arch))
        jcfg = (jreduced if cut is reduced else (lambda c: c))(jget_cfg(arch))
        shapes = jax.tree.map(lambda pd: tuple(pd.shape), lm.model_decls(cfg),
                              is_leaf=lambda x: isinstance(x, PD))
        jshapes = jax.tree.map(lambda pd: tuple(pd.shape),
                               jlm.model_decls(jcfg),
                               is_leaf=lambda x: hasattr(x, "axes"))
        assert shapes == jshapes
    assert param_count(lm.model_decls(get_model_config(arch))) == {
        "mamba2-370m": 368_363_008, "zamba2-1.2b": 1_218_974_592}[arch]


def test_prepare_params_keeps_the_ssm_scalars_float32():
    """A_log, D, dt_bias and the gated norm stay f32 under bf16 compute
    (the reference reads them as f32 from its masters); the projections
    and the conv are cast."""
    cfg = reduced(get_model_config("zamba2-1.2b"))
    run = get_run_config("zamba2-1.2b")                  # bf16 compute
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    p = lm.prepare_params(Ctx(run, "cpu"), params)
    m = p["layers"]["mamba"]
    for key in ("A_log", "D", "dt_bias", "norm"):
        assert m[key].dtype == torch.float32, key
    for key in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert m[key].dtype == torch.bfloat16, key
    assert p["layers"]["ln"]["scale"].dtype == torch.float32
    assert p["shared"]["lora_a"].dtype == torch.bfloat16
    assert p["shared"]["attn"]["wq"].dtype == torch.bfloat16


# ===========================================================================
# the model forward
# ===========================================================================

def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def test_forward_and_logits_match_reference(f32_pair):
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = f32_pair
    toks = _tokens(2, 40, cfg.vocab)
    jh, _, _ = jlm.forward(jctx, jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    h, aux, _ = lm.forward(ctx, cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
    np.testing.assert_allclose(lm.logits_for(ctx, cfg, params, h).numpy(),
                               np.asarray(jlog), atol=F32_TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_steps_match_reference(f32_pair):
    """make_prefill_step (scalar index, 37 rows: odd, so chunk 37), then a
    scalar-index and a per-slot decode step with a done lane; the logits
    and every cache leaf after each."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    B, S, MAX = 3, 37, 64
    toks = _tokens(B, S, cfg.vocab)
    jpre = jengine.make_prefill_step(jcfg, jrun, jctx, MAX)
    jdec = jengine.make_decode_step(jcfg, jrun, jctx)
    params = lm.prepare_params(ctx, params)
    pre = engine.make_prefill_step(cfg, run, ctx, MAX)
    dec = engine.make_decode_step(cfg, run, ctx)

    def same_cache(cache, jcache):
        for key, leaves in cache.items():
            for k, a in leaves.items():
                np.testing.assert_allclose(a.numpy(),
                                           np.asarray(jcache[key][k]),
                                           atol=F32_TOL, err_msg=key + k)

    jcache, jlog = jpre(jparams, {"tokens": jnp.asarray(toks)})
    cache, log = pre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=F32_TOL)
    same_cache(cache, jcache)

    nxt = np.array(jnp.argmax(jlog[:, 0], -1), np.int32)[:, None]
    jcache, jlog = jdec(jparams, jcache, jnp.asarray(nxt),
                        jnp.asarray(S, jnp.int32))
    cache, log = dec(params, cache, torch.from_numpy(nxt), S)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=F32_TOL)

    idx = np.array([S + 1, S + 1, MAX], np.int32)      # last lane: done
    jcache, jlog = jdec(jparams, jcache, jnp.asarray(nxt), jnp.asarray(idx))
    cache, log = dec(params, cache, torch.from_numpy(nxt),
                     torch.from_numpy(idx))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=F32_TOL)
    same_cache(cache, jcache)


def test_chunked_prefill_equals_one_pass():
    """Reduced zamba2: the engine's per-slot prefill in chunks of 32, 4
    and 1 rows (the 1-row chunk takes the decode branch) gives the
    logits of one prefill pass over the 37 rows."""
    cfg = reduced(get_model_config("zamba2-1.2b"))
    run = get_run_config("zamba2-1.2b", remat="none", compute_dtype="float32")
    ctx = Ctx(run, "cpu")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_tokens(1, 37, cfg.vocab, seed=4))
    _, whole = engine.make_prefill_step(cfg, run, ctx, 64)(
        params, {"tokens": toks})
    cache = lm.init_cache(ctx, cfg, 2, 64)
    step = engine.make_prefill_chunk_step(cfg, run, ctx)
    idx = 0
    assert chunk_plan(37, 32) == [32, 4, 1]
    for size in chunk_plan(37, 32):
        cache, logits = step(params, cache, toks[:, idx:idx + size], 1, idx)
        idx += size
    np.testing.assert_allclose(logits.numpy(), whole[:, 0].numpy(),
                               atol=F32_TOL)
    assert not cache["mamba"]["ssm"][:, 0].any()         # slot 0 untouched


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_gives_the_same_loss_and_gradients(arch):
    """The checkpointed training forward (remat="full", each Mamba layer
    and shared block recomputed in the backward pass) gives the loss and
    gradients of remat="none" on the CPU's plain path."""
    from torch.utils import _pytree
    cfg = reduced(get_model_config(arch))
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(_tokens(2, 32, cfg.vocab, seed=3))
    out = []
    for remat in ("none", "full"):
        run = get_run_config(arch, remat=remat, compute_dtype="float32")
        ctx = Ctx(run, "cpu")
        leaves = [t.clone().requires_grad_()
                  for t in _pytree.tree_leaves(params)]
        p = _pytree.tree_unflatten(leaves, _pytree.tree_structure(params))
        h, _, _ = lm.forward(ctx, cfg, p, {"tokens": toks})
        loss = lm.logits_for(ctx, cfg, p, h).logsumexp(-1).mean()
        loss.backward()
        out.append((loss.detach(), [t.grad for t in leaves]))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ===========================================================================
# the serving engine
# ===========================================================================

def _reuse_reqs(cls=Request, n=7, seed=0):
    """More requests than slots, of mixed prompt lengths: slots are reused
    (so the state reset is exercised), lanes finish mid-chunk, and prompts
    longer than the prefill chunk of 32 cut into chunks of 32 (two SSD
    chunks of 16), 16, ..., 2 and 1 rows."""
    rng = np.random.default_rng(seed)
    lens = [37, 5, 21, 40, 3, 33, 14][:n]
    return [cls(uid=i, prompt=rng.integers(2, 500, lens[i]).tolist(),
                max_new_tokens=int(rng.integers(2, 12)))
            for i in range(n)]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


KW = dict(batch_size=3, max_seq=64, prefill_chunk=32, decode_chunk=4)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8)}


def test_the_workload_cuts_prompts_as_the_docstring_says():
    plans = [chunk_plan(len(r.prompt), KW["prefill_chunk"])
             for r in _reuse_reqs()]
    assert any(32 in p for p in plans) and any(1 in p for p in plans)
    assert len(plans) > KW["batch_size"]


@pytest.mark.parametrize("arch,mode", [("mamba2-370m", "dense"),
                                       ("zamba2-1.2b", "dense"),
                                       ("zamba2-1.2b", "paged")])
def test_token_streams_equal_the_jax_engine(arch, mode):
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = _pair(arch)
    jeng = JServeEngine(jcfg, jrun, jctx, jparams, **MODES[mode], **KW)
    want = _streams(jeng.generate(_reuse_reqs(JRequest)))
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    got = _streams(eng.generate(_reuse_reqs()))
    assert got == want
    assert {u: len(s) for u, s in got.items()} == {
        r.uid: r.max_new_tokens for r in _reuse_reqs()}
    if mode == "paged":
        assert eng._alloc.used_blocks == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba_paged_equals_dense_bit_for_bit(dtype):
    cfg = reduced(get_model_config("zamba2-1.2b"))
    run = get_run_config("zamba2-1.2b", remat="none", compute_dtype=dtype)
    ctx = Ctx(run, "cpu")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(1), "cpu")
    dense = ServeEngine(cfg, run, ctx, params, **KW)
    paged = ServeEngine(cfg, run, ctx, params, **MODES["paged"], **KW)
    dense.start(_reuse_reqs(seed=2))
    paged.start(_reuse_reqs(seed=2))
    while dense.pending or paged.pending:
        dense.step()
        paged.step()
        assert _streams(paged.finished) == _streams(dense.finished)
    assert len(paged.finished) == 7 and paged._alloc.used_blocks == 0


def test_admission_resets_the_slot_state(monkeypatch):
    """A request prefilled into a slot after others gets the first logits
    it gets alone in a fresh engine, bit for bit (the reset wipes the
    earlier requests' SSM and conv state); without the reset it does not.
    (Its tokens may well agree either way: the leaked state decays fast.)"""
    cfg = reduced(get_model_config("mamba2-370m"))
    run = get_run_config("mamba2-370m", remat="none", compute_dtype="float32")
    ctx = Ctx(run, "cpu")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(5), "cpu")
    kw = dict(batch_size=1, max_seq=64, prefill_chunk=16, decode_chunk=4)
    real_admit = engine._admit_step

    def first_logits(reqs):
        seen = []

        def admit(cur, index, rem, done, logits, *rest):
            seen.append(logits.clone())
            return real_admit(cur, index, rem, done, logits, *rest)

        with monkeypatch.context() as m:
            m.setattr(engine, "_admit_step", admit)
            ServeEngine(cfg, run, ctx, params, **kw).generate(reqs)
        return seen[-1]

    alone = first_logits(_reuse_reqs(n=3, seed=6)[2:])
    assert torch.equal(first_logits(_reuse_reqs(n=3, seed=6)), alone)
    cache = lm.init_cache(ctx, cfg, 3, 8)
    for a in cache["mamba"].values():
        a.fill_(1.0)
    engine._reset_state_slot(cache, 1)
    for a in cache["mamba"].values():
        assert not a[:, 1].any() and a[:, 0].all() and a[:, 2].all()
    monkeypatch.setattr(engine, "_reset_state_slot", lambda cache, slot: None)
    assert not torch.equal(first_logits(_reuse_reqs(n=3, seed=6)), alone)


def test_engine_refuses_what_the_reference_refuses():
    for arch, kw in (("mamba2-370m", dict(paged=True)),
                     ("zamba2-1.2b", dict(paged=True, prefix_sharing=True))):
        (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = _pair(arch)
        with pytest.raises(ValueError) as want:
            JServeEngine(jcfg, jrun, jctx, jparams, **kw, **KW)
        with pytest.raises(ValueError) as got:
            ServeEngine(cfg, run, ctx, params, **kw, **KW)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no sequence rows to page"):
        lm.init_paged_cache(ctx, reduced(get_model_config("mamba2-370m")),
                            2, 64, 8)


def test_caches_mirror_the_reference(f32_pair):
    (jcfg, _, jctx, _), (cfg, _, ctx, _) = f32_pair
    for got, want in ((lm.init_cache(ctx, cfg, 3, 64),
                       jlm.init_cache(jctx, jcfg, 3, 64)),) + ((
            (lm.init_paged_cache(ctx, cfg, 3, 64, 8),
             jlm.init_paged_cache(jctx, jcfg, 3, 64, 8)),)
            if cfg.family == "hybrid" else ()):
        assert set(got) == set(want)
        for key in got:
            g = got[key] if key == "block_tables" else got[key]
            w = want[key]
            if key == "block_tables":
                assert tuple(g.shape) == w.shape
                continue
            for k in g:
                assert tuple(g[k].shape) == w[k].shape, (key, k)
                assert str(g[k].dtype).split(".")[1] == str(w[k].dtype)
    assert lm.cache_slot_spec(cfg) == jlm.cache_slot_spec(jcfg)


def test_one_host_sync_per_decode_chunk():
    cfg = reduced(get_model_config("zamba2-1.2b"))
    run = get_run_config("zamba2-1.2b", remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, run, Ctx(run, "cpu"), params, batch_size=2,
                      max_seq=64, decode_chunk=4)
    fetches = []
    real_fetch = eng._fetch
    eng._fetch = lambda x: (fetches.append(1), real_fetch(x))[1]
    done = eng.generate([Request(uid=i, prompt=[1 + i, 2, 3],
                                 max_new_tokens=10) for i in range(2)])
    assert all(len(r.generated) == 10 for r in done)
    assert len(fetches) == 3 == eng.sync_count          # ceil(10 / 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--requests", "3", "--new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert out.count("3 tokens ->") == 3
    assert "[throughput] 9 tokens" in out and "on cpu" in out


# ===========================================================================
# the CUDA branch of the wrapper, and the build
# ===========================================================================

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach a wrapper's CUDA
    branch without a card."""

    @property
    def is_cuda(self):
        return True


class _OnCard(_OnCuda):
    """... that also reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_branch_checks_inputs_and_never_falls_back(monkeypatch):
    x, dt, A, Bm, Cm, D, h0 = (
        torch.from_numpy(a).as_subclass(_OnCuda)
        for a in _ssd_inputs(1, 64, 4, 16, 1, 32, 0))
    with pytest.raises(TypeError, match="dtypes"):
        tssd.ssd(x.half(), dt.half(), A, Bm.half(), Cm.half())
    with pytest.raises(TypeError, match="float32"):
        tssd.ssd(x, dt, A.double(), Bm, Cm)
    with pytest.raises(ValueError, match="shapes"):
        tssd.ssd(x, dt[:, :32], A, Bm, Cm)
    with pytest.raises(ValueError, match="h0 shape"):
        tssd.ssd(x, dt, A, Bm, Cm, D, h0[..., :16])
    for chunk in (0, 24, 256, 129, 128):            # 128 does not divide 64
        with pytest.raises(ValueError, match="from 1 to 128 that divides"):
            tssd.ssd(x, dt, A, Bm, Cm, chunk=chunk)
    with pytest.raises(ValueError, match="multiple of 32"):
        tssd.ssd(x, dt, A, Bm[..., :16].contiguous(),
                 Cm[..., :16].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm,
                 Cm, chunk=16)
    with pytest.raises(ValueError, match="is on cpu"):
        tssd.ssd(x.as_subclass(_OnCard), dt, A, Bm, Cm, chunk=16)
    # the backward's CUDA branch checks its inputs as the forward's does,
    # and dy and the final state's gradient
    dy = torch.zeros_like(x).as_subclass(_OnCuda)
    with pytest.raises(TypeError, match="dtypes"):
        tssd.ssd_bwd(x.half(), dt.half(), A, Bm.half(), Cm.half(), D, h0,
                     dy.half(), chunk=16)
    with pytest.raises(ValueError, match="from 1 to 128 that divides"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, chunk=24)
    with pytest.raises(ValueError, match="dy"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy[:, :32], chunk=16)
    with pytest.raises(ValueError, match="dy"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy.bfloat16(), chunk=16)
    with pytest.raises(ValueError, match="dstate"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, h0[..., :16], chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0,
                     dy.transpose(2, 3).contiguous().transpose(2, 3),
                     chunk=16)
    with pytest.raises(ValueError, match="is on cpu"):
        tssd.ssd_bwd(x.as_subclass(_OnCard), dt.as_subclass(_OnCard),
                     A.as_subclass(_OnCard), Bm.as_subclass(_OnCard),
                     Cm.as_subclass(_OnCard), D.as_subclass(_OnCard),
                     h0.as_subclass(_OnCard), dy, chunk=16)
    wide = [torch.zeros(shape).as_subclass(_OnCuda)
            for shape in ((1, 64, 2, 144), (1, 64, 2), (1, 64, 1, 32))]
    with pytest.raises(ValueError, match="P up to 128"):
        tssd.ssd_bwd(wide[0], wide[1], A[:2].contiguous(), wide[2], wide[2],
                     None, None, wide[0], chunk=16)

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tssd.build, "library", no_nvcc)
    monkeypatch.setattr(ref, "ssd_chunked", None)
    monkeypatch.setattr(ref, "ssd_chunked_bwd", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tssd.ssd(x, dt, A, Bm, Cm, D, h0, chunk=16, state_out=h0)
    # a call autograd differentiates launches the same forward kernel ...
    with pytest.raises(RuntimeError, match="nvcc"):
        tssd.ssd(x.clone().requires_grad_(), dt, A, Bm, Cm, chunk=16)
    # ... and the backward kernel, never the plain version
    with pytest.raises(RuntimeError, match="nvcc"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, chunk=16)
    with pytest.raises(RuntimeError, match="nvcc"):
        tssd.ssd_bwd(x, dt, A, Bm, Cm, None, None, dy, h0, chunk=16)
    # head_dim 64 (zamba2's attention) now reaches the decode kernels
    q = torch.zeros((2, 1, 4, 64)).as_subclass(_OnCuda)
    kc = torch.zeros((2, 16, 4, 64)).as_subclass(_OnCuda)
    kv_len = torch.full((2,), 3, dtype=torch.int32)
    table = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_decode(q, kc, kc, kv_len)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_decode_paged(q, kc.reshape(4, 8, 4, 64),
                               kc.reshape(4, 8, 4, 64), kv_len, table)
    with pytest.raises(ValueError, match="head_dim 48"):
        tfa.flash_decode(q[..., :48].contiguous(), kc[..., :48].contiguous(),
                         kc[..., :48].contiguous(), kv_len)
    assert tssd.ssd.launches == 0
    assert tssd.ssd_bwd.launches == 0


@pytest.mark.parametrize("S,chunk", [(148, 37), (131, 1), (64, 1),
                                     (128, 128)])
def test_cuda_branch_takes_any_chunk_that_divides_s(monkeypatch, S, chunk):
    """A whole-prompt prefill picks the largest divisor of S up to
    ``ssm_chunk``: 37 for S = 4 x 37, 1 for a prime S = 131.  The CUDA
    branch passes those to the kernel (here: to the build, which raises
    without nvcc) and still rejects 129 and a chunk that does not divide
    S."""
    x, dt, A, Bm, Cm, D, h0 = (
        torch.from_numpy(a).as_subclass(_OnCuda)
        for a in _ssd_inputs(1, S, 4, 16, 1, 32, 0))

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tssd.build, "library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        tssd.ssd(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    for bad in (129, chunk + 1 if S % (chunk + 1) else chunk + 2):
        with pytest.raises(ValueError, match="from 1 to 128 that divides"):
            tssd.ssd(x, dt, A, Bm, Cm, D, h0, chunk=bad)
    assert tssd.ssd.launches == 0


def test_kernel_source_is_declared_and_hashed():
    assert build.SIGNATURES["ssd"][0] == "ssd"
    assert len(build.SIGNATURES["ssd"][1]) == 18
    assert [p.name for p in build.sources("ssd")] == ["ssd.cu", "hopper.cuh"]
    assert tssd.ssd in tfa.KERNELS


@pytest.fixture
def card():
    """The card and its compiler, or a skip: decided here, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_its_plain_version_on_the_card(card, dtype):
    """The kernel against ``ref.ssd_chunked`` on the same card inputs,
    with h0 and D, at two chunks, and written over h0 in place: entry by
    entry within one bf16 ulp (f32: 1e-5 relative) plus 1e-5 of the
    largest entry, the rule ``chip_smoke.py`` applies."""
    torch.backends.cuda.matmul.allow_tf32 = False
    td = getattr(torch, dtype)
    x, dt, A, Bm, Cm, D, h0 = (
        torch.from_numpy(a).to(card) for a in _ssd_inputs(1, 256, 32, 64, 1,
                                                           128, 11))
    x, dt, Bm, Cm = (t.to(td) for t in (x, dt, Bm, Cm))
    want_y, want_s = ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=128)
    lane = h0.clone()
    got_y, got_s = tssd.ssd(x, dt, A, Bm, Cm, D, lane, chunk=128,
                            state_out=lane)
    torch.cuda.synchronize()
    rtol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    for got, want in ((got_y, want_y), (got_s, want_s)):
        limit = rtol * want.float().abs() + 1e-5 * want.float().abs().max()
        assert ((got.float() - want.float()).abs() <= limit).all()
    assert tssd.ssd.launches == 1
    tssd.ssd.launches = 0
