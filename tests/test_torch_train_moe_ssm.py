"""MoE and Mamba-2 training in the port on the CPU against the JAX package:
the plain gradients of the expert product and of the chunked SSD
(``ref.grouped_matmul_bwd``, ``ref.ssd_chunked_bwd``: the plain versions
of the ``grouped_matmul_bwd`` and ``ssd_bwd`` kernels) against
``jax.vjp`` of the reference's plain functions and against torch autograd
through the port's own forward, the autograd Functions' CPU dispatch, and
reduced mamba2 and zamba2 trained two steps in f32 against JAX's
``make_train_step``.  The kernels themselves run on a card only
(``tests/test_torch_train_card.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro.train.step import init_state as jinit_state  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import grouped_matmul as tgmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import load_numpy_state  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# f32 gradients from the same inputs, other orders of summation: relative
# to the largest entry of each gradient (dA and dD sum every row of every
# chunk, whose terms cancel; ~1e-6 of max seen at these shapes)
GRAD_TOL = 2e-5
# bf16 gradients: both sides sum in f32 and round once, so they are equal
# or one bf16 ulp apart (2^-7 relative), plus the f32 order error
BF16_RTOL = 2 ** -7
# the train steps: as tests/test_torch_moe.py (metrics 1e-4 relative;
# parameters after two AdamW steps move by <= lr = 1e-3 times gradient
# ratios that agree to ~1e-6 between the packages)
F32_TOL = 1e-4
PARAM_TOL = 5e-6
RUN_KW = dict(logits_chunk=16, learning_rate=1e-3, warmup_steps=2,
              total_steps=10)


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _close(got, want, tol=GRAD_TOL, rtol=None):
    """|got - want| <= rtol |want| + tol max|want|, entry by entry."""
    got = got.detach().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if torch.is_tensor(want) \
        else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol if rtol is None else rtol,
                               atol=tol * np.abs(want).max())


# ===========================================================================
# grouped_matmul's gradient
# ===========================================================================

# (G, M, K, N, live rows per group or None): the reduced configs' expert
# shapes, odd and one-row capacities, rows past a group's live count zero
GMM_BWD_SHAPES = [(4, 64, 32, 48, None), (8, 5, 128, 256, None),
                  (8, 5, 256, 128, [5, 0, 3, 1, 5, 2, 4, 0]),
                  (2, 1, 16, 8, None), (3, 17, 24, 40, [17, 9, 0])]


def _gmm_inputs(G, M, K, N, live, seed):
    rng = np.random.default_rng(seed)
    lhs, rhs, dout = (rng.standard_normal(s).astype(np.float32)
                      for s in ((G, M, K), (G, K, N), (G, M, N)))
    if live is not None:
        dead = np.arange(M)[None] >= np.asarray(live)[:, None]
        lhs[dead] = 0
        dout[dead] = 0
    return lhs, rhs, dout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,M,K,N,live", GMM_BWD_SHAPES)
def test_grouped_matmul_bwd_matches_jax_and_autograd(G, M, K, N, live,
                                                     dtype):
    """dlhs = dout rhs^T and drhs = lhs^T dout against ``jax.vjp`` of
    ``grouped_matmul_ref`` and torch autograd through
    ``ref.grouped_matmul``; rows past a group's live count (zero in lhs
    and in the cotangent, as the MoE dispatch and combine leave them) get
    exactly zero dlhs."""
    lhs, rhs, dout = _gmm_inputs(G, M, K, N, live, G * M + K)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(jref.grouped_matmul_ref, jnp.asarray(lhs, jd),
                     jnp.asarray(rhs, jd))
    jgrads = vjp(jnp.asarray(dout, jd))
    tl, tr, td_out = (torch.from_numpy(a).to(td) for a in (lhs, rhs, dout))
    got = ref.grouped_matmul_bwd(tl, tr, td_out)
    a, b = tl.clone().requires_grad_(), tr.clone().requires_grad_()
    ref.grouped_matmul(a, b).backward(td_out)
    for g, jg, ag in zip(got, jgrads, (a.grad, b.grad)):
        assert g.dtype == td
        if dtype == "float32":
            _close(g, jg, 1e-6)
            _close(g, ag, 1e-6)
        else:
            _close(g, jg.astype(jnp.float32), 1e-5, rtol=BF16_RTOL)
            assert torch.equal(g, ag)      # the same ops in the same order
    if live is not None:
        dead = torch.from_numpy(np.arange(M)[None]
                                >= np.asarray(live)[:, None])
        assert (got[0][dead] == 0).all()


def test_grouped_matmul_function_dispatches_to_the_plain_gradient():
    """On the CPU the autograd Function runs ``ref.grouped_matmul`` and
    ``ref.grouped_matmul_bwd``, each gradient only where it is needed;
    without grad the wrapper is the plain forward."""
    lhs, rhs, dout = (torch.from_numpy(a)
                      for a in _gmm_inputs(4, 6, 16, 24, None, 3))
    want = ref.grouped_matmul_bwd(lhs, rhs, dout)
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    out = ops.grouped_matmul(a, b)
    assert type(out.grad_fn).__name__ == "GroupedMatmulBackward"
    assert torch.equal(out, ref.grouped_matmul(lhs, rhs))
    out.backward(dout)
    assert torch.equal(a.grad, want[0]) and torch.equal(b.grad, want[1])
    b = rhs.clone().requires_grad_()
    tgmm.grouped_matmul(lhs, b).backward(dout)
    assert torch.equal(b.grad, want[1])
    assert tgmm.grouped_matmul_bwd(lhs, rhs, dout, need_lhs=False)[0] is None
    with torch.no_grad():
        assert tgmm.grouped_matmul(lhs, b).grad_fn is None


# ===========================================================================
# ssd's gradient
# ===========================================================================

# (B, S, H, P, G, N, chunk): the reduced mamba2 and zamba2 layouts (H = 16
# heads of P = 16, N = 16 in one group, chunk 16), two groups, a chunk that
# is no power of two and chunk 1
SSD_BWD_SHAPES = [(2, 32, 16, 16, 1, 16, 16), (2, 48, 16, 16, 2, 16, 16),
                  (1, 36, 4, 8, 2, 8, 12), (2, 7, 4, 8, 2, 8, 1),
                  (1, 64, 8, 16, 1, 32, 64)]
# (h0, D, the final state's gradient)
SSD_BWD_OPTS = [(True, True, True), (False, False, False),
                (True, False, False), (False, True, True)]


def _ssd_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(
        np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, G, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dstate = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0, dy, dstate


def _jax_ssd_vjp(arrays, chunk, use_h0, use_D, use_ds):
    """jax.vjp of the reference's ssd_chunked, every input it is given."""
    x, dt, A, Bm, Cm, D, h0, dy, ds = (jnp.asarray(a) for a in arrays)
    names = ["x", "dt", "A", "B", "C"] + ["D"] * use_D + ["h0"] * use_h0

    def f(*args):
        kw = dict(zip(names, args))
        return jref.ssd_chunked(kw["x"], kw["dt"], kw["A"], kw["B"], kw["C"],
                                kw.get("D"), kw.get("h0"), chunk=chunk)

    ins = [x, dt, A, Bm, Cm] + [D] * use_D + [h0] * use_h0
    (y, st), vjp = jax.vjp(f, *ins)
    grads = vjp((dy, ds if use_ds else jnp.zeros_like(st)))
    return dict(zip(names, grads))


@pytest.mark.parametrize("use_h0,use_D,use_ds", SSD_BWD_OPTS)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_BWD_SHAPES)
def test_ssd_chunked_bwd_matches_jax_and_autograd(B, S, H, P, G, N, chunk,
                                                  use_h0, use_D, use_ds):
    """Every gradient (dx, ddt, dA, dB, dC, dD, dh0) of ``ssd_chunked``
    written out chunk by chunk, against ``jax.vjp`` of the reference's
    ``ssd_chunked`` and torch autograd through the port's, in f32; and in
    float64 against autograd to rounding (the algebra, exactly)."""
    arrays = _ssd_inputs(B, S, H, P, G, N, S + H + chunk)
    x, dt, A, Bm, Cm, D, h0, dy, ds = (torch.from_numpy(a) for a in arrays)
    D, h0, ds = (D if use_D else None, h0 if use_h0 else None,
                 ds if use_ds else None)
    got = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=chunk)
    names = ("x", "dt", "A", "B", "C", "D", "h0")
    jg = _jax_ssd_vjp(arrays, chunk, use_h0, use_D, use_ds)
    assert set(jg) == {n for n, g in zip(names, got) if g is not None}
    for n, g in zip(names, got):
        if g is not None:
            _close(g, jg[n])
    for dtype in (torch.float32, torch.float64):
        ins = [t.to(dtype).clone().requires_grad_() if t is not None
               else None for t in (x, dt, A, Bm, Cm, D, h0)]
        y, st = ref.ssd_chunked(*ins, chunk=chunk)
        loss = (y * dy.to(dtype)).sum()
        if ds is not None:
            loss = loss + (st * ds.to(dtype)).sum()
        loss.backward()
        want = [t.grad if t is not None else None for t in ins]
        mine = got if dtype == torch.float32 else ref.ssd_chunked_bwd(
            *(t.detach() if t is not None else None for t in ins),
            dy.double(), ds.double() if ds is not None else None,
            chunk=chunk)
        for n, g, w in zip(names, mine, want):
            assert (g is None) == (w is None), n
            if g is not None:
                assert g.dtype == w.dtype, n
                _close(g, w, GRAD_TOL if dtype == torch.float32 else 1e-12)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_BWD_SHAPES[:2])
def test_ssd_chunked_bwd_bf16_rounds_once(B, S, H, P, G, N, chunk):
    """bf16 inputs: every sum in f32, each gradient rounded once to its
    input's dtype (bf16 for dx, ddt, dB, dC; f32 for dA, dD, dh0): within
    one bf16 ulp of torch autograd in f32 through ``ssd_chunked`` on the
    same (bf16-valued) inputs, rounded once.  (Autograd through the bf16
    forward rounds dx and ddt twice: x and dt each reach the output by two
    casts, whose gradients are rounded to bf16 before they are added.)"""
    arrays = _ssd_inputs(B, S, H, P, G, N, 5)
    x, dt, A, Bm, Cm, D, h0, dy, ds = (torch.from_numpy(a) for a in arrays)
    x, dt, Bm, Cm, dy = (t.bfloat16() for t in (x, dt, Bm, Cm, dy))
    got = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=chunk)
    ins = [t.float().requires_grad_() for t in (x, dt, A, Bm, Cm, D, h0)]
    y, st = ref.ssd_chunked(*ins, chunk=chunk)
    ((y * dy.float()).sum() + (st * ds).sum()).backward()
    for g, t, orig in zip(got, ins, (x, dt, A, Bm, Cm, D, h0)):
        assert g.dtype == orig.dtype
        _close(g, t.grad.to(orig.dtype), GRAD_TOL,
               rtol=BF16_RTOL if g.dtype == torch.bfloat16 else GRAD_TOL)


def test_ssd_function_dispatches_to_the_plain_gradient():
    """On the CPU the autograd Function runs ``ref.ssd_chunked`` and
    ``ref.ssd_chunked_bwd``: the gradients given dy and the final state's
    gradient, given the final state's gradient alone (dy absent), and with
    ``state_out`` (an autograd-tracked copy into it)."""
    arrays = _ssd_inputs(2, 32, 4, 8, 2, 16, 9)
    x, dt, A, Bm, Cm, D, h0, dy, ds = (torch.from_numpy(a) for a in arrays)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D, h0)]
    y, st = ops.ssd(*ins, chunk=16)
    assert type(y.grad_fn).__name__ == "SSDBackward"
    want_y, want_st = ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0, chunk=16)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    ((y * dy).sum() + (st * ds).sum()).backward()
    want = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=16)
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w)
    # only the final state's gradient: dy is absent, taken as zero
    xs = x.clone().requires_grad_()
    _, st = tssd.ssd(xs, dt, A, Bm, Cm, D, h0, chunk=16)
    (st * ds).sum().backward()
    want = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, torch.zeros_like(x),
                               ds, chunk=16)
    assert torch.equal(xs.grad, want[0])
    # state_out under grad: the final state is copied into it, tracked
    xs = x.clone().requires_grad_()
    lane = torch.zeros_like(h0)
    y, out = tssd.ssd(xs, dt, A, Bm, Cm, D, h0, chunk=16, state_out=lane)
    assert out is lane and torch.equal(lane, want_st)
    ((y * dy).sum() + (out * ds).sum()).backward()
    want = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=16)
    assert torch.equal(xs.grad, want[0])
    with torch.no_grad():
        assert tssd.ssd(xs, dt, A, Bm, Cm, chunk=16)[0].grad_fn is None


@pytest.mark.parametrize("grad_on", ["h0", "x"])
def test_ssd_refuses_state_out_over_h0_under_grad(grad_on):
    """``state_out=h0`` (the serving cache's in-place write) under autograd
    raises a clear ValueError before anything is written, whether h0 is a
    leaf that requires grad or only x does (the backward reads h0); without
    grad the same call writes the final state over h0 in place."""
    arrays = _ssd_inputs(2, 32, 4, 8, 2, 16, 13)
    x, dt, A, Bm, Cm, D, h0, _, _ = (torch.from_numpy(a) for a in arrays)
    before = h0.clone()
    xs = x.clone().requires_grad_(grad_on == "x")
    h0s = h0.clone().requires_grad_(grad_on == "h0")
    with pytest.raises(ValueError, match="state_out must not share storage"):
        tssd.ssd(xs, dt, A, Bm, Cm, D, h0s, chunk=16, state_out=h0s)
    assert torch.equal(h0s.detach(), before)
    with torch.no_grad():
        _, out = tssd.ssd(xs, dt, A, Bm, Cm, D, h0s, chunk=16,
                          state_out=h0s)
    _, want_st = ref.ssd_chunked(x, dt, A, Bm, Cm, D, before, chunk=16)
    assert out is h0s and torch.equal(h0s.detach(), want_st)


# ===========================================================================
# reduced mamba2 and zamba2 trained against JAX
# ===========================================================================

def _batches(cfg, n):
    src = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=32,
                                 seed=11))
    return [src.batch(i) for i in range(n)]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_train_step_matches_jax_over_two_steps(arch, remat):
    """Reduced mamba2 and zamba2 in f32 from the JAX initial state, two
    AdamW steps through the Functions (``ssd`` and, in zamba2's shared
    block, ``flash_attention``) with and without remat: loss and grad norm
    per step, and the whole state after two steps, against JAX's
    ``make_train_step`` (the reference differentiates ``ssd_chunked``)."""
    jcfg = jreduced(jget_cfg(arch))
    jrun = jget_run(arch, remat="none", compute_dtype="float32", **RUN_KW)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jstate = jinit_state(jcfg, jrun, jax.random.PRNGKey(0)).tree()
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat=remat, compute_dtype="float32",
                         **RUN_KW)
    state = load_numpy_state(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jmake_step(jcfg, jrun, jctx))
    step = make_train_step(cfg, run, Ctx(run, "cpu"))
    for batch in _batches(cfg, 2):
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


def test_gradient_kernels_are_declared_hashed_and_counted():
    """Each gradient kernel is a library of its own, built from its source
    and the shared Hopper header (TMA, mbarriers, wgmma), with the C entry
    point's parameters as its declared argtypes, and its wrapper is among
    the counted kernels."""
    import re

    from repro_torch.kernels import build
    for name in ("grouped_matmul_bwd", "ssd_bwd"):
        fn, argtypes = build.SIGNATURES[name]
        assert fn == name
        assert [p.name for p in build.sources(name)] == [f"{name}.cu",
                                                         "hopper.cuh"]
        src = (build.CSRC / f"{name}.cu").read_text()
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           src).group(1)
        assert params.count(",") + 1 == len(argtypes)
    assert tgmm.grouped_matmul_bwd in tfa.KERNELS
    assert tssd.ssd_bwd in tfa.KERNELS
