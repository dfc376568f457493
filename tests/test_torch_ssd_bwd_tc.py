"""The bf16 ``ssd_bwd`` kernels' numerics on the CPU, against the JAX package.

``ref.ssd_bwd_tc_emulated`` is the tensor-core gradient's arithmetic: the
products of two bf16 inputs (C B^T, dy x^T) exact, and every f32 operand
the kernels hand to the tensor cores -- x o wd and exp(a_cs) dy for each
chunk's state and its gradient, the entering state h_prev and the leaving
gradient dh_next, S o L and dS -- as bf16 parts.  At mamba2's and
zamba2's heads (Bb 1, S 256, chunk 128: the state and its gradient cross
a chunk boundary), with and without h0, D and the final state's gradient,
two parts meet the per-entry rules ``chip_smoke.py`` holds the kernels to
(dx, ddt, dB, dC: one bf16 ulp; dA, dD, dh0: the float32 sums' rule)
against the port's ``ref.ssd_chunked_bwd`` in float64 and ``jax.vjp`` of
the JAX ``ssd_chunked``; one part (the shortcut) breaks them.  The CUDA
kernels themselves are checked on the card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# chip_smoke.py's per-entry rules, |got - want| <= RTOL |want| + ATOL
# max|want|: the gradients in the inputs' dtype (bf16) within one bf16 ulp,
# the float32 sums dA, dD, dh0 by SSD_BWD_F32_RTOL / SSD_BWD_F32_ATOL
RULE = {"bf16": (2 ** -7, 1e-5), "f32": (1e-5, 1e-4)}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
KIND = {"dx": "bf16", "ddt": "bf16", "dB": "bf16", "dC": "bf16",
        "dA": "f32", "dD": "f32", "dh0": "f32"}

#: (H, P, N) of each Mamba-2 model's heads (G = 1)
HEADS = {"mamba2": (32, 64, 128), "zamba2": (64, 64, 64)}
#: (h0, D, the final state's gradient): the training arms' case (D only)
#: and every input given
OPTS = {"train": (False, True, False), "all": (True, True, True)}
S, Q = 256, 128


@functools.lru_cache(maxsize=None)
def _inputs(model):
    """x, dt, B, C, dy bf16-valued and A, D, h0, dstate float32, from a
    seeded numpy draw; dt = softplus(N(-3, 1)), the models' scale."""
    H, P, N = HEADS[model]
    rng = np.random.default_rng(H + N)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()  # noqa
    return {
        "x": bf(rng.standard_normal((1, S, H, P))),
        "dt": bf(np.log1p(np.exp(rng.standard_normal((1, S, H)) - 3.0))),
        "A": torch.from_numpy((-np.exp(0.5 * rng.standard_normal(H)))
                              .astype(np.float32)),
        "B": bf(rng.standard_normal((1, S, 1, N))),
        "C": bf(rng.standard_normal((1, S, 1, N))),
        "D": torch.from_numpy(rng.standard_normal(H).astype(np.float32)),
        "h0": torch.from_numpy(rng.standard_normal((1, H, P, N))
                               .astype(np.float32)),
        "dy": bf(rng.standard_normal((1, S, H, P))),
        "dstate": torch.from_numpy(rng.standard_normal((1, H, P, N))
                                   .astype(np.float32))}


def _args(model, opt):
    a = _inputs(model)
    use_h0, use_D, use_ds = OPTS[opt]
    return (a["x"], a["dt"], a["A"], a["B"], a["C"],
            a["D"] if use_D else None, a["h0"] if use_h0 else None, a["dy"],
            a["dstate"] if use_ds else None)


@functools.lru_cache(maxsize=None)
def _want(reference, model, opt):
    """The gradients of ``reference`` on the seeded inputs, each in its
    input's dtype: the port's plain version summing in float64 and
    rounding once (a float32 reference moves with the host's BLAS), or
    ``jax.vjp`` of the JAX ``ssd_chunked`` in f32 on the bf16-valued
    inputs, rounded once."""
    args = _args(model, opt)
    if reference == "torch":
        got = ref.ssd_chunked_bwd(*(t.double() if t is not None else None
                                    for t in args), chunk=Q)
    else:
        x, dt, A, B, C, D, h0, dy, ds = (
            None if t is None else jnp.asarray(t.float().numpy())
            for t in args)
        names = ["x", "dt", "A", "B", "C"] + ["D"] * (D is not None) \
            + ["h0"] * (h0 is not None)

        def f(*ins):
            kw = dict(zip(names, ins))
            return jref.ssd_chunked(kw["x"], kw["dt"], kw["A"], kw["B"],
                                    kw["C"], kw.get("D"), kw.get("h0"),
                                    chunk=Q)

        ins = [a for a in (x, dt, A, B, C, D, h0) if a is not None]
        (_, st), vjp = jax.vjp(f, *ins)
        g = dict(zip(names, vjp((dy, ds if ds is not None
                                 else jnp.zeros_like(st)))))
        got = [torch.from_numpy(np.array(g[n])) if n in g else None
               for n in ("x", "dt", "A", "B", "C", "D", "h0")]
    dtypes = [t.dtype if t is not None else None for t in args[:7]]
    return tuple(w.to(d) if w is not None else None
                 for w, d in zip(got, dtypes))


def _worst_over_rule(reference, model, opt, parts):
    """Each gradient's worst entry of the emulation over its limit."""
    got = ref.ssd_bwd_tc_emulated(*_args(model, opt), chunk=Q, parts=parts)
    worst = {}
    for n, g, w in zip(NAMES, got, _want(reference, model, opt)):
        assert (g is None) == (w is None), n
        if g is None:
            continue
        assert g.dtype == w.dtype, n
        rtol, atol = RULE[KIND[n]]
        g, w = g.float(), w.float()
        limit = rtol * w.abs() + atol * w.abs().max()
        worst[n] = ((g - w).abs() / limit.clamp(min=1e-30)).max().item()
    return worst


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("model", list(HEADS))
@pytest.mark.parametrize("reference", ["torch", "jax"])
def test_ssd_bwd_split_hi_lo_meets_the_rules(reference, model, opt):
    """The six f32 operands as hi = bf16(v) and lo = bf16(v - hi), one f32
    product each (the kernels' design): every gradient within its rule."""
    worst = _worst_over_rule(reference, model, opt, parts=2)
    assert max(worst.values()) <= 1, worst


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("model", list(HEADS))
@pytest.mark.parametrize("reference", ["torch", "jax"])
def test_ssd_bwd_operands_rounded_to_bf16_break_the_rules(reference, model,
                                                          opt):
    """The same operands rounded to bf16 once put dx, ddt, dB, dC and dA
    (and dh0, where h0 is given) far beyond their rules: the per-entry
    rules reject the shortcut."""
    worst = _worst_over_rule(reference, model, opt, parts=1)
    flagged = {n for n, v in worst.items() if v > 2}
    assert {"dx", "ddt", "dA", "dB", "dC"} <= flagged, worst
    assert "dh0" not in worst or "dh0" in flagged, worst


def test_the_gradient_emulation_with_exact_operands_is_the_plain_version():
    """With three parts each operand is carried to ~2^-24 of itself, and
    the emulation is the plain ``ssd_chunked_bwd`` up to f32 summation
    order: the state pass, the chunk pass and the reductions over heads
    are the same function."""
    args = [t.float() if t is not None else None
            for t in _args("zamba2", "all")]
    got = ref.ssd_bwd_tc_emulated(*args, chunk=Q, parts=3)
    want = ref.ssd_chunked_bwd(*args, chunk=Q)
    for n, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item(),
                                   err_msg=n)
