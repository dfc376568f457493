"""The port's cache-free attention and its gradient on the CPU against the
JAX package.

The plain versions (``ref.attention_naive``/``attention_blockwise`` with
their log-sum-exp, ``attention_bwd_ref``) are held against the JAX oracles,
the Pallas ``flash_attention`` run in interpret mode, and ``jax.vjp`` of
the oracle, on the same seeded numpy inputs; ``ops.FlashAttention`` on
CPU tensors against ``torch.autograd`` of the plain forward.  The CUDA
kernels themselves are checked on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# f32 throughout: the same maths in another summation order
TOL = 1e-4
B, D = 2, 16

# (causal, local_window, softcap, G, Sq, Sk): GQA, window and softcap,
# odd lengths that are no multiple of the Pallas blocks, and Sq != Sk
CASES = [
    (True, None, None, 3, 24, 24),
    (True, 7, 5.0, 2, 37, 37),
    (False, None, None, 1, 20, 20),
    (False, None, 5.0, 2, 16, 29),
    (True, None, None, 2, 13, 29),
    (True, 20, None, 3, 29, 13),
]


def _case_id(c):
    causal, win, cap, g, sq, sk = c
    return (f"{'causal' if causal else 'bidir'}-w{win}-cap{cap}-g{g}-"
            f"{sq}x{sk}")


def _inputs(G, Sq, Sk, seed=0):
    rng = np.random.default_rng(seed)
    K = 2
    q = rng.standard_normal((B, Sq, K * G, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, K * G, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert tfa.flash_attention.launches == 0
    assert tfa.flash_attention_bwd.launches == 0


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forward_matches_jax_oracles_and_pallas(case):
    causal, win, cap, G, Sq, Sk = case
    q, k, v, _ = _inputs(G, Sq, Sk)
    kw = dict(causal=causal, local_window=win, softcap=cap)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = flash_attention(jq, jk, jv, block_q=8, block_kv=8,
                             interpret=True, **kw)
    want = np.asarray(jref.attention_naive(jq, jk, jv, **kw))
    np.testing.assert_allclose(np.asarray(pallas), want, atol=TOL)
    want_bw = np.asarray(jref.attention_blockwise(jq, jk, jv, block_kv=8,
                                                  **kw))
    tq, tk, tv = _t(q, k, v)
    naive = ref.attention_naive(tq, tk, tv, **kw).numpy()
    blockwise = ref.attention_blockwise(tq, tk, tv, block_kv=8, **kw).numpy()
    np.testing.assert_allclose(naive, want, atol=TOL)
    np.testing.assert_allclose(blockwise, want_bw, atol=TOL)
    np.testing.assert_allclose(blockwise, want, atol=TOL)
    out, lse = tfa.flash_attention(tq, tk, tv, **kw)      # CPU: plain
    np.testing.assert_allclose(out.numpy(), want, atol=TOL)
    assert lse.shape == (B, q.shape[2], Sq) and lse.dtype == torch.float32


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_lse_matches_jax_logsumexp(case):
    """The saved statistic, from both plain forwards: logsumexp of each
    row's visible, scaled, softcapped logits (the oracle's own masking)."""
    causal, win, cap, G, Sq, Sk = case
    q, k, _, _ = _inputs(G, Sq, Sk)
    K = k.shape[2]
    qf = jnp.asarray(q).reshape(B, Sq, K, G, D)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", qf, jnp.asarray(k)) * D ** -0.5
    logits = jref._softcap(logits, cap)
    mask = jref._mask(jnp.arange(Sq), jnp.arange(Sk), causal, win)
    want = jax.nn.logsumexp(jnp.where(mask, logits, jref.NEG_INF), axis=-1)
    tq, tk, tv = _t(q, k, k)
    kw = dict(causal=causal, local_window=win, softcap=cap, return_lse=True)
    for _, got in (ref.attention_naive(tq, tk, tv, **kw),
                   ref.attention_blockwise(tq, tk, tv, block_kv=8, **kw)):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want).reshape(B, K * G, Sq),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_backward_matches_jax_vjp(case):
    """attention_bwd_ref from the saved out and lse against jax.vjp of
    the oracle with the same numpy cotangent."""
    causal, win, cap, G, Sq, Sk = case
    q, k, v, do = _inputs(G, Sq, Sk, seed=1)
    kw = dict(causal=causal, local_window=win, softcap=cap)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_naive(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_attention(tq, tk, tv, **kw)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, **kw)
    for g_t, w_a in zip(got, want):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(w_a), atol=TOL)


@pytest.mark.parametrize("naive_below", [2049, 8],
                         ids=["naive", "blockwise"])
@pytest.mark.parametrize("case", CASES[:3], ids=_case_id)
def test_function_on_cpu_matches_autograd(case, naive_below):
    """``ops.attention`` (the autograd Function: plain forward, saved lse,
    ``attention_bwd_ref``) against torch.autograd through the plain
    forward, on both sides of the naive/blockwise split."""
    causal, win, cap, G, Sq, Sk = case
    q, k, v, do = _inputs(G, Sq, Sk, seed=2)
    kw = dict(causal=causal, local_window=win, softcap=cap)
    a = [t.requires_grad_() for t in _t(q, k, v)]
    b = [t.requires_grad_() for t in _t(q, k, v)]
    out = ops.attention(*a, naive_below=naive_below, **kw)
    want = ref.attention_naive(*b, **kw)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=TOL)
    g_got = torch.autograd.grad(out, a, torch.from_numpy(do))
    g_want = torch.autograd.grad(want, b, torch.from_numpy(do))
    for x, y in zip(g_got, g_want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=TOL)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach a wrapper's
    CUDA branch without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_branches_check_inputs_and_never_fall_back(monkeypatch):
    """On CUDA tensors the two wrappers validate their inputs, then build
    and launch the kernel or raise: with no nvcc they raise, and the
    plain versions are never taken."""
    q = torch.zeros((1, 8, 4, 32)).as_subclass(_OnCuda)
    kv = torch.zeros((1, 8, 2, 32)).as_subclass(_OnCuda)
    lse = torch.zeros((1, 4, 8)).as_subclass(_OnCuda)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q[..., :24], kv[..., :24], kv[..., :24])
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention(q[:, :, :3], kv, kv)
    with pytest.raises(TypeError, match="lse"):
        tfa.flash_attention_bwd(q, kv, kv, q, lse[:, :, :4], q)
    with pytest.raises(TypeError, match="dout"):
        tfa.flash_attention_bwd(q, kv, kv, q, lse, q.bfloat16())

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tfa.build, "library", no_nvcc)
    for name in ("attention_naive", "attention_blockwise",
                 "attention_bwd_ref"):
        monkeypatch.setattr(ref, name, None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_attention_bwd(q, kv, kv, q, lse, q)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.attention(q, kv, kv)


def test_kernel_sources_are_declared_and_hashed():
    """Both libraries are built by ``build_all`` and named by a hash of
    the source and the shared headers it includes."""
    from repro_torch.kernels import build
    for name in ("flash_attention", "flash_attention_bwd"):
        assert name in build.SIGNATURES
        srcs = [p.name for p in build.sources(name)]
        assert srcs[0] == f"{name}.cu"
        assert {"flash_attention.cuh", "hopper.cuh",
                "decode_attention.cuh"} <= set(srcs)


# ===========================================================================
# the bf16 kernels' numerics: P and dS go to the tensor cores in two parts
# ===========================================================================

# chip_smoke.py's per-entry rule for a bf16 output (ATTN_RTOL, ATTN_ATOL):
# one bf16 ulp of the entry plus 1e-5 of the largest entry
RULE_RTOL, RULE_ATOL = 2 ** -7, 1e-5

# (B, S, H, K, D, causal, local_window, softcap): the kernels' head dims,
# GQA, window + softcap without causality
RULE_CASES = [
    (1, 256, 4, 2, 64, True, None, None),
    (2, 128, 4, 2, 32, True, None, None),
    (1, 192, 4, 2, 32, False, 50, 5.0),
    (1, 128, 2, 1, 128, True, None, None),
]


def _rule_inputs(case, seed=3):
    B, S, H, K, D, causal, window, cap = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
        for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D), (B, S, H, D)))
    kw = dict(causal=causal, local_window=window, softcap=cap)
    out, lse = ref.attention_naive(q, k, v, return_lse=True, **kw)
    dq = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)[0]
    return (q, k, v, out, lse, do), kw, out, dq


def _over_rule(got, want):
    """Each entry's |got - want| over its limit: passes at <= 1."""
    got, want = got.float(), want.float()
    limit = RULE_RTOL * want.abs() + RULE_ATOL * want.abs().max()
    return (got - want).abs() / limit


def _rule_id(c):
    B, S, H, K, D, causal, window, cap = c
    return f"B{B}-S{S}-H{H}-K{K}-D{D}-{'causal' if causal else 'bidir'}-w{window}-cap{cap}"


@pytest.mark.parametrize("case", RULE_CASES, ids=_rule_id)
def test_p_and_ds_rounded_to_bf16_break_the_rule(case):
    """The shortcut a bf16 tensor-core product invites, P (and dS) rounded
    to bf16 once, puts entries of out and dq beyond one bf16 ulp of the
    plain f32 versions: the per-entry rule rejects it."""
    args, kw, out, dq = _rule_inputs(case)
    got_out, got_dq = ref.attention_tc_emulated(*args, parts=1, **kw)
    assert _over_rule(got_out, out).max() > 2
    assert _over_rule(got_dq, dq).max() > 2


@pytest.mark.parametrize("case", RULE_CASES, ids=_rule_id)
def test_p_and_ds_split_hi_lo_meet_the_rule(case):
    """P and dS as hi = bf16(x) and lo = bf16(x - hi), one f32 product per
    part (the kernels' design): every entry of out and dq within one bf16
    ulp of the plain versions."""
    args, kw, out, dq = _rule_inputs(case)
    got_out, got_dq = ref.attention_tc_emulated(*args, parts=2, **kw)
    assert _over_rule(got_out, out).max() <= 1
    assert _over_rule(got_dq, dq).max() <= 1


def test_bf16_parts_carry_x_to_two_to_the_minus_16():
    x = torch.from_numpy(np.random.default_rng(4).random(4096).astype(
        np.float32))
    hi, lo = ref.bf16_parts(x, 2)
    (one,) = ref.bf16_parts(x, 1)
    assert torch.equal(one, hi)
    assert torch.equal(hi, hi.bfloat16().float())
    assert torch.equal(lo, lo.bfloat16().float())
    assert ((hi + lo - x).abs() <= 2.0 ** -16 * x.abs()).all()
    assert ((hi - x).abs() > 2.0 ** -12 * x.abs()).any()

