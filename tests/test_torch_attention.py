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



# ===========================================================================
# the query offset: a sequence-parallel rank's rows over keys from row 0
# ===========================================================================

# (causal, local_window, softcap, G, S, offset, Sq): query rows [o, o + Sq)
# of a sequence of S, over keys [0, o + Sq) when causal (the gathered rows
# a rank of the sequence-parallel forward sees) and all S otherwise
OFFSET_CASES = [
    (True, None, None, 2, 48, 16, 16),
    (True, 7, 5.0, 3, 40, 24, 16),
    (True, 9, None, 1, 33, 11, 11),
    (False, 9, 5.0, 2, 30, 10, 10),
]


def _offset_id(c):
    causal, win, cap, g, S, o, sq = c
    return (f"{'causal' if causal else 'bidir'}-w{win}-cap{cap}-g{g}-"
            f"rows{o}-{o + sq}of{S}")


def _offset_inputs(case, seed=5):
    """The whole sequence's q, k, v, dout, and the rank's slices: its query
    rows and cotangent, and the key rows it attends over."""
    causal, win, cap, G, S, o, Sq = case
    q, k, v, do = _inputs(G, S, S, seed)
    Sk = o + Sq if causal else S
    return (q, k, v, do), (q[:, o:o + Sq], k[:, :Sk], v[:, :Sk],
                           do[:, o:o + Sq])


@pytest.mark.parametrize("case", OFFSET_CASES, ids=_offset_id)
def test_offset_forward_is_the_sliced_rows_of_the_jax_oracle(case):
    """With ``q_offset=o`` the plain forwards (and the wrapper's CPU path)
    on the rank's rows equal rows [o, o + Sq) of the JAX oracle over the
    whole sequence, out and lse."""
    causal, win, cap, G, S, o, Sq = case
    (q, k, v, _), (qs, ks, vs, _) = _offset_inputs(case)
    kw = dict(causal=causal, local_window=win, softcap=cap)
    want = np.asarray(jref.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw))[:, o:o + Sq]
    _, want_lse = ref.attention_naive(*_t(q, k, v), return_lse=True, **kw)
    tq, tk, tv = _t(qs, ks, vs)
    for out, lse in (ref.attention_naive(tq, tk, tv, return_lse=True,
                                         q_offset=o, **kw),
                     ref.attention_blockwise(tq, tk, tv, block_kv=8,
                                             return_lse=True, q_offset=o,
                                             **kw),
                     tfa.flash_attention(tq, tk, tv, q_offset=o, **kw)):
        np.testing.assert_allclose(out.numpy(), want, atol=TOL)
        np.testing.assert_allclose(lse.numpy(),
                                   want_lse[:, :, o:o + Sq].numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", OFFSET_CASES, ids=_offset_id)
def test_offset_backward_matches_jax_vjp(case):
    """``flash_attention_bwd`` (CPU: ``attention_bwd_ref``) at ``q_offset``
    and ``ops.attention``'s autograd against ``jax.vjp`` of the oracle over
    the whole sequence with the rank's query rows as the variable (the
    other rows zero, their outputs cut away)."""
    causal, win, cap, G, S, o, Sq = case
    _, (qs, ks, vs, dos) = _offset_inputs(case, seed=6)
    kw = dict(causal=causal, local_window=win, softcap=cap)
    Sk = ks.shape[1]

    def oracle(qq, kk, vv):
        full = jnp.zeros((B, Sk) + qq.shape[2:], qq.dtype)
        full = full.at[:, o:o + Sq].set(qq)
        return jref.attention_naive(full, kk, vv, **kw)[:, o:o + Sq]

    _, vjp = jax.vjp(oracle, jnp.asarray(qs), jnp.asarray(ks),
                     jnp.asarray(vs))
    want = vjp(jnp.asarray(dos))
    tq, tk, tv, tdo = _t(qs, ks, vs, dos)
    out, lse = tfa.flash_attention(tq, tk, tv, q_offset=o, **kw)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, q_offset=o,
                                  **kw)
    a = [t.requires_grad_() for t in _t(qs, ks, vs)]
    y = ops.attention(*a, q_offset=o, **kw)
    auto = torch.autograd.grad(y, a, tdo)
    for g_t, g_a, w_a in zip(got, auto, want):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(w_a), atol=TOL)
        np.testing.assert_allclose(g_a.numpy(), np.asarray(w_a), atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_offset_zero_is_bit_for_bit_the_call_without_it(case):
    """``q_offset=0`` gives every plain version's output bit for bit as the
    call without the argument."""
    causal, win, cap, G, Sq, Sk = case
    q, k, v, do = _t(*_inputs(G, Sq, Sk, seed=7))
    kw = dict(causal=causal, local_window=win, softcap=cap)
    for fn in (ref.attention_naive, ref.attention_blockwise):
        a = fn(q, k, v, return_lse=True, **kw)
        b = fn(q, k, v, return_lse=True, q_offset=0, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    out, lse = a
    a = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
    b = ref.attention_bwd_ref(q, k, v, out, lse, do, q_offset=0, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_offset_must_be_a_non_negative_int():
    q = torch.zeros((1, 8, 4, 32))
    kv = torch.zeros((1, 8, 2, 32))
    for bad in (-1, 1.5):
        with pytest.raises(ValueError, match="q_offset"):
            tfa.flash_attention(q, kv, kv, q_offset=bad)
