"""The port's kernel wrappers on the CPU against the JAX package.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold that version against the Pallas kernel run in interpret mode and
against the JAX oracle, on the same seeded numpy inputs.  The CUDA
kernels themselves are checked on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (cache_update,  # noqa: E402
                                           flash_decode)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# f32: same maths, different summation order -> 1e-5.  bf16: inputs are
# bf16 in both, outputs rounded to bf16 (eps 2^-8) from f32 sums -> 2e-2.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S, K, D = 3, 32, 2, 16


def _inputs(Sq, g, dtype, seed=0):
    rng = np.random.default_rng(seed)
    H = K * g
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    # ragged lengths; the last lane is done (index = S, kv_len = S + 1)
    kv_len = np.array([Sq + 5, S - 3, S + 1], np.int32)
    j = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(kv_len)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return j, t + [torch.from_numpy(kv_len)]


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert tfa.flash_decode.launches == 0
    assert tfa.cache_update.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("Sq", [1, 4])
def test_decode_attention_matches_jax(Sq, g, softcap, window, dtype):
    (jq, jk, jv, jlen), (tq, tk, tv, tlen) = _inputs(Sq, g, dtype)
    kernel = flash_decode(jq, jk, jv, jlen, softcap=softcap,
                          local_window=window, block_kv=16, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jlen, softcap=softcap,
                                       local_window=window)
    got = ops.decode_attention(tq, tk, tv, tlen, softcap=softcap,
                               local_window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()            # the done lane included
    for want in (kernel, oracle):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_attention_naive_matches_jax():
    """The cache-free plain path (CPU ``ops.attention``)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 12, 6, D)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, D)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, D)).astype(np.float32)
    for causal, window, cap in [(True, None, None), (True, 4, 5.0),
                                (False, None, None)]:
        want = jref.attention_naive(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    local_window=window, softcap=cap)
        got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            local_window=window, softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("Sn", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_update_bit_exact_against_jax(Sn, dtype):
    """Ragged offsets, a done slot (index = S), an overrunning slot
    (index + Sn > S) and a negative index: the two dropped whole."""
    rng = np.random.default_rng(2)
    Bu = 5
    kc = rng.standard_normal((Bu, S, K, D)).astype(np.float32)
    vc = rng.standard_normal((Bu, S, K, D)).astype(np.float32)
    kn = rng.standard_normal((Bu, Sn, K, D)).astype(np.float32)
    vn = rng.standard_normal((Bu, Sn, K, D)).astype(np.float32)
    index = np.array([0, 7, S, S - Sn + 1 if Sn > 1 else S - 1, -1],
                     np.int32)
    jd = getattr(jnp, dtype)
    want = cache_update(jnp.asarray(kc, jd), jnp.asarray(vc, jd),
                        jnp.asarray(kn), jnp.asarray(vn),
                        jnp.asarray(index), interpret=True)
    want_ref = jref.kv_cache_update_ref(jnp.asarray(kc, jd),
                                        jnp.asarray(vc, jd),
                                        jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.asarray(index))
    td = getattr(torch, dtype)
    tk = torch.from_numpy(kc).to(td)
    tv = torch.from_numpy(vc).to(td)
    got = ops.kv_cache_update(tk, tv, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(index))
    assert got[0] is tk and got[1] is tv          # written in place
    for w in (want, want_ref):
        for g_t, w_a in zip(got, w):
            np.testing.assert_array_equal(
                g_t.float().numpy(), np.asarray(w_a.astype(jnp.float32)))


def test_cache_update_drops_whole_slot():
    kc = torch.zeros((2, 8, 1, 8))
    vc = torch.zeros((2, 8, 1, 8))
    new = torch.ones((2, 3, 1, 8))
    ref.kv_cache_update_ref(kc, vc, new, new,
                            torch.tensor([6, 5], dtype=torch.int32))
    assert kc[0].abs().sum() == 0               # 6 + 3 > 8: nothing written
    assert kc[1, 5:].eq(1).all() and kc[1, :5].eq(0).all()


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach a wrapper's
    CUDA branch without a card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_attention_path_names_its_roadmap_item(monkeypatch):
    """Queue 2 item 5 is ported: a CUDA tensor reaching the cache-free
    attention goes to the ``flash_attention`` kernel (here: raises, as
    nvcc is missing), never to the plain version."""
    x = torch.zeros((1, 2, 2, 32)).as_subclass(_OnCuda)

    def no_nvcc(name):
        raise RuntimeError(f"nvcc not found building {name}")

    monkeypatch.setattr(tfa.build, "library", no_nvcc)
    monkeypatch.setattr(ref, "attention_naive", None)
    with pytest.raises(RuntimeError, match="flash_attention"):
        ops.attention(x, x, x)


def test_cuda_branch_checks_inputs_and_never_falls_back(monkeypatch):
    """On a CUDA tensor a wrapper validates its inputs, then builds and
    launches the kernel or raises: with no nvcc it raises, and the plain
    version is never taken."""
    q = torch.zeros((2, 1, 4, 32)).as_subclass(_OnCuda)
    kc = torch.zeros((2, 16, 2, 32)).as_subclass(_OnCuda)
    with pytest.raises(TypeError, match="kv_len"):
        tfa.flash_decode(q, kc, kc, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_decode(q.half(), kc.half(), kc.half(),
                         torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="index"):
        tfa.cache_update(kc, kc, q[:, :, :2], q[:, :, :2],
                         torch.zeros(3, dtype=torch.int32))

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tfa.build, "library", no_nvcc)
    monkeypatch.setattr(ref, "decode_attention_ref", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_decode(q, kc, kc, torch.full((2,), 3, dtype=torch.int32))
