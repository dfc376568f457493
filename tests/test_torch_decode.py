"""The decode kernels' orders of sums on the CPU, against the JAX package.

``ref.decode_attention_split`` is the split-KV decode path's arithmetic
(fixed spans of kv rows, combined in span order): held against
``ref.decode_attention_ref``, the JAX oracle and the Pallas
``flash_decode`` in interpret mode.  ``ref.decode_attention_tc_emulated``
is the bf16 prefill-chunk kernel's (P handed to the tensor cores in bf16
parts): held to the per-entry rule ``chip_smoke.py`` applies.  Also: the
``flash_decode`` wrappers hand the kernels the decode path's scratch, and
``chip_smoke.py`` checks ``grouped_matmul`` at every capacity olmoe's
prefill chunks produce.  The CUDA kernels themselves are checked on the
card by ``chip_smoke.py``.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_decode  # noqa: E402
from repro_torch.configs.registry import get_model_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serving.scheduler import chunk_plan  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# f32: the same maths in another summation order
TOL = 1e-5
B, K, D = 3, 2, 16
SPAN = 64

# (Sq, g, softcap, local_window, S): decode steps and prefill chunks (Sq
# 256: up to five spans of 64 rows per slot), GQA, a softcap, and windows
# that leave the first spans of a slot unseen.  S is a whole number of the
# Pallas kernel's kv blocks, which it would otherwise pad with rows a done
# lane (kv_len = S + 1) reads.
SPLIT_CASES = [
    (1, 1, None, None, 192),
    (1, 3, 5.0, 40, 192),
    (5, 3, None, 70, 192),
    (5, 1, 5.0, None, 192),
    (256, 1, None, None, 320),
    (256, 3, 5.0, 100, 320),
]


def _split_id(c):
    sq, g, cap, win, s = c
    return f"Sq{sq}-g{g}-cap{cap}-w{win}-S{s}"


def _decode_inputs(Sq, g, S, seed=0):
    """Ragged lengths: a short slot, one a little below S, and a done lane
    (kv_len = S + 1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, K * g, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    kv_len = np.array([Sq + 5, S - 3, S + 1], np.int32)
    return q, k, v, kv_len


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_split_id)
def test_split_decode_matches_the_reference_and_jax(case):
    Sq, g, cap, win, S = case
    q, k, v, kv_len = _decode_inputs(Sq, g, S)
    kw = dict(softcap=cap, local_window=win)
    got = ref.decode_attention_split(*map(torch.from_numpy, (q, k, v, kv_len)),
                                     span=SPAN, **kw).numpy()
    assert np.isfinite(got).all()               # the done lane included
    want = ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, kv_len)),
                                    **kw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jargs = [jnp.asarray(a) for a in (q, k, v, kv_len)]
    for jwant in (jref.decode_attention_ref(*jargs, **kw),
                  flash_decode(*jargs, block_kv=SPAN, interpret=True, **kw)):
        np.testing.assert_allclose(got, np.asarray(jwant), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Sq,g", [(1, 3), (5, 1), (256, 3)])
def test_split_decode_does_not_depend_on_the_slot_row_limit(Sq, g):
    """A paged slot holds max_blocks * bs rows, more than the dense cache's
    S: the rows past a live lane's kv_len only add spans no query row sees,
    so the result is the same bit for bit (the kernels' spans are kv
    positions, whatever the cache's size)."""
    S, extra = 320, 2 * SPAN + 24
    q, k, v, _ = _decode_inputs(Sq, g, S + extra, seed=1)
    kv_len = torch.tensor([Sq + 5, S - 3, S], dtype=torch.int32)
    q, k, v = map(torch.from_numpy, (q, k, v))
    dense = ref.decode_attention_split(q, k[:, :S], v[:, :S], kv_len,
                                       span=SPAN, softcap=5.0)
    paged = ref.decode_attention_split(q, k, v, kv_len, span=SPAN,
                                       softcap=5.0)
    assert torch.equal(dense, paged)


def test_split_decode_spans_a_window_empties_add_nothing():
    """With a window the first spans of a slot are unseen: the result over
    a cache whose unseen rows are garbage (1e4) equals the one over the
    intact cache bit for bit."""
    Sq, g, S, win = 1, 3, 320, 40
    q, k, v, kv_len = _decode_inputs(Sq, g, S, seed=2)
    q, k, v, kv_len = map(torch.from_numpy, (q, k, v, kv_len))
    k2, v2 = k.clone(), v.clone()
    first_seen = kv_len.long() - Sq - win + 1
    for b in range(B):
        k2[b, :max(0, int(first_seen[b]))] = 1e4
        v2[b, :max(0, int(first_seen[b]))] = 1e4
    a = ref.decode_attention_split(q, k, v, kv_len, span=SPAN,
                                   local_window=win)
    b_ = ref.decode_attention_split(q, k2, v2, kv_len, span=SPAN,
                                    local_window=win)
    assert torch.equal(a, b_)


# ===========================================================================
# the bf16 prefill-chunk kernel's numerics: P goes to the tensor cores in
# two parts
# ===========================================================================

# chip_smoke.py's per-entry rule for a bf16 output (ATTN_RTOL, ATTN_ATOL)
RULE_RTOL, RULE_ATOL = 2 ** -7, 1e-5

# (Sq, H, K, D, kv_len, softcap, local_window): llama's GQA, olmoe's and
# zamba2's one query head per kv head, the reduced head dim, a window
CHUNK_CASES = [
    (256, 6, 2, 128, [768, 1024], None, None),
    (256, 2, 2, 128, [768, 300], None, None),
    (256, 4, 4, 64, [512, 768], 30.0, None),
    (64, 4, 2, 32, [200, 64], None, 50),
]


def _chunk_id(c):
    sq, h, k, d, lens, cap, win = c
    return f"Sq{sq}-H{h}-K{k}-D{d}-cap{cap}-w{win}"


def _over_rule(got, want):
    got, want = got.float(), want.float()
    limit = RULE_RTOL * want.abs() + RULE_ATOL * want.abs().max()
    return (got - want).abs() / limit


def _chunk_inputs(case, seed=5):
    Sq, H, K_, D_, lens, cap, win = case
    rng = np.random.default_rng(seed)
    S = max(lens)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
        for shape in ((len(lens), Sq, H, D_), (len(lens), S, K_, D_),
                      (len(lens), S, K_, D_)))
    kv_len = torch.tensor(lens, dtype=torch.int32)
    kw = dict(softcap=cap, local_window=win)
    return (q, k, v, kv_len), kw, ref.decode_attention_ref(q, k, v, kv_len,
                                                           **kw)


@pytest.mark.parametrize("case", CHUNK_CASES, ids=_chunk_id)
def test_chunk_p_split_hi_lo_meets_the_rule(case):
    """P as hi = bf16(P) and lo = bf16(P - hi), one f32 product each (the
    kernel's design): every entry within one bf16 ulp of the plain
    version."""
    args, kw, want = _chunk_inputs(case)
    got = ref.decode_attention_tc_emulated(*args, parts=2, **kw)
    assert _over_rule(got, want).max() <= 1


@pytest.mark.parametrize("case", CHUNK_CASES, ids=_chunk_id)
def test_chunk_p_rounded_to_bf16_breaks_the_rule(case):
    """P rounded to bf16 once puts entries far beyond one bf16 ulp of the
    plain version: the per-entry rule rejects the shortcut."""
    args, kw, want = _chunk_inputs(case)
    got = ref.decode_attention_tc_emulated(*args, parts=1, **kw)
    assert _over_rule(got, want).max() > 2


# ===========================================================================
# the wrappers' scratch, and chip_smoke.py's grouped_matmul shapes
# ===========================================================================

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach a wrapper's
    CUDA branch without a card."""

    @property
    def is_cuda(self):
        return True


class _Lib:
    """Records the arguments a wrapper hands the C entry point."""

    def __init__(self):
        self.args = None

    def __getattr__(self, name):
        def call(*args):
            self.args = args
            return 0
        return call


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("Sq,H,path", [(1, 12, "decode"), (1, 4, "decode"),
                                       (2, 4, "decode"), (5, 4, "chunk"),
                                       (1, 20, "chunk")])
def test_wrappers_hand_the_decode_path_its_scratch(monkeypatch, paged, Sq, H,
                                                   path):
    """Sq * H / K <= DECODE_ROWS takes the split-KV decode path: the
    wrapper allocates the spans' states for ceil(rows / DECODE_SPAN) spans
    per (slot, kv head) and hands over the zeroed counters and the span;
    a prefill chunk gets null scratch."""
    lib = _Lib()
    monkeypatch.setattr(tfa.build, "library", lambda name: lib)
    monkeypatch.setattr(tfa, "_counters", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    Bq, K_, D_, bs, mb = 2, 4, 32, 16, 40
    rows = mb * bs if paged else 600
    q = torch.zeros((Bq, Sq, H, D_)).as_subclass(_OnCuda)
    kv_len = torch.full((Bq,), 9, dtype=torch.int32)
    empty = []
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty.append(a)
                        or torch.zeros(*a, **k))
    if paged:
        pool = torch.zeros((Bq * mb + 1, bs, K_, D_)).as_subclass(_OnCuda)
        table = torch.zeros((Bq, mb), dtype=torch.int32)
        tfa.flash_decode_paged(q, pool, pool, kv_len, table)
        part, counters = lib.args[6], lib.args[7]
    else:
        cache = torch.zeros((Bq, rows, K_, D_)).as_subclass(_OnCuda)
        tfa.flash_decode(q, cache, cache, kv_len)
        part, counters = lib.args[5], lib.args[6]
    assert lib.args[-2] == tfa.DECODE_SPAN
    if path == "chunk":
        assert part is None and counters is None
        assert not empty
    else:
        n_spans = math.ceil(rows / tfa.DECODE_SPAN)
        assert empty == [(Bq * K_ * n_spans * tfa.DECODE_ROWS * (D_ + 2),)]
        assert part is not None and counters is not None
        (ct,) = tfa._counters.values()
        assert ct.numel() >= Bq * K_ and not ct.any()
    tfa.reset_launch_counts()


def test_chip_smoke_checks_grouped_matmul_at_every_olmoe_capacity():
    """Every capacity ceil(S * top_k * capacity_factor / E) of olmoe's
    prefill chunks (the powers of two up to the 256-row chunk) and of its
    batch-8 decode step is among chip_smoke.py's checked and timed M."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    cfg = get_model_config("olmoe-1b-7b")
    sizes = set(chunk_plan(2 * 256 - 1, 256)) | {8}
    capacities = {math.ceil(s * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts) for s in sizes}
    assert capacities == {1, 2, 3, 5, 10, 20, 40}
    assert capacities <= {M for _, M, _, _ in chip_smoke.GMM_SHAPES}
    assert capacities == set(chip_smoke.GMM_TIME_M)
