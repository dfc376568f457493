"""gemma2's kernels on the card (the ``cuda`` cases; they skip without
one): every attention kernel at head_dim 256 against its plain version, at
a small shape and at gemma2's heads (H = 8, K = 4, softcap 50, the window
acting), bf16 and f32; the paged decode equal to the dense one bit for bit;
RoPE and the cache write at rot_dim 256 bit for bit; and, under
``remat="dots"``, each autograd Function's forward run again in the
backward pass into fresh buffers, equal to the first bit for bit.  The CPU
tests against the JAX package are in ``tests/test_torch_gemma2.py`` and
``tests/test_torch_remat.py``; this file imports no JAX."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import grouped_matmul as tgmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# chip_smoke.py's rules: per entry one bf16 ulp (f32: 1e-5) of |want| plus
# 1e-5 of max|want|; the lse 1e-4
RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
HEADS = (8, 4, 256)          # gemma2's H, K, D
CAP, WINDOW = 50.0, 4096


@pytest.fixture
def card():
    """The card and its compiler, or a skip: decided here, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launch_counts()
    return torch.device("cuda")


def _within(got, want, rtol, atol=1e-5):
    got, want = got.float(), want.float()
    limit = rtol * want.abs() + atol * want.abs().max()
    return bool(((got - want).abs() <= limit).all())


def _randn(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


# (B, S, kv_len per slot, Sq, window): a small case, then a decode step and
# a 256-row chunk at gemma2's heads over 8192 rows with kv_len past the
# window (one done lane: S + 1)
DECODE_CASES = {
    "small": (2, 256, [200, 97], 1, 64),
    "small-chunk": (2, 256, [200, 160], 64, 64),
    "step": (8, 8192, [5000, 4097, 300, 8192, 6000, 1, 4500, 8193], 1,
             WINDOW),
    "chunk": (1, 8192, [5000], 256, WINDOW),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_at_head_dim_256(card, case, dtype):
    """``flash_decode`` and ``flash_decode_paged`` (16-row blocks,
    scattered) against the plain version, entry by entry, and paged ==
    dense bit for bit."""
    B, S, lens, Sq, window = DECODE_CASES[case]
    H, K, D = HEADS
    g = torch.Generator(device=card).manual_seed(len(lens) + Sq)
    q = _randn(g, (B, Sq, H, D), dtype)
    k, v = (_randn(g, (B, S, K, D), dtype) for _ in range(2))
    kl = torch.tensor(lens, dtype=torch.int32, device=card)
    kw = dict(softcap=CAP, local_window=window)
    got = tfa.flash_decode(q, k, v, kl, **kw)
    want = ref.decode_attention_ref(q, k, v, kl, **kw)
    bs, nb = 16, S // 16
    perm = torch.randperm(B * nb, generator=g, device=card).int()
    table = perm.reshape(B, nb).contiguous()
    kp = torch.empty((B * nb, bs, K, D), dtype=dtype, device=card)
    vp = torch.empty_like(kp)
    kp[table.reshape(-1).long()] = k.reshape(B * nb, bs, K, D)
    vp[table.reshape(-1).long()] = v.reshape(B * nb, bs, K, D)
    paged = tfa.flash_decode_paged(q, kp, vp, kl, table, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within(got, want, RTOL[dtype])
    assert torch.equal(paged, got)
    assert tfa.flash_decode.launches == tfa.flash_decode_paged.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("Sn", [1, 256])
def test_cache_update_rope_at_rot_dim_256(card, Sn, paged):
    """RoPE of q and k at rot_dim 256 (gemma2's rotary_pct 1.0) and the
    cache write in one launch, bit for bit with the plain composition, a
    slot dropped (index past the cache)."""
    B, S, (H, K, D) = 4, 1024, HEADS
    g = torch.Generator(device=card).manual_seed(Sn)
    q = _randn(g, (B, Sn, H, D), torch.bfloat16)
    kn, vn = (_randn(g, (B, Sn, K, D), torch.bfloat16) for _ in range(2))
    idx = torch.tensor([0, 700, S, 300][:B], dtype=torch.int32, device=card)
    pos = (idx.long()[:, None] + torch.arange(Sn, device=card)).float()
    inv = 10000.0 ** (-torch.arange(0, D // 2, device=card).float()
                      / (D // 2))
    ang = pos[..., None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    if paged:
        bs = 16
        table = torch.randperm(B * S // bs, generator=g, device=card) \
            .int().reshape(B, S // bs).contiguous()
        shape = (B * S // bs, bs, K, D)
        kc, vc = (torch.zeros(shape, dtype=torch.bfloat16, device=card)
                  for _ in range(2))
        kc2, vc2 = kc.clone(), vc.clone()
        _, _, qo = tfa.cache_update_paged(kc, vc, kn, vn, idx, table, q=q,
                                          cos=cos, sin=sin)
        _, _, qw = ref.rope_kv_cache_update_ref(kc2, vc2, kn, vn, idx, q,
                                                cos, sin, 1.0,
                                                block_tables=table)
    else:
        kc, vc = (torch.zeros((B, S, K, D), dtype=torch.bfloat16,
                              device=card) for _ in range(2))
        kc2, vc2 = kc.clone(), vc.clone()
        _, _, qo = tfa.cache_update(kc, vc, kn, vn, idx, q=q, cos=cos,
                                    sin=sin)
        _, _, qw = ref.rope_kv_cache_update_ref(kc2, vc2, kn, vn, idx, q,
                                                cos, sin, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(qo, qw)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


# (B, S, causal, window): small, then gemma2's training shape, global and
# with a window of 1024 acting at 2048 rows
ATTN_CASES = {"small": (1, 200, True, 64), "global": (2, 2048, True, None),
              "window": (2, 2048, True, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_and_its_gradient_at_head_dim_256(card, case, dtype):
    """``flash_attention`` (out and lse) and ``flash_attention_bwd`` (dq,
    dk, dv) against ``attention_naive`` and ``attention_bwd_ref``, softcap
    50, entry by entry; two calls give the same bits."""
    B, S, causal, window = ATTN_CASES[case]
    H, K, D = HEADS
    g = torch.Generator(device=card).manual_seed(S)
    q, do = (_randn(g, (B, S, H, D), dtype) for _ in range(2))
    k, v = (_randn(g, (B, S, K, D), dtype) for _ in range(2))
    kw = dict(causal=causal, local_window=window, softcap=CAP)
    out, lse = tfa.flash_attention(q, k, v, **kw)
    want_out, want_lse = ref.attention_naive(q, k, v, return_lse=True, **kw)
    grads = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    again = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, want_out, want_lse, do, **kw)
    torch.cuda.synchronize()
    assert _within(out, want_out, RTOL[dtype])
    assert (lse - want_lse).abs().max().item() <= 1e-4
    for a, b, w in zip(grads, again, want):
        assert _within(a, w, RTOL[dtype])
        assert torch.equal(a, b)


def _record_forwards(functions, store):
    """Wrap each Function's forward to keep (a copy of its outputs, the
    outputs themselves, held alive so no later call can be given their
    storage) per call; returns the originals to put back."""
    originals = [fn.__dict__["forward"] for fn in functions]
    for fn, orig in zip(functions, originals):
        def recorded(*args, _orig=orig.__func__, _name=fn.__name__, **kw):
            out = _orig(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            store.setdefault(_name, []).append(
                ([o.detach().clone() for o in outs if torch.is_tensor(o)],
                 [o.detach() for o in outs if torch.is_tensor(o)]))
            return out

        fn.forward = staticmethod(recorded)
    return originals


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "mamba2-370m"])
def test_dots_recompute_writes_fresh_buffers_bit_equal(card, arch):
    """Under ``remat="dots"`` each autograd Function (``FlashAttention``,
    ``GroupedMatmul``, ``SSD``) runs its kernel again in the backward pass:
    every first call's outputs are met again, bit for bit, by one
    recomputed call (the layers run again last first), in buffers of
    their own, and the first outputs are left as they were."""
    # mamba2's state and head sizes raised to 32, the ssd kernels' least
    kw = dict(ssm_state=32, ssm_headdim=32) if arch == "mamba2-370m" else {}
    cfg = reduced(get_model_config(arch), **kw)
    run = get_run_config(arch, remat="dots", logits_chunk=16)
    params = init_params(lm.model_decls(cfg),
                         torch.Generator(device=card).manual_seed(0), card)
    for p in leaves(params):
        p.requires_grad_(True)
    src = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=2,
                                 seq_len=128, seed=3))
    batch = {k: torch.from_numpy(v).to(card)
             for k, v in src.batch(0).items()}
    functions = (ops.FlashAttention, tgmm.GroupedMatmul, tssd.SSD)
    first, again = {}, {}
    originals = _record_forwards(functions, first)
    try:
        loss, _ = make_loss_fn(cfg, run, Ctx(run, card))(params, batch)
        for fn, orig in zip(functions, originals):
            fn.forward = orig
        originals = _record_forwards(functions, again)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        for fn, orig in zip(functions, originals):
            fn.forward = orig
    assert first and set(again) == set(first)
    for name in first:
        # the backward pass recomputes the layers last first: each first
        # call is matched to the recomputed call with its bits
        assert len(again[name]) == len(first[name])
        left = list(again[name])
        for copies, outs in first[name]:
            j = next(j for j, (_, outs2) in enumerate(left)
                     if all(torch.equal(b, c) for b, c in zip(outs2, copies)))
            _, outs2 = left.pop(j)
            for c, a, b in zip(copies, outs, outs2):
                assert torch.equal(a, c)           # the first left alone
                assert a.data_ptr() != b.data_ptr()
