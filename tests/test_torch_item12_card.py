"""hubert-xlarge's and qwen2-vl-72b's kernels on the card (the ``cuda``
cases; they skip without one): ``flash_attention`` and
``flash_attention_bwd`` at head_dim 80 against their plain versions, at a
small shape and at hubert's heads (H = K = 16, bidirectional), an odd
pair of lengths and one causal case, bf16 and f32, with a planted fault
in columns 64-79 flagged; the decode wrappers refusing D = 80 (no decode
path reaches it); the cache write with M-RoPE's cos/sin folded in, bit for
bit; reduced hubert at D = 80 and reduced qwen2-vl with vision rows, one
f32 train step each on the card against the CPU.  The CPU tests against
the JAX package are in ``tests/test_torch_hubert.py`` and
``tests/test_torch_qwen2vl.py``; this file imports no JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

# chip_smoke.py's rules: per entry one bf16 ulp (f32: 1e-5) of |want| plus
# 1e-5 of max|want|; the lse 1e-4
RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
LSE_TOL = 1e-4
# one f32 step on the card against the CPU: loss and grad norm, relative
STEP_TOL = 1e-4


@pytest.fixture
def card():
    """The card and its compiler, or a skip: decided here, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launch_counts()
    return torch.device("cuda")


def _limit(want, rtol, atol=1e-5):
    want = want.float()
    return rtol * want.abs() + atol * want.abs().max()


def _within(got, want, rtol):
    return bool(((got.float() - want.float()).abs()
                 <= _limit(want, rtol)).all())


def _randn(g, shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


# (B, Sq, Sk, H, K, causal): small, hubert's training shape, odd lengths
# (Sq != Sk, neither a multiple of a tile), one causal case
ATTN_CASES = {"small": (1, 130, 130, 2, 2, False),
              "hubert": (4, 1024, 1024, 16, 16, False),
              "odd": (2, 1000, 300, 16, 16, False),
              "causal": (2, 517, 517, 16, 4, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_and_its_gradient_at_head_dim_80(card, case, dtype):
    """``flash_attention`` (out and lse) and ``flash_attention_bwd`` (dq,
    dk, dv) against ``attention_naive`` and ``attention_bwd_ref`` at D =
    80, entry by entry; two backward calls give the same bits; out with
    its columns 64-79 zeroed (what a misread second box would give) is
    flagged."""
    B, Sq, Sk, H, K, causal = ATTN_CASES[case]
    D = 80
    g = torch.Generator(device=card).manual_seed(Sq + Sk)
    q, do = (_randn(g, (B, Sq, H, D), dtype) for _ in range(2))
    k, v = (_randn(g, (B, Sk, K, D), dtype) for _ in range(2))
    kw = dict(causal=causal)
    out, lse = tfa.flash_attention(q, k, v, **kw)
    want_out, want_lse = ref.attention_naive(q, k, v, return_lse=True, **kw)
    grads = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    again = tfa.flash_attention_bwd(q, k, v, want_out, want_lse, do, **kw)
    want = ref.attention_bwd_ref(q, k, v, want_out, want_lse, do, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == 1
    assert tfa.flash_attention_bwd.launches == 2
    assert _within(out, want_out, RTOL[dtype])
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    for a, b, w in zip(grads, again, want):
        assert _within(a, w, RTOL[dtype])
        assert torch.equal(a, b)
    bad = out.clone()
    bad[..., 64:80] = 0
    assert not _within(bad, want_out, RTOL[dtype])


@pytest.mark.cuda
def test_decode_wrappers_keep_their_head_dims(card):
    """hubert has no decode path: ``flash_decode`` refuses D = 80 on the
    card rather than launch a kernel not built for it; the cache-free
    wrappers list it."""
    assert 80 in tfa.ATTENTION_HEAD_DIMS and 80 not in tfa.HEAD_DIMS
    q = torch.zeros((1, 1, 2, 80), dtype=torch.bfloat16, device=card)
    kc = torch.zeros((1, 16, 2, 80), dtype=torch.bfloat16, device=card)
    kl = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim 80"):
        tfa.flash_decode(q, kc, kc, kl)
    assert tfa.flash_decode.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Sn", [1, 256])
def test_cache_update_with_mrope_cos_sin(card, Sn):
    """qwen2-vl's heads (H = 64, K = 8, D = 128): RoPE from M-RoPE cos/sin
    of a 3-D grid (each section its own row) and the cache write in one
    launch, bit for bit with the plain composition."""
    cfg = get_model_config("qwen2-vl-72b")
    B, S, H, K, D = 4, 1024, 64, 8, 128
    g = torch.Generator(device=card).manual_seed(Sn)
    q = _randn(g, (B, Sn, H, D), torch.bfloat16)
    kn, vn = (_randn(g, (B, Sn, K, D), torch.bfloat16) for _ in range(2))
    idx = torch.tensor([0, 700, S, 300], dtype=torch.int32, device=card)
    rows = idx.long()[:, None] + torch.arange(Sn, device=card)
    pos = torch.stack([rows // 7, rows // 3, rows]).int()   # three rows
    cos, sin = L.rope_cos_sin(cfg, pos)
    kc, vc = (torch.zeros((B, S, K, D), dtype=torch.bfloat16, device=card)
              for _ in range(2))
    kc2, vc2 = kc.clone(), vc.clone()
    _, _, qo = tfa.cache_update(kc, vc, kn, vn, idx, q=q, cos=cos, sin=sin)
    _, _, qw = ref.rope_kv_cache_update_ref(kc2, vc2, kn, vn, idx, q, cos,
                                            sin, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(qo, qw)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


def _step(arch, overrides, batch, device):
    """One f32 AdamW step of the reduced ``arch`` from seeded weights made
    on the CPU: (loss, grad norm, the first parameter leaf after it)."""
    cfg = reduced(get_model_config(arch), **overrides)
    run = get_run_config(arch, remat="full", compute_dtype="float32",
                         logits_chunk=16, warmup_steps=0)
    state = init_state(cfg, run, torch.Generator().manual_seed(0),
                       "cpu").tree()
    for part in ("params", "opt_state"):
        state[part] = tree_map(lambda t: t.to(device), state[part])
    step = make_train_step(cfg, run, Ctx(run, device))
    state, m = step(state, {k: v.to(device) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"]), \
        leaves(state["params"])[0].detach().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-72b"])
def test_one_f32_train_step_card_vs_cpu(card, arch):
    """Reduced hubert at D = 80 (frames, bidirectional; the kernels take
    2 forward and 1 backward launch a layer under remat) and reduced
    qwen2-vl (vision rows, grid positions): one f32 step on the card
    against the same step on the CPU (plain versions)."""
    rng = np.random.default_rng(1)
    if arch == "hubert-xlarge":
        ov = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80)
        cfg = reduced(get_model_config(arch), **ov)
        batch = {"frames": rng.standard_normal((2, 128, cfg.frontend_dim))}
    else:
        ov = {}
        cfg = reduced(get_model_config(arch))
        pos = np.zeros((3, 128), np.int64)
        r = np.arange(16)
        pos[1, :16], pos[2, :16] = r // 4, r % 4
        pos[:, 16:] = 4 + np.arange(112)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 128)),
                 "vision_embeds": rng.standard_normal((2, 16, cfg.d_model)),
                 "positions": np.broadcast_to(pos[:, None], (3, 2, 128))}
    batch["labels"] = rng.integers(0, cfg.vocab, (2, 128))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float32 if v.dtype == np.float64 else torch.int32)
        for k, v in batch.items()}
    loss, gn, p = _step(arch, ov, batch, card)
    closs, cgn, cp = _step(arch, ov, batch, "cpu")
    assert loss == pytest.approx(closs, rel=STEP_TOL)
    assert gn == pytest.approx(cgn, rel=STEP_TOL)
    assert (p - cp).abs().max().item() <= 1e-5
    assert tfa.flash_attention.launches == 2 * cfg.n_layers
    assert tfa.flash_attention_bwd.launches == cfg.n_layers
