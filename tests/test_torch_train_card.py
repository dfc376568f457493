"""The training kernels of MoE and Mamba-2 on the card (the ``cuda`` cases;
they skip without one): ``grouped_matmul_bwd`` and ``ssd_bwd`` against
their plain versions at a small size, bf16 and f32, and at the cases their
tensor-core kernels make risky (a capacity ending inside a tile, one-sided
calls; two groups, chunks of 37 rows and of one), the ``ssd`` forward at
the training shape (and causal there), and reduced olmoe and mamba2 train
steps that run through them.  The CPU tests against the JAX
package are in ``tests/test_torch_train_moe_ssm.py``; this file imports no
JAX."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import grouped_matmul as tgmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

# chip_smoke.py's rules: per entry one bf16 ulp (f32: 1e-5) of |want| plus
# 1e-5 of max|want|; ssd_bwd's f32 sums (dA, dD, dh0) 1e-5 |want| + 1e-4
# max|want|
RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_bwd_kernel_matches_its_plain_version(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    lhs, rhs, dout = (torch.randn(s, generator=g, device=card).to(dtype)
                      for s in ((8, 37, 128), (8, 128, 256), (8, 37, 256)))
    lhs[:, 30:] = 0                      # dead rows past the live count
    dout[:, 30:] = 0
    got = tgmm.grouped_matmul_bwd(lhs, rhs, dout)
    again = tgmm.grouped_matmul_bwd(lhs, rhs, dout)
    want = ref.grouped_matmul_bwd(lhs, rhs, dout)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and _within(a, w, RTOL[dtype])
        assert torch.equal(a, b)
    assert (got[0][:, 30:] == 0).all()
    assert tgmm.grouped_matmul_bwd.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_its_plain_version(card, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    Bb, S, H, P, G, N, Q = 2, 96, 8, 32, 2, 64, 48
    x = torch.randn((Bb, S, H, P), generator=g, device=card).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((Bb, S, H), generator=g, device=card) - 3).to(dtype)
    A = -torch.exp(0.5 * torch.randn((H,), generator=g, device=card))
    Bm, Cm = (torch.randn((Bb, S, G, N), generator=g, device=card).to(dtype)
              for _ in range(2))
    D = torch.randn((H,), generator=g, device=card)
    h0, ds = (torch.randn((Bb, H, P, N), generator=g, device=card)
              for _ in range(2))
    dy = torch.randn(x.shape, generator=g, device=card).to(dtype)
    got = tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=Q)
    again = tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=Q)
    want = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=Q)
    torch.cuda.synchronize()
    for n, a, b, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"), got,
                          again, want):
        assert a.dtype == w.dtype, n
        f32_sum = n in ("dA", "dD", "dh0")
        assert _within(a, w, 1e-5 if f32_sum else RTOL[dtype],
                       1e-4 if f32_sum else 1e-5), n
        assert torch.equal(a, b), n
    assert tssd.ssd_bwd.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [37, 640])
def test_grouped_matmul_bwd_at_a_ragged_capacity(card, dtype, M):
    """The one-launch gradient at capacities that end inside a 128-row
    tile (37) and at olmoe's training capacity (640), gate/up's widths:
    both products, then each alone (the other None), against the plain
    version; the same inputs twice, bit for bit; a dead row's dlhs exactly
    zero; one kernel launch a call."""
    g = torch.Generator(device=card).manual_seed(3)
    G, K, N = 64, 2048, 1024
    lhs, rhs, dout = (torch.randn(s, generator=g, device=card).to(dtype)
                      for s in ((G, M, K), (G, K, N), (G, M, N)))
    lhs[:, M - 3:] = 0                   # dead rows at the ragged end
    dout[:, M - 3:] = 0
    want = ref.grouped_matmul_bwd(lhs, rhs, dout)
    got = tgmm.grouped_matmul_bwd(lhs, rhs, dout)
    again = tgmm.grouped_matmul_bwd(lhs, rhs, dout)
    only_l = tgmm.grouped_matmul_bwd(lhs, rhs, dout, need_rhs=False)
    only_r = tgmm.grouped_matmul_bwd(lhs, rhs, dout, need_lhs=False)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert _within(a, w, RTOL[dtype]) and torch.equal(a, b)
    assert only_l[1] is None and only_r[0] is None
    assert torch.equal(only_l[0], got[0]) and torch.equal(only_r[1], got[1])
    assert (got[0][:, M - 3:] == 0).all()
    assert tgmm.grouped_matmul_bwd.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,Q", [(2, 256, 128), (1, 148, 37), (1, 131, 1)])
def test_ssd_bwd_at_two_groups_and_odd_chunks(card, dtype, G, S, Q):
    """The gradient at mamba2's heads with two groups (each group's dB and
    dC summed over its own 16 heads) and at chunks of 37 rows and of one
    row, with h0, D and the final state's gradient: every gradient within
    its rule against the plain version, the same inputs twice bit for
    bit."""
    gen = torch.Generator(device=card).manual_seed(4)
    Bb, H, P, N = 1, 32, 64, 128
    x = torch.randn((Bb, S, H, P), generator=gen, device=card).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((Bb, S, H), generator=gen, device=card) - 3).to(dtype)
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=card))
    Bm, Cm = (torch.randn((Bb, S, G, N), generator=gen, device=card)
              .to(dtype) for _ in range(2))
    D = torch.randn((H,), generator=gen, device=card)
    h0, ds = (torch.randn((Bb, H, P, N), generator=gen, device=card)
              for _ in range(2))
    dy = torch.randn(x.shape, generator=gen, device=card).to(dtype)
    got = tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=Q)
    again = tssd.ssd_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=Q)
    want = ref.ssd_chunked_bwd(x, dt, A, Bm, Cm, D, h0, dy, ds, chunk=Q)
    torch.cuda.synchronize()
    for n, a, b, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dh0"), got,
                          again, want):
        f32_sum = n in ("dA", "dD", "dh0")
        assert _within(a, w, 1e-5 if f32_sum else RTOL[dtype],
                       1e-4 if f32_sum else 1e-5), n
        assert torch.equal(a, b), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_is_causal_at_the_training_shape(card, dtype):
    """The forward at the training arms' shape (mamba2's heads, Bb 2, S
    2048, chunk 128) against its plain version, and causal: x, dt, B and
    C changed after row 1000 (inside a chunk) leave y bit-equal up to
    it."""
    g = torch.Generator(device=card).manual_seed(2)
    Bb, S, H, P, G, N, t = 2, 2048, 32, 64, 1, 128, 1000
    x = torch.randn((Bb, S, H, P), generator=g, device=card).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((Bb, S, H), generator=g, device=card) - 3).to(dtype)
    A = -torch.exp(0.5 * torch.randn((H,), generator=g, device=card))
    Bm, Cm = (torch.randn((Bb, S, G, N), generator=g, device=card).to(dtype)
              for _ in range(2))
    D = torch.randn((H,), generator=g, device=card)
    y, st = tssd.ssd(x, dt, A, Bm, Cm, D, chunk=128)
    want_y, want_st = ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    torch.cuda.synchronize()
    assert _within(y, want_y, RTOL[dtype])
    assert _within(st, want_st, RTOL[torch.float32])
    x2, dt2, B2, C2 = (a.clone() for a in (x, dt, Bm, Cm))
    for a in (x2, dt2, B2, C2):
        a[:, t + 1:] = a[:, t + 1:].flip(1)
    y2, _ = tssd.ssd(x2, dt2, A, B2, C2, D, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y[:, :t + 1], y2[:, :t + 1])
    assert not torch.equal(y[:, t + 1:], y2[:, t + 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m"])
def test_train_step_runs_through_the_gradient_kernels(card, arch):
    """Reduced olmoe and mamba2 (its state and head sizes raised to 32,
    the kernels' least), bf16 compute: two train steps on the card,
    finite losses and exactly the forward and gradient launches of
    remat="none" (one forward a layer)."""
    kw = dict(ssm_state=32, ssm_headdim=32) if arch == "mamba2-370m" else {}
    cfg = reduced(get_model_config(arch), **kw)
    run = get_run_config(arch, remat="none", warmup_steps=0, total_steps=4)
    state = init_state(cfg, run, torch.Generator(device=card).manual_seed(0),
                       "cuda").tree()
    src = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=64))
    step = make_train_step(cfg, run, Ctx(run, "cuda"))
    losses = []
    for i in range(2):
        batch = {k: torch.from_numpy(v).to(card)
                 for k, v in src.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    assert all(map(lambda v: v == v and abs(v) < 1e4, losses))
    n = cfg.n_layers * 2
    if cfg.n_experts:
        assert tgmm.grouped_matmul.launches == 3 * n
        assert tgmm.grouped_matmul_bwd.launches == 3 * n
    else:
        assert tssd.ssd.launches == n and tssd.ssd_bwd.launches == n
