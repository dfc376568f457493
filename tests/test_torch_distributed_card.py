"""The distributed layer's card side (the ``cuda`` cases; they skip
without a card): ``flash_decode``'s log-sum-exp output against its plain
version on the decode path and both chunk kernels, with empty slices and
a window; the fused RoPE of q rotating every slot, so a rank that does not
own the new row returns the owner's q; and two ranks sharing the card over
gloo (reduced llama, f32): sharded decode steps and a sharded train step
against the one-device ones, each rank launching the kernels.  The CPU
tests against the JAX package are in ``tests/test_torch_distributed.py``;
this file imports no JAX."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tfa.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [(24, 8, 128), (64, 8, 128), (4, 2, 32)])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_decode_lse_matches_plain(card, dtype, heads, window):
    H, K, D = heads
    B, S = 5, 384
    kv_len = [0, 1, 250, 383, 384]
    q, k, v, kl = cs._dist_lse_case(B, S, H, K, D, dtype, kv_len, 1)
    out, lse = tfa.flash_decode(q, k, v, kl, local_window=window,
                                return_lse=True)
    want, wlse = ref.decode_attention_lse_ref(q, k, v, kl,
                                              local_window=window)
    assert torch.equal(out, tfa.flash_decode(q, k, v, kl,
                                             local_window=window))
    limit = RTOL[dtype] * want.float().abs() + 1e-5 * want.float().abs().max()
    assert ((out.float() - want.float()).abs() <= limit).all()
    assert not cs.lse_flagged(lse, wlse).any()
    assert out[0].abs().max().item() == 0.0 and torch.isneginf(lse[0]).all()


@pytest.mark.cuda
def test_cache_update_rotates_q_on_a_rank_without_the_row(card):
    """The sequence-sharded decode passes each rank its local index; the
    rank that does not own the row has its write dropped, and still gets
    the rotated q, bit for bit the owner's."""
    B, K, H, D, S = 3, 2, 4, 32, 16
    g = torch.Generator(device="cuda").manual_seed(2)
    q, kn, vn = (torch.randn((B, 1, n, D), generator=g, device="cuda")
                 for n in (H, K, K))
    ang = torch.rand((B, 1, D // 2), generator=g, device="cuda")
    cos, sin = torch.cos(ang), torch.sin(ang)
    outs = []
    for idx in (5, 5 - S):             # the owner; a rank past the row
        kc = torch.zeros((B, S, K, D), device="cuda")
        vc = torch.zeros_like(kc)
        index = torch.full((B,), idx, dtype=torch.int32, device="cuda")
        _, _, q_out = tfa.cache_update(kc, vc, kn, vn, index, q=q, cos=cos,
                                       sin=sin)
        outs.append((q_out, kc.abs().sum().item()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] > 0 and outs[1][1] == 0.0


@pytest.mark.cuda
def test_two_ranks_on_the_card_match_one_device(card):
    from repro_torch.kernels import build
    build.build_all()                  # built once, before the ranks start
    from repro_torch.launch.mesh import spawn_ranks
    res = spawn_ranks(cs.dist_rank_reduced, 2, "gloo", timeout_s=300)
    for r in res:
        assert r["decode_rel_diff"] < 1e-5
        assert r["decode_launches"].get("flash_decode", 0) > 0
        assert r["decode_launches"].get("cache_update", 0) > 0
        # f32 against one device: the loss as on the CPU, the gradients'
        # norms by summation order
        assert r["loss_rel"] <= 1e-5
        assert r["grad_norm_rel"] <= 1e-4 and r["grad_rel"] <= 1e-4
        assert r["params_apart"] <= 1e-3
        for name in ("flash_attention", "flash_attention_bwd"):
            assert r["launches"].get(name, 0) > 0
