"""``remat="dots"`` in the port on the CPU: the training step of reduced
gemma2 under ``"none"``, ``"full"`` and ``"dots"`` and of reduced
phi3.5-moe under its own ``RUN_OVERRIDES`` (``"dots"``) against JAX's
``make_train_step`` over two AdamW steps, and what the policy saves: a
``"dots"`` backward pass runs no 2-D matrix product of the forward again
(``aten.mm``, ``aten.addmm``), and runs every batched one (``aten.bmm``)
and each autograd Function's forward again, as ``"full"`` does."""

import collections
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import (  # noqa: E402
    TorchDispatchMode, _disable_current_modes)

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       load_numpy_state)
from repro_torch.train.step import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

# as tests/test_torch_train_moe_ssm.py: metrics 1e-4 relative; parameters
# after two AdamW steps move by <= lr = 1e-3 times gradient ratios that
# agree to ~1e-6 between the packages
F32_TOL = 1e-4
PARAM_TOL = 5e-6
RUN_KW = dict(logits_chunk=16, learning_rate=1e-3, warmup_steps=2,
              total_steps=10)
MM = ("aten.mm.default", "aten.addmm.default")
BMM = "aten.bmm.default"


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _batches(cfg, n, seq=32):
    src = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=4,
                                 seq_len=seq, seed=11))
    return [src.batch(i) for i in range(n)]


def _two_steps_against_jax(arch, remat, seq=32):
    """Two AdamW steps of the reduced ``arch`` in f32 from JAX's initial
    state, both packages under ``remat``: loss and grad norm per step, and
    every parameter and optimizer moment after the two."""
    jcfg = jreduced(jget_cfg(arch))
    jrun = jget_run(arch, remat=remat, compute_dtype="float32", **RUN_KW)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jstate = jinit_state(jcfg, jrun, jax.random.PRNGKey(0)).tree()
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat=remat, compute_dtype="float32",
                         **RUN_KW)
    assert run.remat == jrun.remat == remat
    state = load_numpy_state(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jmake_step(jcfg, jrun, jctx))
    step = make_train_step(cfg, run, Ctx(run, "cpu"))
    for batch in _batches(cfg, 2, seq):
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


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_gemma2_train_steps_match_jax(remat):
    """Reduced gemma2 (local/global pairs, window 64 acting at 96 rows,
    sandwich norms, softcaps) under each remat policy: the reference
    checkpoints each (local, global) pair, the port each block."""
    _two_steps_against_jax("gemma2-2b", remat, seq=96)


def test_phi35_moe_trains_under_its_own_dots_override():
    """phi3.5-moe's ``RUN_OVERRIDES`` asks for ``remat="dots"``: reduced,
    its two steps equal JAX's under the same policy."""
    assert get_run_config("phi3.5-moe-42b-a6.6b").remat == "dots"
    _two_steps_against_jax("phi3.5-moe-42b-a6.6b", "dots")


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that run while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _count_backward(arch, remat):
    """One forward and backward of the reduced ``arch`` (f32) under
    ``remat``: the aten ops of the forward and of the backward pass, and
    the autograd Functions' forwards that ran in the backward pass."""
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat=remat, compute_dtype="float32",
                         **RUN_KW)
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    fwd_calls = collections.Counter()
    in_backward = [False]
    functions = (ops.FlashAttention, tgmm.GroupedMatmul, tssd.SSD)
    originals = [fn.__dict__["forward"] for fn in functions]
    for fn, orig in zip(functions, originals):
        def counted(*args, _orig=orig.__func__, _name=fn.__name__, **kw):
            if in_backward[0]:
                fwd_calls[_name] += 1
            return _orig(*args, **kw)

        fn.forward = staticmethod(counted)
    try:
        loss_fn = make_loss_fn(cfg, run, Ctx(run, "cpu"))
        with _OpCount() as fwd:
            loss, _ = loss_fn(params, batch)
        in_backward[0] = True
        with _OpCount() as bwd:
            loss.backward()
    finally:
        for fn, orig in zip(functions, originals):
            fn.forward = orig
    return fwd.ops, bwd.ops, fwd_calls


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b", "mamba2-370m"])
def test_dots_recomputes_no_2d_product_and_every_batched_one(arch):
    """The backward pass of a ``"dots"`` step runs the same number of 2-D
    matrix products as one under ``"none"`` (the gradients' own: nothing
    of the forward is recomputed), while ``"full"`` runs more; it runs
    every ``aten.bmm`` of the checkpointed layers again, as many as
    ``"full"`` does, and each autograd Function's forward again (one per
    layer and Function), as ``"full"`` does and ``"none"`` does not."""
    counts = {r: _count_backward(arch, r)
              for r in ("none", "full", "dots")}
    mm = {r: sum(counts[r][1][op] for op in MM) for r in counts}
    assert mm["dots"] == mm["none"] < mm["full"]
    bmm = {r: counts[r][1][BMM] for r in counts}
    assert bmm["dots"] == bmm["full"]
    fwd_bmm = counts["none"][0][BMM]
    if fwd_bmm:
        assert bmm["none"] < bmm["dots"]
    calls = {r: counts[r][2] for r in counts}
    assert not calls["none"]
    assert calls["dots"] == calls["full"]
    cfg = reduced(get_model_config(arch))
    want = {"gemma2-2b": {"FlashAttention": cfg.n_layers},
            "olmoe-1b-7b": {"FlashAttention": cfg.n_layers,
                            "GroupedMatmul": 3 * cfg.n_layers},
            "mamba2-370m": {"SSD": cfg.n_layers}}[arch]
    assert dict(calls["dots"]) == want
    # the forward itself runs the same products under every policy
    for op in (*MM, BMM):
        assert counts["dots"][0][op] == counts["full"][0][op] \
            == counts["none"][0][op]


def test_dots_policy_saves_only_the_2d_products():
    """``lm.DOTS_SAVED`` names ``aten.mm`` and ``aten.addmm``; the policy
    keeps them and asks every other op to be recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    assert {str(op) for op in lm.DOTS_SAVED} == set(MM)
    for op in lm.DOTS_SAVED:
        assert lm._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten.empty.memory_format):
        assert lm._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


class _StaleMm(TorchDispatchMode):
    """Scales the first saved 2-D product a recompute takes by 1.01: a
    stale saved output, the fault a wrong ``"dots"`` backward would have."""
    done = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in lm.DOTS_SAVED and not self.done:
            self.done = True
            with _disable_current_modes():    # no op of the recompute
                out = out * 1.01
        return out


def _grads(arch, remat, stale=None):
    """Loss and per-leaf gradients of one forward and backward of the
    reduced ``arch`` (f32) under ``remat``; with ``stale``, the "dots"
    recompute runs under it."""
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat=remat, compute_dtype="float32",
                         **RUN_KW)
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    dots_contexts = lm._dots_contexts

    def planted():
        fwd, rec = dots_contexts()

        @contextlib.contextmanager
        def recompute():
            with rec, stale:
                yield
        return fwd, recompute()

    if stale is not None:
        lm._dots_contexts = planted
    try:
        loss, _ = make_loss_fn(cfg, run, Ctx(run, "cpu"))(params, batch)
        loss.backward()
    finally:
        lm._dots_contexts = dots_contexts
    return float(loss.detach()), [p.grad for p in leaves(params)]


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama3.2-3b"])
def test_dots_gradients_equal_full_and_a_stale_saved_product_shows(arch):
    """The gate ``chip_smoke.py``'s ``[train:dots]`` holds on the card: the
    loss and every leaf's gradient under ``"dots"`` equal ``"full"``'s (bit
    for bit on the CPU), while one saved 2-D product scaled by 1.01 in the
    recompute moves some leaf's gradient by more than 1e-4 in relative
    norm and leaves the loss, which is the forward's, as it was."""
    loss_full, g_full = _grads(arch, "full")
    loss_dots, g_dots = _grads(arch, "dots")
    assert loss_dots == loss_full
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_dots))
    loss_bad, g_bad = _grads(arch, "dots", stale=_StaleMm())
    assert loss_bad == loss_full
    worst = max(float((b - a).norm() / a.norm().clamp_min(1e-30))
                for a, b in zip(g_full, g_bad))
    assert worst > F32_TOL
