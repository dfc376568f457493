"""The port's training path on the CPU: its pieces and its train step
against the JAX package on the same numpy inputs and bridged weights, and
the reference's own training tests (``tests/test_integration.py``,
``tests/test_substrate.py``) replayed inside the port."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train.loss import chunked_cross_entropy as jce  # noqa: E402
from repro.train.step import init_state as jinit_state  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs.base import ModelConfig, RunConfig  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       TokenSource)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (load_numpy_params,  # noqa: E402
                                       load_numpy_state)
from repro_torch.runtime.supervisor import (StragglerWatchdog,  # noqa: E402
                                            Supervisor)
from repro_torch.train.compression import \
    int8_compress_decompress  # noqa: E402
from repro_torch.train.loss import chunked_cross_entropy  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCH = "llama3.2-3b"
F32_TOL = 1e-4        # same weights, f32 maths, other summation order
# the run both packages train with: reduced llama3.2-3b in f32
RUN_KW = dict(remat="none", compute_dtype="float32", logits_chunk=16,
              learning_rate=1e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ = 4, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(src, i):
    return {k: torch.from_numpy(v) for k, v in src.batch(i).items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX config, jitted train step (compiled once for the module)
    and initial state."""
    jcfg = jreduced(jget_cfg(ARCH))
    jrun = jget_run(ARCH, **RUN_KW)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    step = jax.jit(jmake_step(jcfg, jrun, jctx))
    state = jinit_state(jcfg, jrun, jax.random.PRNGKey(0)).tree()
    return jcfg, jrun, jctx, step, state


@pytest.fixture(scope="module")
def jax_run3(jax_side):
    """Three JAX steps on TokenSource batches 0..2: states after each and
    metrics."""
    jcfg, _, _, step, st = jax_side
    src = jpipe.TokenSource(jpipe.DataConfig(vocab=jcfg.vocab,
                                             global_batch=BATCH, seq_len=SEQ,
                                             seed=11))
    states, metrics = [st], []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in src.batch(i).items()}
        st, m = step(st, batch)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def _port():
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, **RUN_KW)
    return cfg, run, Ctx(run, "cpu")


def _source(cfg):
    return TokenSource(DataConfig(vocab=cfg.vocab, global_batch=BATCH,
                                  seq_len=SEQ, seed=11))


# ---------------------------------------------------------------------------
# the pieces against the JAX package
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": {"u": rng.standard_normal((3, 4, 7)).astype(np.float32)},
            "b": rng.standard_normal((5,)).astype(np.float32)}


@pytest.mark.parametrize("name", ["AdamW", "Adafactor"])
def test_optimizers_match_jax(name):
    """Three in-place updates against the reference's functional ones,
    parameters and every state leaf (f32 elementwise maths: 1e-6)."""
    kw = dict(lr=optim.warmup_cosine(0.05, 1, 10), weight_decay=0.1)
    jopt, opt = getattr(joptim, name)(lr=joptim.warmup_cosine(0.05, 1, 10),
                                      weight_decay=0.1), \
        getattr(optim, name)(**kw)
    p_np = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = jopt.init(jp)
    tp = tree_map(torch.from_numpy, p_np)
    tst = opt.init(tp)
    for i in range(3):
        g_np = _opt_tree(10 + i)
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, g_np), jst, jp,
                              jnp.asarray(i))
        tp, tst = opt.update(tree_map(torch.from_numpy, g_np), tst, tp, i)
    for a, b in zip(jax.tree.leaves((jp, jst)), leaves({"p": tp, "s": tst})):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g_np = _opt_tree(3)
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np),
                                        max_norm)
    tg, tn = optim.clip_by_global_norm(tree_map(torch.from_numpy, g_np),
                                       max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree.leaves(jg), leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_warmup_cosine_matches_jax():
    jlr = joptim.warmup_cosine(3e-4, 10, 100)
    lr = optim.warmup_cosine(3e-4, 10, 100)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 250):
        assert lr(s) == pytest.approx(float(jlr(s)), rel=1e-6, abs=1e-12)
        assert lr(torch.tensor(s, dtype=torch.int32)) == lr(s)


@pytest.mark.parametrize("chunk,z_loss", [(16, 0.0), (12, 1e-3)],
                         ids=["chunk16", "chunk12-zloss"])
def test_chunked_cross_entropy_matches_jax(jax_side, chunk, z_loss):
    """Loss, metrics and the gradient w.r.t. h (through the checkpointed
    chunks) against the reference; chunk 12 shrinks to 8 for S=32, and
    some labels are padding (-1)."""
    jcfg, jrun, _, _, jstate = jax_side
    jrun = dataclasses.replace(jrun, logits_chunk=chunk)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    cfg, run, _ = _port()
    ctx = Ctx(run.replace(logits_chunk=chunk), "cpu")
    params = load_numpy_params(_np(jstate["params"]), "cpu")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, SEQ)).astype(np.int32)
    labels[0, :5] = -1

    def jloss(hh):
        loss, m = jce(jctx, jcfg, jstate["params"], hh, jnp.asarray(labels),
                      z_loss=z_loss)
        return loss, m

    (jl, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    loss, m = chunked_cross_entropy(ctx, cfg, params, th,
                                    torch.from_numpy(labels), z_loss=z_loss)
    (grad,) = torch.autograd.grad(loss, th)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=F32_TOL)
    assert float(m["ce"].detach()) == pytest.approx(float(jm["ce"]),
                                                  rel=F32_TOL)
    assert float(m["tokens"]) == float(jm["tokens"]) == 2 * SEQ - 5
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6)


@pytest.mark.parametrize("kind", ["synthetic", "file"])
def test_token_source_matches_reference(tmp_path, kind):
    path = None
    if kind == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 500, 4000).astype(
            np.uint16).tofile(path)
    for host in (0, 1):
        kw = dict(vocab=500, global_batch=4, seq_len=16, seed=3, num_hosts=2,
                  host_id=host, kind=kind, path=path)
        a, b = jpipe.TokenSource(jpipe.DataConfig(**kw)), \
            TokenSource(DataConfig(**kw))
        for step in (0, 1, 7):
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a.batch(step)[key],
                                              b.batch(step)[key])


# ---------------------------------------------------------------------------
# the train step against the JAX package
# ---------------------------------------------------------------------------

def _assert_state_close(port_tree, jax_tree, atol):
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pl = leaves(port_tree)
    assert len(jl) == len(pl)
    for (path, a), b in zip(jl, pl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=atol, err_msg=str(path))


# Parameters after three AdamW steps: each step moves an entry by about
# lr * m_hat / sqrt(v_hat) (<= lr = 1e-3 here), a ratio of gradients that
# agree to ~1e-6 relative between the packages; measured max |diff| is
# 4.5e-7 (w_down), so 5e-6 leaves a 10x margin.  Moments: 1e-6.
PARAM_TOL = 5e-6


def test_train_step_matches_jax_over_three_steps(jax_side, jax_run3):
    """The port's make_train_step from the JAX initial state (bridged
    with load_numpy_state) against repro.train.step.make_train_step in
    reference mode: loss and grad_norm at each step, the whole state
    after three."""
    jcfg, _, _, _, jstate = jax_side
    jstates, jmetrics = jax_run3
    cfg, run, ctx = _port()
    state = load_numpy_state(_np(jstate), "cpu")
    step_fn = make_train_step(cfg, run, ctx)
    src = _source(cfg)
    for i in range(3):
        state, m = step_fn(state, _batch(src, i))
        for key in ("loss", "ce", "grad_norm"):
            assert float(m[key]) == pytest.approx(jmetrics[i][key],
                                                  rel=F32_TOL), (i, key)
    assert int(state["step"]) == 3
    _assert_state_close(state["params"], jstates[3]["params"], PARAM_TOL)
    _assert_state_close(state["opt_state"], jstates[3]["opt_state"], 1e-6)


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_side, jax_run3):
    """A checkpoint the JAX package writes after two steps restores into
    the port's state (same leaf paths and format), and the port's third
    step matches JAX's third."""
    jstates, jmetrics = jax_run3
    jckpt.save(jax.device_get(jstates[2]), 2, str(tmp_path))
    cfg, run, ctx = _port()
    template = init_state(cfg, run, torch.Generator().manual_seed(5),
                          "cpu").tree()
    restored, step = checkpoint.restore(str(tmp_path), template)
    assert step == 2 and int(restored["step"]) == 2
    _assert_state_close(restored, jstates[2], 0.0)
    state, m = make_train_step(cfg, run, ctx)(restored,
                                              _batch(_source(cfg), 2))
    assert float(m["loss"]) == pytest.approx(jmetrics[2]["loss"], rel=F32_TOL)
    _assert_state_close(state["params"], jstates[3]["params"], PARAM_TOL)


def test_port_checkpoint_restores_in_jax(tmp_path, jax_side):
    """And the other way: the port's checkpoint restores in the JAX
    package, bit for bit."""
    _, _, _, _, jstate = jax_side
    state = load_numpy_state(_np(jstate), "cpu")
    checkpoint.save(state, 4, str(tmp_path))
    restored, step = jckpt.restore(str(tmp_path), jstate)
    assert step == 4
    for a, b in zip(jax.tree.leaves(restored), leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# inside the port: tests/test_integration.py and tests/test_substrate.py
# ---------------------------------------------------------------------------

CFG = ModelConfig(name="itest", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
RUN = RunConfig(remat="none", logits_chunk=16, learning_rate=1e-2,
                warmup_steps=2, total_steps=40, compute_dtype="float32")


def _itest_state(run=RUN, seed=0):
    return init_state(CFG, run, torch.Generator().manual_seed(seed),
                      "cpu").tree()


def _itest_data(batch=8, seq=32):
    return TokenSource(DataConfig(vocab=CFG.vocab, global_batch=batch,
                                  seq_len=seq, seed=11))


def _run_steps(st, step_fn, data, steps, start=0):
    losses = []
    for i in range(start, start + steps):
        st, m = step_fn(st, _batch(data, i))
        losses.append(float(m["loss"]))
    return st, losses


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_loss_decreases(compression):
    run = RUN.replace(grad_compression=compression)
    step_fn = make_train_step(CFG, run, Ctx(run, "cpu"))
    _, losses = _run_steps(_itest_state(run), step_fn, _itest_data(), 25)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_checkpoint_restart_bit_exact(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, restore, train 3."""
    step_fn = make_train_step(CFG, RUN, Ctx(RUN, "cpu"))
    data = _itest_data()
    straight, _ = _run_steps(_itest_state(), step_fn, data, 6)
    st, _ = _run_steps(_itest_state(), step_fn, data, 3)
    checkpoint.save(st, 3, str(tmp_path))
    fresh = _itest_state(seed=9)
    restored, start = checkpoint.restore(str(tmp_path), fresh)
    resumed, _ = _run_steps(restored, step_fn, data, 3, start=start)
    for a, b in zip(leaves(straight), leaves(resumed)):
        assert torch.equal(a, b)


def test_grad_accum_matches_full_batch():
    """grad_accum=2 over batch 8 == single batch 8 (same grads/updates)."""
    run2 = RUN.replace(grad_accum=2)
    batch = _batch(_itest_data(batch=8), 0)
    s1, m1 = make_train_step(CFG, RUN, Ctx(RUN, "cpu"))(_itest_state(), batch)
    s2, m2 = make_train_step(CFG, run2, Ctx(run2, "cpu"))(_itest_state(),
                                                          batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-3)


def test_remat_full_gives_the_same_step_and_dots_names_its_item():
    """Checkpointed layers recompute the same forward: remat="full" and
    "none" give the same gradients and update."""
    run_full = RUN.replace(remat="full")
    batch = _batch(_itest_data(), 0)
    s1, m1 = make_train_step(CFG, RUN, Ctx(RUN, "cpu"))(_itest_state(), batch)
    s2, m2 = make_train_step(CFG, run_full, Ctx(run_full, "cpu"))(
        _itest_state(), batch)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=1e-6)
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)
    run_dots = RUN.replace(remat="dots")
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        make_train_step(CFG, run_dots, Ctx(run_dots, "cpu"))(_itest_state(),
                                                             batch)


def test_deterministic_training_same_seed():
    outs = []
    for _ in range(2):
        step_fn = make_train_step(CFG, RUN, Ctx(RUN, "cpu"))
        _, losses = _run_steps(_itest_state(), step_fn, _itest_data(), 3)
        outs.append(losses)
    assert outs[0] == outs[1]
    assert tfa.flash_attention.launches == 0   # the CPU path is plain


def _ckpt_state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.ones((3,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_async_and_latest(tmp_path):
    st = _ckpt_state()
    checkpoint.save(st, 1, str(tmp_path), blocking=False).join()
    checkpoint.save(st, 5, str(tmp_path))
    assert checkpoint.available_steps(str(tmp_path)) == [1, 5]
    restored, step = checkpoint.restore(str(tmp_path), st)
    assert step == 5
    for a, b in zip(leaves(restored), leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_corruption_falls_back(tmp_path):
    st = _ckpt_state()
    checkpoint.save(st, 1, str(tmp_path))
    checkpoint.save(st, 2, str(tmp_path))
    d = os.path.join(tmp_path, "step_00000002")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "wb") as f:
        f.write(b"garbage")
    _, step = checkpoint.restore(str(tmp_path), st)
    assert step == 1     # the hash check skipped the corrupt one


def test_checkpoint_partial_write_invisible(tmp_path):
    """A tmp dir (a crash mid-save) is never restored."""
    st = _ckpt_state()
    checkpoint.save(st, 1, str(tmp_path))
    os.makedirs(os.path.join(tmp_path, ".tmp_step_00000009"))
    _, step = checkpoint.restore(str(tmp_path), st)
    assert step == 1
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), st)


def test_prefetcher_orders_steps():
    src = TokenSource(DataConfig(vocab=10, global_batch=2, seq_len=4))
    pf = Prefetcher(src, start_step=3)
    steps = [next(pf)[0] for _ in range(3)]
    pf.stop()
    assert steps == [3, 4, 5]


def test_supervisor_restarts_then_succeeds_or_gives_up():
    calls = []

    def train_fn(restarts):
        calls.append(restarts)
        if len(calls) < 3:
            raise RuntimeError("node died")
        return "done"

    assert Supervisor(max_restarts=5, backoff_s=0.0).run(train_fn) == "done"
    assert calls == [0, 1, 2]
    with pytest.raises(RuntimeError, match="max_restarts"):
        Supervisor(max_restarts=1, backoff_s=0.0).run(
            lambda r: (_ for _ in ()).throw(RuntimeError("boom")))


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(alpha=0.5, threshold=2.0)
    assert not any(wd.observe(i, 0.1) for i in range(5))
    assert wd.observe(5, 0.5)        # 5x the EWMA
    assert wd.events


def test_int8_compression_matches_jax_with_error_feedback():
    """Quantize->dequantize in place against the reference, with and
    without error feedback, and the reference's error bound."""
    g_np = {"w": np.random.default_rng(0).normal(0, 2, (64, 64))
            .astype(np.float32)}
    jd = jcomp.int8_compress_decompress(jax.tree.map(jnp.asarray, g_np))
    td = int8_compress_decompress(tree_map(torch.from_numpy,
                                           {"w": g_np["w"].copy()}))
    np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]),
                               atol=1e-6)
    scale = np.abs(g_np["w"]).max() / 127
    assert np.abs(td["w"].numpy() - g_np["w"]).max() <= scale * 0.5 + 1e-6
    err = {"w": torch.zeros((64, 64))}
    jerr = {"w": jnp.zeros((64, 64))}
    for _ in range(3):
        jd, jerr = jcomp.int8_compress_decompress(
            jax.tree.map(jnp.asarray, g_np), jerr)
        td, err = int8_compress_decompress(
            tree_map(torch.from_numpy, {"w": g_np["w"].copy()}), err)
        np.testing.assert_allclose(td["w"].numpy(), np.asarray(jd["w"]),
                                   atol=1e-6)
        np.testing.assert_allclose(err["w"].numpy(), np.asarray(jerr["w"]),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.count("loss=") == 3 and "grad_norm=" in out
    assert "[throughput]" in out and "completed at step 3" in out
    train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[restore] step 3" in out and out.count("loss=") == 1


def test_launcher_without_cuda_raises(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
