"""The port's MoE slice on the CPU against the JAX package, on the same
numpy inputs and bridged weights: the plain ``grouped_matmul`` against the
Pallas kernel (interpret mode) and its oracle, the router / dispatch /
combine against the reference's functions, the MoE forward, prefill and
decode steps, the serving engine's token streams (dense, paged, prefix
sharing), the train step with its aux loss, and the CUDA branch of the
``grouped_matmul`` wrapper."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grouped_matmul import \
    grouped_matmul as jgrouped_matmul  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro.train.step import init_state as jinit_state  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.data.pipeline import DataConfig, TokenSource  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import grouped_matmul as tgmm  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (PD, init_params,  # noqa: E402
                                       load_numpy_params, load_numpy_state,
                                       param_count)
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "olmoe-1b-7b"
ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
F32_TOL = 1e-4        # model forward: same weights, other summation order
# router / dispatch / combine in f32 from the same inputs: the products and
# sums differ only in order (D = 128 terms), far below 1e-5
MOE_TOL = 1e-5
# the reference's GMM_SHAPES (tests/test_kernels.py:312) plus the reduced
# configs' expert shapes (d_model 128, d_ff 256) at a decode-sized and an
# odd capacity
GMM_SHAPES = [(4, 64, 32, 48, 32, 16, 16), (2, 100, 72, 130, 32, 32, 64),
              (8, 16, 128, 16, 16, 64, 16), (8, 2, 128, 256, 128, 512, 512),
              (8, 5, 256, 128, 128, 512, 512)]


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


def _jax_side(arch, dtype="float32", **run_kw):
    jcfg = jreduced(jget_cfg(arch))
    jrun = jget_run(arch, remat="none", compute_dtype=dtype, **run_kw)
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    return jcfg, jrun, jctx, jparams


def _pair(arch=ARCH, dtype="float32"):
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) on one weight
    set, reduced config."""
    jcfg, jrun, jctx, jparams = _jax_side(arch, dtype)
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat="none", compute_dtype=dtype)
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# ===========================================================================
# grouped_matmul: the plain version against the Pallas kernel and oracle
# ===========================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,M,K,N,bm,bk,bn", GMM_SHAPES)
def test_grouped_matmul_matches_jax(G, M, K, N, bm, bk, bn, dtype):
    """f32: the same f32 products summed in another order -> 1e-4 (the
    reference's own f32 bound for this kernel).  bf16: both round f32 sums
    that differ only in order, so they are equal or one bf16 ulp apart
    (<= 2^-7 |want|), plus 1e-3 for sums that cancel to near zero."""
    rng = np.random.default_rng(G * M + K)
    lhs = rng.standard_normal((G, M, K)).astype(np.float32)
    rhs = rng.standard_normal((G, K, N)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jl, jr = jnp.asarray(lhs, jd), jnp.asarray(rhs, jd)
    kernel = jgrouped_matmul(jl, jr, block_m=bm, block_k=bk, block_n=bn,
                             interpret=True)
    oracle = jref.grouped_matmul_ref(jl, jr)
    got = ops.grouped_matmul(torch.from_numpy(lhs).to(td),
                             torch.from_numpy(rhs).to(td))
    assert got.dtype == td and tuple(got.shape) == (G, M, N)
    rtol, atol = (1e-4, 1e-4) if dtype == "float32" else (2 ** -7, 1e-3)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)


def test_cpu_tensors_never_launch():
    a, b = torch.ones((2, 3, 8)), torch.ones((2, 8, 16))
    out = ops.grouped_matmul(a, b)
    assert torch.equal(out, torch.full((2, 3, 16), 8.0))
    assert tgmm.grouped_matmul.launches == 0
    assert tgmm.grouped_matmul in tfa.KERNELS


# ===========================================================================
# router, dispatch and combine against the reference's functions
# ===========================================================================

@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_router_dispatch_combine_match_jax(capacity_factor):
    """f32, reduced olmoe (8 experts, top-2), 24 tokens.  At the model's
    own capacity factor 1.25 (capacity 8 for a mean load of 6) some
    assignments are dropped; at 8.0 none are."""
    jcfg = dataclasses.replace(jreduced(jget_cfg(ARCH)),
                               capacity_factor=capacity_factor)
    cfg = dataclasses.replace(reduced(get_model_config(ARCH)),
                              capacity_factor=capacity_factor)
    B, S, D, E = 2, 12, cfg.d_model, cfg.n_experts
    T = B * S
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5,
         "w_gate": rng.standard_normal((E, D, cfg.d_ff)).astype(np.float32)
         * D ** -0.5,
         "w_up": rng.standard_normal((E, D, cfg.d_ff)).astype(np.float32)
         * D ** -0.5,
         "w_down": rng.standard_normal((E, cfg.d_ff, D)).astype(np.float32)
         * cfg.d_ff ** -0.5}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xf = x.reshape(T, D)

    jtop_p, jtop_e, jaux = jL._moe_router(jcfg, jp, jnp.asarray(xf))
    top_p, top_e, aux = L._moe_router(cfg, tp, torch.from_numpy(xf))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p),
                               atol=MOE_TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=MOE_TOL)

    cap = int(np.ceil(T * cfg.top_k * capacity_factor / E))
    jin, jflat, jslot, jkeep = jL._moe_dispatch_local(
        jcfg, jnp.asarray(xf), jtop_e, cap)
    tin, flat, slot, keep = L._moe_dispatch_local(cfg, torch.from_numpy(xf),
                                                  top_e, cap)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))  # 0 + x
    assert (not keep.all()) if capacity_factor == 1.25 else keep.all()

    out = np.random.default_rng(4).standard_normal(
        (E, cap, D)).astype(np.float32)
    jy = jL._moe_combine_local(jnp.asarray(out), jflat, jslot, jkeep,
                               jtop_p, B, S)
    y = L._moe_combine_local(torch.from_numpy(out), flat, slot, keep, top_p,
                             B, S)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_TOL)

    jrun = jget_run(ARCH, compute_dtype="float32")
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    run = get_run_config(ARCH, compute_dtype="float32")
    jy, jaux = jL.apply_moe(jctx, jcfg, jp, jnp.asarray(x))
    y, aux = L.apply_moe(Ctx(run, "cpu"), cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=MOE_TOL)
    assert float(aux) == pytest.approx(float(jaux), abs=MOE_TOL)


# ===========================================================================
# configs, parameters and the model
# ===========================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_decls_mirror_the_reference(arch):
    assert dataclasses.asdict(get_model_config(arch)) \
        == dataclasses.asdict(jget_cfg(arch))
    assert dataclasses.asdict(get_run_config(arch)) \
        == dataclasses.asdict(jget_run(arch))
    cfg = reduced(get_model_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jreduced(
        jget_cfg(arch)))
    decls = lm.model_decls(cfg)
    jdecls = jlm.model_decls(jreduced(jget_cfg(arch)))
    shapes = jax.tree.map(lambda pd: tuple(pd.shape), decls,
                          is_leaf=lambda x: isinstance(x, PD))
    jshapes = jax.tree.map(lambda pd: tuple(pd.shape), jdecls,
                           is_leaf=lambda x: hasattr(x, "axes"))
    assert shapes == jshapes
    assert tuple(decls["layers"]["mlp"]["w_gate"].shape) == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)


def test_init_params_std_of_the_expert_leaves_matches_reference():
    """The (L, E, D, F) leaves and the router carry explicit scales, so
    their stds are d^-0.5 (w_gate, w_up, router) and f^-0.5 (w_down), as
    the reference's; load_numpy_params keeps shapes and dtypes."""
    cfg = reduced(get_model_config(ARCH), n_layers=2, d_model=256, d_ff=512)
    p = init_params(lm.model_decls(cfg), torch.Generator().manual_seed(0),
                    "cpu")["layers"]["mlp"]
    jcfg = jreduced(jget_cfg(ARCH), n_layers=2, d_model=256, d_ff=512)
    jp = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    jmlp = jp["layers"]["mlp"]
    d, f = cfg.d_model, cfg.d_ff
    for key, std in (("w_gate", d ** -0.5), ("w_up", d ** -0.5),
                     ("w_down", f ** -0.5), ("router", d ** -0.5)):
        assert p[key].std().item() == pytest.approx(std, rel=0.05), key
        assert p[key].std().item() == pytest.approx(
            float(jnp.std(jmlp[key])), rel=0.05), key
    bridged = load_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    assert bridged["layers"]["mlp"]["w_down"].shape == (2, 8, f, d)
    assert bridged["layers"]["mlp"]["w_down"].dtype == torch.float32
    assert param_count(lm.model_decls(get_model_config(ARCH))) == 6919096320


def test_prepare_params_keeps_the_router_float32():
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH)                         # bf16 compute
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    mlp = lm.prepare_params(Ctx(run, "cpu"), params)["layers"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["w_gate"].dtype == mlp["w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_match_reference(arch):
    """Reduced olmoe (rmsnorm, H = K) and reduced phi3.5-moe (layernorm,
    GQA), f32: hidden states, logits and the summed aux loss."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = _pair(arch)
    toks = _tokens(2, 12, cfg.vocab)
    jh, jaux, _ = jlm.forward(jctx, jcfg, jparams,
                              {"tokens": jnp.asarray(toks)})
    jlog = jlm.logits_for(jctx, jcfg, jparams, jh)
    h, aux, _ = lm.forward(ctx, cfg, params, {"tokens": torch.from_numpy(toks)})
    logits = lm.logits_for(ctx, cfg, params, h)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                               atol=F32_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=MOE_TOL)
    assert float(aux) > 0


def test_prefill_and_decode_steps_match_reference(f32_pair):
    """make_prefill_step, then a scalar-index and a per-slot decode step
    with a done lane (capacity 1 at 3 tokens: drops)."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    B, S, MAX = 3, 9, 32
    toks = _tokens(B, S, cfg.vocab)
    jpre = jengine.make_prefill_step(jcfg, jrun, jctx, MAX)
    jdec = jengine.make_decode_step(jcfg, jrun, jctx)
    params = lm.prepare_params(ctx, params)
    pre = engine.make_prefill_step(cfg, run, ctx, MAX)
    dec = engine.make_decode_step(cfg, run, ctx)

    jcache, jlog = jpre(jparams, {"tokens": jnp.asarray(toks)})
    cache, log = pre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=F32_TOL)

    nxt = np.array(jnp.argmax(jlog[:, 0], -1), np.int32)[:, None]
    jcache, jlog = jdec(jparams, jcache, jnp.asarray(nxt),
                        jnp.asarray(S, jnp.int32))
    cache, log = dec(params, cache, torch.from_numpy(nxt), S)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=F32_TOL)

    idx = np.array([S + 1, S + 1, MAX], np.int32)      # last lane: done
    jcache, jlog = jdec(jparams, jcache, jnp.asarray(nxt), jnp.asarray(idx))
    cache, log = dec(params, cache, torch.from_numpy(nxt),
                     torch.from_numpy(idx))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["kv"][key].numpy(),
                                   np.asarray(jcache["kv"][key]),
                                   atol=F32_TOL)


# ===========================================================================
# the serving engine
# ===========================================================================

def _reqs(cls=Request, prefix_len=0, n=5):
    """The reference's paging workload (tests/test_paging.py:196)."""
    prefix = [(7 * j + 5) % 97 + 2 for j in range(11)]
    out = []
    for i in range(n):
        suffix = [(13 * i + 3 * j + 1) % 97 + 2 for j in range(3 + i)]
        prompt = prefix[:prefix_len] + suffix if prefix_len \
            else prefix + suffix
        out.append(cls(uid=i, prompt=prompt, max_new_tokens=4 + i % 3,
                       prefix_len=prefix_len))
    return out


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


KW = dict(batch_size=3, max_seq=32, prefill_chunk=8, decode_chunk=4)
MODES = {"dense": {},
         "paged": dict(paged=True, block_size=8),
         "prefix": dict(paged=True, block_size=8, prefix_sharing=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_token_streams_equal_the_jax_engine(f32_pair, mode, monkeypatch):
    """f32, reduced olmoe at capacity factor 1.25: the port's streams
    equal the JAX engine's, and capacity drops did happen (at a batch-3
    decode step the capacity is 1: 6 assignments over 8 experts)."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    prefix_len = 11 if mode == "prefix" else 0
    jeng = JServeEngine(jcfg, jrun, jctx, jparams, **MODES[mode], **KW)
    want = _streams(jeng.generate(_reqs(JRequest, prefix_len)))
    dropped = []
    real = L._moe_dispatch_local

    def counting(*args):
        res = real(*args)
        dropped.append(int((~res[3]).sum()))
        return res

    monkeypatch.setattr(L, "_moe_dispatch_local", counting)
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    got = _streams(eng.generate(_reqs(Request, prefix_len)))
    assert got == want
    assert [len(got[i]) for i in range(5)] == [4 + i % 3 for i in range(5)]
    assert sum(dropped) > 0
    if mode == "prefix":
        assert eng.prefill_tokens_skipped == jeng.prefill_tokens_skipped > 0
        assert eng._alloc.state() == jeng._alloc.state()


def _reuse_reqs(cls=Request, n=24, seed=0):
    """More requests than slots, of mixed lengths: slots are reused, and
    lanes finish mid-chunk while others run."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, 500, int(rng.integers(3, 40)))
                .tolist(), max_new_tokens=int(rng.integers(2, 20)))
            for i in range(n)]


REUSE_KW = dict(batch_size=8, max_seq=64, prefill_chunk=16, decode_chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_equals_dense_bit_for_bit(dtype):
    """Inside the port the paged engine's streams equal the dense
    engine's at every chunk boundary, bit for bit, where nothing couples a
    lane to the others: at capacity factor E/top_k no assignment is
    dropped, so each live lane's output depends on its own rows alone."""
    base = reduced(get_model_config(ARCH))
    cfg = dataclasses.replace(base, capacity_factor=base.n_experts
                              / base.top_k)
    run = get_run_config(ARCH, remat="none", compute_dtype=dtype)
    ctx = Ctx(run, "cpu")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(1), "cpu")
    dense = ServeEngine(cfg, run, ctx, params, **REUSE_KW)
    paged = ServeEngine(cfg, run, ctx, params, paged=True, block_size=8,
                        **REUSE_KW)
    dense.start(_reuse_reqs())
    paged.start(_reuse_reqs())
    while dense.pending or paged.pending:
        dense.step()
        paged.step()
        assert _streams(paged.finished) == _streams(dense.finished)
        assert {s.request.uid: list(s.request.generated)
                for s in paged._sched.active()} \
            == {s.request.uid: list(s.request.generated)
                for s in dense._sched.active()}
    assert len(paged.finished) == 24 and paged._alloc.used_blocks == 0


def test_done_lanes_split_paged_from_dense_as_in_the_reference(f32_pair):
    """A reference quirk the port keeps: at capacity factor 1.25 a done
    lane still takes part in routing (token 0 at index max_seq), and its
    attention reads its slot's stale rows -- the dense cache's and the
    pool's differ -- so its routing, and through capacity the live lanes'
    outputs, differ between the dense and the paged engine.  The port's
    streams equal the JAX engine's in each mode, and dense and paged
    part in both packages alike."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    out = {}
    for mode, kw in (("dense", {}), ("paged", MODES["paged"])):
        out["jax", mode] = _streams(JServeEngine(
            jcfg, jrun, jctx, jparams, **kw, **REUSE_KW)
            .generate(_reuse_reqs(JRequest)))
        out["port", mode] = _streams(ServeEngine(
            cfg, run, ctx, params, **kw, **REUSE_KW).generate(_reuse_reqs()))
        assert out["port", mode] == out["jax", mode]
    apart = {u for u in out["jax", "dense"]
             if out["jax", "dense"][u] != out["jax", "paged"][u]}
    assert apart and apart == {u for u in out["port", "dense"]
                               if out["port", "dense"][u]
                               != out["port", "paged"][u]}


def test_one_host_sync_per_decode_chunk():
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, run, Ctx(run, "cpu"), params, batch_size=2,
                      max_seq=64, decode_chunk=4)
    fetches = []
    real_fetch = eng._fetch
    eng._fetch = lambda x: (fetches.append(1), real_fetch(x))[1]
    done = eng.generate([Request(uid=i, prompt=[1 + i, 2, 3],
                                 max_new_tokens=10) for i in range(2)])
    assert all(len(r.generated) == 10 for r in done)
    assert len(fetches) == 3 == eng.sync_count          # ceil(10 / 4)


def test_launcher_serves_olmoe_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                       "--requests", "3", "--new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert out.count("3 tokens ->") == 3
    assert "[throughput] 9 tokens" in out and "on cpu" in out


# ===========================================================================
# training: the aux loss in the loss
# ===========================================================================

RUN_KW = dict(logits_chunk=16, learning_rate=1e-3, warmup_steps=2,
              total_steps=10)
# parameters after two AdamW steps: as tests/test_torch_training.py (each
# step moves an entry by <= lr = 1e-3 times a ratio of gradients that
# agree to ~1e-6 relative between the packages)
PARAM_TOL = 5e-6


def _batches(cfg, n):
    src = TokenSource(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=16,
                                 seed=11))
    return [src.batch(i) for i in range(n)]


def test_train_step_matches_jax_over_two_steps():
    """Reduced olmoe in f32 from the JAX initial state: loss (cross
    entropy + router_aux_weight * aux), ce, aux and grad norm per step,
    and the whole state after two steps."""
    jcfg, jrun, jctx, _ = _jax_side(ARCH, **RUN_KW)
    jstate = jinit_state(jcfg, jrun, jax.random.PRNGKey(0)).tree()
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none", compute_dtype="float32",
                         **RUN_KW)
    state = load_numpy_state(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jmake_step(jcfg, jrun, jctx))
    step = make_train_step(cfg, run, Ctx(run, "cpu"))
    for batch in _batches(cfg, 2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]),
                                                  rel=F32_TOL), key
        assert float(m["loss"]) == pytest.approx(
            float(m["ce"]) + cfg.router_aux_weight * float(m["aux"]),
            rel=1e-6)
    jl = jax.tree_util.tree_flatten_with_path(jstate["params"])[0]
    for (path, a), b in zip(jl, leaves(state["params"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=PARAM_TOL, err_msg=str(path))


def test_remat_full_sums_the_aux_loss_too():
    """The checkpointed forward (remat="full") gives the same loss, aux
    and update as remat="none"."""
    cfg = reduced(get_model_config(ARCH))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    out = []
    for remat in ("none", "full"):
        run = get_run_config(ARCH, remat=remat, compute_dtype="float32",
                             **RUN_KW)
        from repro_torch.train.step import init_state
        st = init_state(cfg, run, torch.Generator().manual_seed(0),
                        "cpu").tree()
        st, m = make_train_step(cfg, run, Ctx(run, "cpu"))(st, batch)
        out.append((st, m))
    (s1, m1), (s2, m2) = out
    for key in ("loss", "aux", "grad_norm"):
        assert float(m1[key]) == pytest.approx(float(m2[key]), rel=1e-6)
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


# ===========================================================================
# the CUDA branch of the wrapper, and the build
# ===========================================================================

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach a wrapper's CUDA
    branch without a card."""

    @property
    def is_cuda(self):
        return True


class _OnCard(_OnCuda):
    """... that also reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_branch_checks_inputs_and_never_falls_back(monkeypatch):
    lhs = torch.zeros((4, 3, 16)).as_subclass(_OnCuda)
    rhs = torch.zeros((4, 16, 32)).as_subclass(_OnCuda)
    with pytest.raises(TypeError, match="dtypes"):
        tgmm.grouped_matmul(lhs.half(), rhs.half())
    with pytest.raises(TypeError, match="dtypes"):
        tgmm.grouped_matmul(lhs, rhs.bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        tgmm.grouped_matmul(lhs, rhs[:, :8])
    with pytest.raises(ValueError, match="multiples of 8"):
        tgmm.grouped_matmul(lhs[..., :12].contiguous(),
                            rhs[:, :12].contiguous())
    with pytest.raises(ValueError, match="multiples of 8"):
        tgmm.grouped_matmul(lhs, rhs[..., :20].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tgmm.grouped_matmul(lhs, rhs.transpose(1, 2).contiguous()
                            .transpose(1, 2)[:, :, :32])
    with pytest.raises(ValueError, match="is on cpu"):
        tgmm.grouped_matmul(lhs.as_subclass(_OnCard), rhs)
    # no backward kernel: a call autograd would differentiate raises
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        tgmm.grouped_matmul(lhs, rhs.clone().requires_grad_())

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tgmm.build, "library", no_nvcc)
    monkeypatch.setattr(ref, "grouped_matmul", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tgmm.grouped_matmul(lhs, rhs)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="nvcc"):
            tgmm.grouped_matmul(lhs, rhs.clone().requires_grad_())
    assert tgmm.grouped_matmul.launches == 0


def test_kernel_source_is_declared_and_hashed():
    assert build.SIGNATURES["grouped_matmul"][0] == "grouped_matmul"
    assert [p.name for p in build.sources("grouped_matmul")] \
        == ["grouped_matmul.cu", "hopper.cuh"]
    assert (build.CSRC / "grouped_matmul.cu").exists()
