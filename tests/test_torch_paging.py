"""The port's paged KV cache and prefix sharing on the CPU, against the JAX
package: the paged plain versions against the Pallas kernels (interpret
mode) and oracles, paged == dense inside the port, the paged model forward
and the paged / prefix-sharing engines against the JAX engine's token
streams, and the CUDA branch of the two paged wrappers."""

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
from repro.kernels.flash_attention import (  # noqa: E402
    cache_update_paged as jcache_update_paged,
    flash_decode_paged as jflash_decode_paged)
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       load_numpy_params)
from repro_torch.serving import scheduler  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # container fallback
    from _hypothesis_fallback import given, settings, st

ARCH = "llama3.2-3b"
# the reference's stated paged-kernel tolerances (tests/test_kernels.py:172)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
F32_TOL = 1e-4        # model forward: same weights, other summation order


def _pools(n_blocks, bs, K, D, B, max_blocks, seed=0):
    """Random pools and tables mapping each slot's blocks to distinct pool
    blocks, scattered through the pool in interleaved order."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_blocks, bs, K, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, K, D)).astype(np.float32)
    perm = rng.permutation(n_blocks)[:B * max_blocks]
    tables = perm.reshape(max_blocks, B).T.astype(np.int32).copy()
    return k, v, tables


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    # CPU tensors never reach a kernel
    assert all(fn.launches == 0 for fn in tfa.KERNELS)


# ===========================================================================
# plain versions against the JAX package
# ===========================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,Sq", [([5, 16, 31], 1), ([9, 20, 27], 4)])
def test_decode_attention_paged_matches_jax(lens, Sq, dtype):
    B, max_blocks, bs, H, K, D = len(lens), 4, 8, 4, 2, 32
    k, v, tables = _pools(16, bs, K, D, B, max_blocks)
    q = np.random.default_rng(1).standard_normal((B, Sq, H, D)) \
        .astype(np.float32)
    kv_len = np.array(lens, np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (q, k, v)]
    kernel = jflash_decode_paged(*jargs, jnp.asarray(kv_len),
                                 jnp.asarray(tables), interpret=True)
    oracle = jref.decode_attention_paged_ref(*jargs, jnp.asarray(kv_len),
                                             jnp.asarray(tables))
    got = ops.decode_attention_paged(
        *[torch.from_numpy(a).to(td) for a in (q, k, v)],
        torch.from_numpy(kv_len), torch.from_numpy(tables))
    assert got.dtype == td and got.shape == (B, Sq, H, D)
    got = got.float().numpy()
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("softcap,window", [(None, None), (5.0, 8)])
def test_paged_plain_version_equals_dense_plain_version(softcap, window):
    """Paged == dense, exactly: the paged plain version is the dense one
    over the gathered cache, including a done lane (kv_len = S + 1)."""
    B, max_blocks, bs, H, K, D, Sq = 3, 4, 8, 6, 2, 16, 2
    k, v, tables = _pools(14, bs, K, D, B, max_blocks, seed=2)
    q = torch.from_numpy(np.random.default_rng(3)
                         .standard_normal((B, Sq, H, D)).astype(np.float32))
    kv_len = torch.tensor([Sq + 3, 21, max_blocks * bs + 1],
                          dtype=torch.int32)
    kp, vp, tab = (torch.from_numpy(a) for a in (k, v, tables))
    paged = ref.decode_attention_paged_ref(q, kp, vp, kv_len, tab,
                                           softcap=softcap,
                                           local_window=window)
    dense = ref.decode_attention_ref(q, ref.paged_gather_ref(kp, tab),
                                     ref.paged_gather_ref(vp, tab), kv_len,
                                     softcap=softcap, local_window=window)
    assert torch.equal(paged, dense) and torch.isfinite(paged).all()


def test_paged_gather_clips_block_ids_as_the_reference():
    k, _, tables = _pools(6, 4, 1, 8, 2, 3, seed=4)
    tables[0, 2], tables[1, 0] = 99, -3           # outside the pool
    want = jref.paged_gather_ref(jnp.asarray(k), jnp.asarray(tables))
    got = ref.paged_gather_ref(torch.from_numpy(k), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scatter_case(idx, Sn, seed, n_blocks=16, bs=8, K=2, D=16,
                  max_blocks=4):
    B = len(idx)
    k, v, tables = _pools(n_blocks, bs, K, D, B, max_blocks, seed=seed)
    rng = np.random.default_rng(seed + 1)
    kn = rng.standard_normal((B, Sn, K, D)).astype(np.float32)
    vn = rng.standard_normal((B, Sn, K, D)).astype(np.float32)
    return k, v, kn, vn, np.array(idx, np.int32), tables


def _scatter_both(case, dtype):
    """The port's plain paged scatter and the JAX kernel (interpret) and
    oracle on one case; returns (port pools, jax results, input pools)."""
    k, v, kn, vn, index, tables = case
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(kn),
             jnp.asarray(vn), jnp.asarray(index), jnp.asarray(tables))
    want = [jcache_update_paged(*jargs, interpret=True),
            jref.kv_cache_update_paged_ref(*jargs)]
    tk, tv = torch.from_numpy(k).to(td), torch.from_numpy(v).to(td)
    before = tk.clone()
    got = ops.kv_cache_update_paged(tk, tv, torch.from_numpy(kn),
                                    torch.from_numpy(vn),
                                    torch.from_numpy(index),
                                    torch.from_numpy(tables))
    assert got[0] is tk and got[1] is tv             # written in place
    return got, want, before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx", [
    [0, 13, 28],     # block start / mid-block / tail
    [6, 30, 5],      # 6 + 4 rows cross from block 0 into block 1
    [32, -1, 12],    # done slot (the logical end) and negative: dropped
])
def test_cache_update_paged_bit_exact_against_jax(idx, dtype):
    case = _scatter_case(idx, 4, seed=5)
    got, want, before = _scatter_both(case, dtype)
    for w in want:
        for g_t, w_a in zip(got, w):
            np.testing.assert_array_equal(
                g_t.float().numpy(), np.asarray(w_a.astype(jnp.float32)))
    unmapped = sorted(set(range(16)) - set(case[-1].ravel().tolist()))
    assert unmapped
    assert torch.equal(got[0][unmapped], before[unmapped])


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(-1, 32), min_size=1, max_size=3),
       st.integers(1, 5))
def test_cache_update_paged_property(raw_idx, Sn):
    """Any per-slot offsets (valid, boundary, out of range) and any write
    width: bit-exact against the JAX kernel and oracle."""
    case = _scatter_case(raw_idx, Sn, seed=len(raw_idx) * 7 + Sn, K=2, D=8,
                         n_blocks=12)
    got, want, _ = _scatter_both(case, "float32")
    for w in want:
        for g_t, w_a in zip(got, w):
            np.testing.assert_array_equal(g_t.numpy(), np.asarray(w_a))


def test_cache_update_paged_drops_rows_outside_the_pool():
    """A table entry outside the pool never becomes a destination: the
    row is dropped, as the reference oracle's ``mode="drop"``."""
    case = _scatter_case([3, 9], 6, seed=6)
    case[-1][0, 1] = 99                  # slot 0's rows 8..15 -> no block
    k, v, kn, vn, index, tables = case
    want = jref.kv_cache_update_paged_ref(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(index), jnp.asarray(tables))
    got = ref.kv_cache_update_paged_ref(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(index),
        torch.from_numpy(tables))
    for g_t, w_a in zip(got, want):
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(w_a))


# ===========================================================================
# model: init_paged_cache and the paged forward
# ===========================================================================

@pytest.fixture(scope="module")
def f32_pair():
    jcfg = jreduced(jget_cfg(ARCH))
    jrun = jget_run(ARCH, remat="none", compute_dtype="float32")
    jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none", compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jrun, jctx, jparams), (cfg, run, Ctx(run, "cpu"), params)


def test_init_paged_cache_matches_the_reference(f32_pair):
    (jcfg, _, jctx, _), (cfg, _, ctx, _) = f32_pair
    want = jlm.init_paged_cache(jctx, jcfg, 3, 32, 8, n_blocks=13)
    got = lm.init_paged_cache(ctx, cfg, 3, 32, 8, n_blocks=13)
    assert set(got) == set(want) == {"kv", "block_tables"}
    for key in ("k", "v"):
        assert tuple(got["kv"][key].shape) == want["kv"][key].shape
        assert not got["kv"][key].any()
    assert tuple(got["block_tables"].shape) == want["block_tables"].shape
    assert got["block_tables"].dtype == torch.int32
    assert not got["block_tables"].any()                 # start at zero
    default = lm.init_paged_cache(ctx, cfg, 3, 32, 8)["kv"]["k"].shape
    assert default[1] == 3 * 32 // 8 \
        == jlm.init_paged_cache(jctx, jcfg, 3, 32, 8)["kv"]["k"].shape[1]
    with pytest.raises(ValueError, match="multiple of"):
        lm.init_paged_cache(ctx, cfg, 3, 30, 8)


def test_paged_forward_equals_dense_and_the_reference(f32_pair):
    """A batch-2 prefill at a scalar cursor, then a per-slot decode step
    with a done lane: the port's paged forward equals its dense forward
    bit for bit, and the JAX paged forward within 1e-4 (f32)."""
    (jcfg, _, jctx, jparams), (cfg, _, ctx, params) = f32_pair
    B, S, MAX, bs = 2, 9, 32, 8
    max_blocks, n_blocks = MAX // bs, 11
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
    tables = rng.permutation(n_blocks)[:B * max_blocks] \
        .reshape(B, max_blocks).astype(np.int32)
    idx = np.array([S, MAX], np.int32)                 # slot 1: done
    params = lm.prepare_params(ctx, params)

    dense = lm.init_cache(ctx, cfg, B, MAX)
    paged = lm.init_paged_cache(ctx, cfg, B, MAX, bs, n_blocks=n_blocks)
    paged["block_tables"].copy_(torch.from_numpy(tables))
    jpaged = jlm.init_paged_cache(jctx, jcfg, B, MAX, bs, n_blocks=n_blocks)
    jpaged["block_tables"] = jnp.asarray(tables)

    outs = []
    for cache in (dense, paged):
        h0, _, _ = lm.forward(ctx, cfg, params,
                              {"tokens": torch.from_numpy(toks)},
                              cache=cache, cache_index=0)
        h1, _, _ = lm.forward(ctx, cfg, params,
                              {"tokens": torch.from_numpy(nxt)},
                              cache=cache, cache_index=torch.from_numpy(idx))
        outs.append((h0, h1))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1][0], outs[1][1][0])   # the live lane
    assert "block_tables" in paged                      # comes back intact
    np.testing.assert_array_equal(paged["block_tables"].numpy(), tables)

    jh0, _, jpaged = jlm.forward(jctx, jcfg, jparams,
                                 {"tokens": jnp.asarray(toks)},
                                 cache=jpaged, cache_index=0)
    jh1, _, jpaged = jlm.forward(jctx, jcfg, jparams,
                                 {"tokens": jnp.asarray(nxt)},
                                 cache=jpaged, cache_index=jnp.asarray(idx))
    np.testing.assert_allclose(outs[1][0].numpy(), np.asarray(jh0),
                               atol=F32_TOL)
    np.testing.assert_allclose(outs[1][1][0].numpy(), np.asarray(jh1)[0],
                               atol=F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(paged["kv"][key].numpy(),
                                   np.asarray(jpaged["kv"][key]),
                                   atol=F32_TOL)


# ===========================================================================
# engine: paged and prefix-sharing streams
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


def test_paged_streams_equal_the_jax_paged_engine(f32_pair):
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    want = _streams(JServeEngine(jcfg, jrun, jctx, jparams, paged=True,
                                 block_size=8, **KW)
                    .generate(_reqs(JRequest)))
    eng = ServeEngine(cfg, run, ctx, params, paged=True, block_size=8, **KW)
    assert _streams(eng.generate(_reqs())) == want
    assert eng._alloc.used_blocks == 0 and eng.peak_used_blocks > 0


def test_prefix_sharing_streams_equal_dense_and_the_jax_engine(f32_pair):
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    jeng = JServeEngine(jcfg, jrun, jctx, jparams, paged=True, block_size=8,
                        prefix_sharing=True, **KW)
    want = _streams(jeng.generate(_reqs(JRequest, prefix_len=11)))
    dense = _streams(ServeEngine(cfg, run, ctx, params, **KW)
                     .generate(_reqs(prefix_len=11)))
    eng = ServeEngine(cfg, run, ctx, params, paged=True, block_size=8,
                      prefix_sharing=True, **KW)
    got = _streams(eng.generate(_reqs(prefix_len=11)))
    assert got == dense == want
    assert eng.prefill_tokens_skipped == jeng.prefill_tokens_skipped > 0
    assert eng.cow_copies == jeng.cow_copies > 0   # 11 rows: 1 full + tail
    # all slot references returned; only the registry's prefix remains
    assert eng._alloc.used_blocks == eng._alloc.blocks_for(11)
    assert eng.peak_used_blocks == jeng.peak_used_blocks
    # the host-side books end where the reference's end
    assert eng._alloc.state() == jeng._alloc.state()
    assert (eng._registry.hits, eng._registry.misses) \
        == (jeng._registry.hits, jeng._registry.misses)


@pytest.fixture(scope="module")
def port():
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none")          # bf16 compute
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    return cfg, run, Ctx(run, "cpu"), params


def test_paged_equals_dense_at_every_step_and_drains(port):
    """Inside the port, in the working dtype (bf16): dense and paged
    engines agree at EVERY chunk boundary, and the pool drains with no
    leak and every table row parked."""
    cfg, run, ctx, params = port
    dense = ServeEngine(cfg, run, ctx, params, **KW)
    paged = ServeEngine(cfg, run, ctx, params, paged=True, block_size=8, **KW)
    dense.start(_reqs())
    paged.start(_reqs())
    while dense.pending or paged.pending:
        dense.step()
        paged.step()
        live_d = {s.request.uid: list(s.request.generated)
                  for s in dense._sched.active()}
        live_p = {s.request.uid: list(s.request.generated)
                  for s in paged._sched.active()}
        assert live_p == live_d
        assert _streams(paged.finished) == _streams(dense.finished)
    assert len(paged.finished) == 5
    assert paged._alloc.used_blocks == 0
    assert paged._cache["block_tables"].eq(paged.n_blocks).all()


def test_paged_rejects_oversized_and_misaligned(port):
    cfg, run, ctx, params = port
    with pytest.raises(ValueError, match="block_size"):
        ServeEngine(cfg, run, ctx, params, paged=True, block_size=5, **KW)
    with pytest.raises(ValueError, match="requires paged"):
        ServeEngine(cfg, run, ctx, params, prefix_sharing=True, **KW)
    eng = ServeEngine(cfg, run, ctx, params, batch_size=3, max_seq=64,
                      paged=True, block_size=8, n_blocks=4)
    with pytest.raises(ValueError, match="blocks but the pool holds 4"):
        # 20 prompt + 16 new rows span 5 blocks > the 4-block pool:
        # admitting it would deadlock the FCFS gate forever
        eng.start([Request(uid=0, prompt=list(range(2, 22)),
                           max_new_tokens=16)])


def test_paged_admission_waits_for_pool_room(port):
    """A 4-block pool fits one 3-block request at a time: the others wait
    in the queue (FCFS) and every request still gets its tokens.  (The
    reference engine raises "block pool exhausted" here: it gates a whole
    admission round before any of it takes blocks.)"""
    cfg, run, ctx, params = port
    eng = ServeEngine(cfg, run, ctx, params, paged=True, block_size=8,
                      n_blocks=4, **KW)
    reqs = [Request(uid=i, prompt=list(range(2 + i, 14 + i)),
                    max_new_tokens=6) for i in range(3)]
    eng.start(reqs)
    eng.step()
    assert eng.active_slots == 1 and eng.queue_depth == 2
    while eng.pending:
        eng.step()
    assert sorted(len(r.generated) for r in eng.finished) == [6, 6, 6]
    assert eng.peak_used_blocks == 3 and eng._alloc.used_blocks == 0


def test_paged_one_host_sync_per_decode_chunk(port):
    cfg, run, ctx, params = port
    eng = ServeEngine(cfg, run, ctx, params, batch_size=2, max_seq=64,
                      decode_chunk=4, paged=True, block_size=16,
                      prefix_sharing=True)
    fetches = []
    real_fetch = eng._fetch
    eng._fetch = lambda x: (fetches.append(1), real_fetch(x))[1]
    done = eng.generate([Request(uid=i, prompt=[1, 2, 3, 4 + i],
                                 max_new_tokens=10, prefix_len=3)
                         for i in range(2)])
    assert all(len(r.generated) == 10 for r in done)
    assert len(fetches) == 3 == eng.sync_count          # ceil(10 / 4)
    assert eng.prefill_tokens_skipped == 3


def _allocator_tape(mod):
    """One call sequence on a module's BlockAllocator + PrefixRegistry."""
    alloc = mod.BlockAllocator(8, 4)
    reg = mod.PrefixRegistry(alloc)
    toks = list(range(2, 22))
    a = alloc.alloc(3)
    reg.register(toks, 10, a)
    rows, shared = reg.lookup(toks, 12)
    alloc.share(shared[:2])
    alloc.share([shared[2]])
    priv, copied = alloc.ensure_private(shared[2])
    b = alloc.alloc(2)
    alloc.release(a)
    reg.lookup([9] + toks, 12)
    reg.register([7, 7, 7, 7], 4, b[:1])
    reg.evict_for(6)
    alloc.release(shared[:2] + [priv] + b)
    return (alloc.state(), rows, copied, reg.hits, reg.misses,
            list(reg._entries.values()))


def test_allocator_and_registry_end_as_the_reference():
    assert _allocator_tape(scheduler) == _allocator_tape(jsched)


# ===========================================================================
# the CUDA branch of the paged wrappers, and the build
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


def test_paged_cuda_branch_checks_inputs_and_never_falls_back(monkeypatch):
    B, Sq, H, K, D, bs, mb = 2, 1, 4, 2, 32, 8, 3
    q = torch.zeros((B, Sq, H, D)).as_subclass(_OnCuda)
    pool = torch.zeros((7, bs, K, D)).as_subclass(_OnCuda)
    new = torch.zeros((B, 2, K, D)).as_subclass(_OnCuda)
    kv_len = torch.full((B,), 3, dtype=torch.int32)
    idx = torch.zeros((B,), dtype=torch.int32)
    table = torch.zeros((B, mb), dtype=torch.int32)

    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_decode_paged(q.half(), pool.half(), pool.half(), kv_len,
                               table)
    with pytest.raises(TypeError, match="block_tables"):
        tfa.flash_decode_paged(q, pool, pool, kv_len, table.long())
    with pytest.raises(TypeError, match="kv_len"):
        tfa.flash_decode_paged(q, pool, pool, kv_len[:1], table)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_decode_paged(q, pool[..., :16], pool[..., :16], kv_len,
                               table)
    with pytest.raises(TypeError, match="dtypes"):
        tfa.cache_update_paged(pool.half(), pool.half(), new, new, idx,
                               table)
    with pytest.raises(TypeError, match="index"):
        tfa.cache_update_paged(pool, pool, new, new, idx[:1], table)
    with pytest.raises(TypeError, match="block_tables"):
        tfa.cache_update_paged(pool, pool, new, new, idx, table[:1])
    with pytest.raises(ValueError, match="shapes"):
        tfa.cache_update_paged(pool, pool, new[..., :16], new[..., :16],
                               idx, table)
    # a tensor on another device than the rest
    qc = torch.zeros((B, Sq, H, D)).as_subclass(_OnCard)
    pc = torch.zeros((7, bs, K, D)).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="is on cpu"):
        tfa.flash_decode_paged(qc, pc, pc, kv_len, table)
    with pytest.raises(ValueError, match="is on cpu"):
        tfa.cache_update_paged(pc, pc, new.as_subclass(_OnCard), new,
                               idx, table)

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(tfa.build, "library", no_nvcc)
    monkeypatch.setattr(ref, "decode_attention_paged_ref", None)
    monkeypatch.setattr(ref, "kv_cache_update_paged_ref", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_decode_paged(q, pool, pool, kv_len, table)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.cache_update_paged(pool, pool, new, new, idx, table)


def test_build_hashes_every_included_header(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// shared\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("a")] == ["a.cu", "a.cuh", "b.cuh"]
    before = build._target("a")
    (tmp_path / "b.cuh").write_text("// shared, edited\n")
    assert build._target("a") != before


def test_every_kernel_source_is_built_and_declared():
    assert set(build.SIGNATURES) == {"decode_attention",
                                     "decode_attention_paged",
                                     "cache_update", "cache_update_paged",
                                     "flash_attention", "flash_attention_bwd",
                                     "grouped_matmul", "ssd"}
    for name in build.SIGNATURES:
        assert (build.CSRC / f"{name}.cu").exists()
    names = [p.name for p in build.sources("decode_attention_paged")]
    assert names == ["decode_attention_paged.cu", "decode_attention.cuh",
                     "hopper.cuh"]
    assert {fn.__name__ for fn in tfa.KERNELS} == {
        "flash_decode", "flash_decode_paged", "cache_update",
        "cache_update_paged", "flash_attention", "flash_attention_bwd",
        "grouped_matmul", "ssd"}


def test_reduced_config_pages_at_the_reference_shapes(f32_pair):
    """The engine's paged pool at the test shape: n_blocks + 1 blocks
    (the parking block), every table row parked before admission."""
    _, (cfg, run, ctx, params) = f32_pair
    eng = ServeEngine(cfg, run, ctx, params, paged=True, block_size=8, **KW)
    eng.start([])
    assert eng.n_blocks == 3 * 32 // 8
    assert tuple(eng._cache["kv"]["k"].shape) == (
        cfg.n_layers, eng.n_blocks + 1, 8, cfg.n_kv_heads, cfg.head_dim)
    assert eng._cache["block_tables"].eq(eng.n_blocks).all()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jreduced(jget_cfg(ARCH)))
