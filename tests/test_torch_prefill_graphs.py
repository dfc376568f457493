"""The serving engine's prefill chunk in the prefill lane, one CUDA graph
per chunk size (``repro_torch/serving/engine.py``,
``repro_torch/serving/graphs.py``), on the CPU at reduced size for the
four families (llama3.2-3b, olmoe-1b-7b, mamba2-370m, zamba2-1.2b), dense
and, where the family pages, paged, with a stand-in graph whose replay
runs the captured body again on the tensors it was captured with, as a
graph re-reads its addresses:

  * the lane-based prefill's f32 token streams equal the JAX engine's
    (llama, olmoe, zamba2 dense and paged, mamba2 dense, llama with prefix
    sharing), and every chunk after its size's first use is a replay;
  * the lane commit leaves the cache the eager engine leaves;
  * the forward at a (1,)-tensor row offset equals the int-offset forward
    bit for bit: RoPE positions, cache rows and state, hidden states and
    logits;
  * one capture per distinct chunk size, and none again on a later
    ``start()``, which keeps the address of every lane tensor and buffer;
  * ``ChunkGraph``'s launch totals equal the eager counts for any
    interleaving of prefill and decode replays;
  * a capture that fails raises, and nothing runs eagerly in its place;
  * a prompt that would overrun the cache is refused before any device
    work.

On a card (the ``cuda`` case, which skips here) the graphed engine's
streams and launch counts equal the ``eager=True`` engine's bit for
bit."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.configs.registry import get_run_config as jget_run  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import (get_model_config,  # noqa: E402
                                          get_run_config)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.grouped_matmul import grouped_matmul  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       load_numpy_params)
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

FAMILIES = ["llama3.2-3b", "olmoe-1b-7b", "mamba2-370m", "zamba2-1.2b"]
# every family dense, and paged where it has rows to page (mamba2 refuses)
CASES = [(a, m) for a in FAMILIES for m in ("dense", "paged")
         if (a, m) != ("mamba2-370m", "paged")]
KW = dict(batch_size=3, max_seq=64, prefill_chunk=16, decode_chunk=4)
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8),
         "prefix": dict(paged=True, block_size=8, prefix_sharing=True)}
#: a shared system prefix of two full blocks of 8 and a 3-row tail: every
#: sharer maps two blocks and copies the tail on write
PREFIX = 19


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced engines issue thousands of tiny ops: one intra-op
    thread runs them as fast and leaves the cores to other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _zero_counts():
    tfa.reset_launch_counts()
    yield
    tfa.reset_launch_counts()


def _reqs(cls=Request, seed=0, n=5, prefix_len=0):
    """More requests than slots, prompts of 2 to 39 tokens (chunks of 16
    and every shorter size), budgets that end mid-chunk; with
    ``prefix_len`` every prompt opens with one PREFIX-token prefix."""
    rng = np.random.default_rng(seed)
    head = rng.integers(2, 500, PREFIX).tolist() if prefix_len else []
    return [cls(uid=i, prompt=head + rng.integers(2, 500, int(rng.integers(
                    2, 40 - len(head) // 2))).tolist(),
                max_new_tokens=int(rng.integers(2, 9)), prefix_len=prefix_len)
            for i in range(n)]


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


@pytest.fixture(scope="module")
def pairs():
    """(JAX cfg/run/ctx/params, port cfg/run/ctx/params) per family, f32,
    reduced, on one weight set; made once per family."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = jreduced(jget_cfg(arch))
            jrun = jget_run(arch, remat="none", compute_dtype="float32")
            jctx = JCtx(jrun, RULE_SETS[jrun.rules_name], None)
            jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
            cfg = reduced(get_model_config(arch))
            run = get_run_config(arch, remat="none", compute_dtype="float32")
            params = load_numpy_params(jax.tree.map(np.asarray, jparams),
                                       "cpu")
            made[arch] = ((jcfg, jrun, jctx, jparams),
                          (cfg, run, Ctx(run, "cpu"), params))
        return made[arch]

    return get


class _ReplayBody:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    body again on the tensors it was captured with."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _Captures:
    """``graphs.capture`` without a card: the eager warm-up chunk, then a
    stand-in graph of the same body; counts the captures, prefill and
    decode alike (a CPU engine's ``share`` is None)."""

    def __init__(self):
        self.n = 0

    def __call__(self, body, device, share=None):
        body()
        self.n += 1
        return graphs.ChunkGraph(body, None,
                                 record=lambda b, stream: _ReplayBody(b))


class _PrefillChunks:
    """The engine's ``power=`` hook, counting the prefill chunk programs
    it reports."""

    def __init__(self):
        self.chunks = 0

    @contextlib.contextmanager
    def phase(self, name, calls=None):
        if name == "prefill":
            self.chunks += calls
        yield None


def _graphed(cfg, run, ctx, params, monkeypatch, **kw):
    """A CPU engine on the graphed path with stand-in graphs; returns it
    and the capture counter."""
    captures = _Captures()
    monkeypatch.setattr(graphs, "capture", captures)
    eng = ServeEngine(cfg, run, ctx, params, **kw)
    eng.eager = False
    return eng, captures


def _replays(eng):
    return sum(g.replays for g in eng.prefill_graphs.values())


JAX_CASES = CASES + [("llama3.2-3b", "prefix")]


@pytest.mark.parametrize("arch,mode", JAX_CASES)
def test_lane_prefill_streams_equal_the_jax_engine(pairs, arch, mode,
                                                   monkeypatch):
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = pairs(arch)
    pl = PREFIX if mode == "prefix" else 0
    jeng = JServeEngine(jcfg, jrun, jctx, jparams, **MODES[mode], **KW)
    want = _streams(jeng.generate(_reqs(JRequest, prefix_len=pl)))
    hook = _PrefillChunks()
    eng, _ = _graphed(cfg, run, ctx, params, monkeypatch, power=hook,
                      **MODES[mode], **KW)
    assert _streams(eng.generate(_reqs(prefix_len=pl))) == want
    # every chunk after its size's first use is a replay
    assert _replays(eng) == hook.chunks - len(eng.prefill_graphs) > 0
    if mode == "prefix":
        assert eng.prefill_tokens_skipped == jeng.prefill_tokens_skipped > 0
        assert eng.cow_copies == jeng.cow_copies > 0


def _cache_leaves(eng):
    return {f"{key}.{k}": a for key, leaves in eng._cache.items()
            for k, a in (leaves.items() if isinstance(leaves, dict)
                         else [("", leaves)])}


@pytest.mark.parametrize("arch,mode", CASES)
def test_the_lane_leaves_the_cache_the_eager_engine_leaves(
        pairs, arch, mode, monkeypatch):
    """The lane's commit (rows [0, len) of each dense rows leaf, each state
    leaf whole) and the paged pools written through the staging row leave
    every cache leaf as the eager engine's slot views do."""
    cfg, run, ctx, params = pairs(arch)[1]
    eager = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    eager.generate(_reqs(seed=3))
    eng, _ = _graphed(cfg, run, ctx, params, monkeypatch, **MODES[mode],
                      **KW)
    eng.generate(_reqs(seed=3))
    want, got = _cache_leaves(eager), _cache_leaves(eng)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _chunk_pair(cfg, run, ctx, params, mode):
    """A batch-1 cache after an 8-row chunk at row 0, its copy, and a
    4-row chunk's tokens for row 8."""
    rng = np.random.default_rng(4)
    if mode == "paged":
        cache = lm.init_paged_cache(ctx, cfg, 1, 32, 8, n_blocks=5)
        cache["block_tables"].copy_(torch.tensor([[3, 0, 4, 1]]))
    else:
        cache = lm.init_cache(ctx, cfg, 1, 32)
    first = torch.tensor(rng.integers(2, 500, (1, 8)), dtype=torch.int32)
    lm.forward(ctx, cfg, params, {"tokens": first}, cache=cache,
               cache_index=0)
    twin = {key: (leaves.clone() if torch.is_tensor(leaves)
                  else {k: a.clone() for k, a in leaves.items()})
            for key, leaves in cache.items()}
    return cache, twin, torch.tensor(rng.integers(2, 500, (1, 4)),
                                     dtype=torch.int32)


@pytest.mark.parametrize("arch,mode", CASES)
def test_a_tensor_offset_forward_is_bit_equal_to_the_int_offset(
        pairs, arch, mode):
    cfg, run, ctx, params = pairs(arch)[1]
    offset = torch.tensor([8], dtype=torch.int32)
    pos_int = lm._positions_default(1, 4, "cpu", 8)
    pos_t = lm._positions_default(1, 4, "cpu", offset)
    assert pos_int.dtype == pos_t.dtype and torch.equal(pos_int, pos_t)
    if cfg.use_rope:
        for a, b in zip(L.rope_cos_sin(cfg, pos_int),
                        L.rope_cos_sin(cfg, pos_t)):
            assert torch.equal(a, b)
    cache, twin, toks = _chunk_pair(cfg, run, ctx, params, mode)
    h_int, _, _ = lm.forward(ctx, cfg, params, {"tokens": toks},
                             cache=cache, cache_index=8)
    h_t, _, _ = lm.forward(ctx, cfg, params, {"tokens": toks}, cache=twin,
                           cache_index=offset)
    assert torch.equal(h_int, h_t)
    assert torch.equal(lm.logits_for(ctx, cfg, params, h_int[:, -1:]),
                       lm.logits_for(ctx, cfg, params, h_t[:, -1:]))
    for key, leaves in cache.items():
        for k, a in (leaves.items() if isinstance(leaves, dict)
                     else [("", leaves)]):
            b = twin[key][k] if k else twin[key]
            assert torch.equal(a, b), f"{key}.{k}"
    assert offset.tolist() == [8]            # the offset is only read


def _lane_tensors(eng):
    """Every tensor a prefill graph reads or writes, by name."""
    out = {"offset": eng._offset, "logits": eng._logits}
    out.update({f"tokens{s}": t for s, t in eng._lane_tokens.items()})
    for key, leaves in eng._lane.items():
        if torch.is_tensor(leaves):
            out[key] = leaves
        else:
            out.update({f"{key}.{k}": a for k, a in leaves.items()})
    return out


@pytest.mark.parametrize("arch,mode", CASES)
def test_one_capture_per_chunk_size_and_none_on_a_later_start(
        pairs, arch, mode, monkeypatch):
    """A 31-token prompt is cut 16 + 8 + 4 + 2 + 1: every size once, so
    the first stream captures five prefill graphs and the decode graph,
    and a later stream captures nothing."""
    cfg, run, ctx, params = pairs(arch)[1]
    eng, captures = _graphed(cfg, run, ctx, params, monkeypatch,
                             **MODES[mode], **KW)
    eng.generate([Request(uid=0, prompt=list(range(2, 33)),
                          max_new_tokens=3)])
    assert sorted(eng.prefill_graphs) == [1, 2, 4, 8, 16]
    assert captures.n == 6 and eng.graph is not None
    graphs_before = dict(eng.prefill_graphs)
    eng.generate(_reqs(seed=5))
    assert captures.n == 6
    assert eng.prefill_graphs == graphs_before


@pytest.mark.parametrize("arch,mode", CASES)
def test_a_later_start_keeps_every_lane_address(pairs, arch, mode,
                                                monkeypatch):
    cfg, run, ctx, params = pairs(arch)[1]
    eng, _ = _graphed(cfg, run, ctx, params, monkeypatch, **MODES[mode],
                      **KW)
    eng.generate(_reqs(seed=1))
    ptrs = {k: t.data_ptr() for k, t in _lane_tensors(eng).items()}
    assert set(ptrs) >= {f"tokens{s}" for s in (1, 2, 4, 8, 16)}
    if mode == "paged":
        # the pools are the cache's own, read through the staging row
        assert ptrs["block_tables"] != eng._cache["block_tables"].data_ptr()
        for key, kind in lm.cache_slot_spec(cfg).items():
            if kind == lm.SLOT_ROWS:
                assert eng._lane[key] is eng._cache[key]
    eng.generate(_reqs(seed=2))
    assert {k: t.data_ptr() for k, t in _lane_tensors(eng).items()} == ptrs


# launches per chunk of each captured body: each wrapper adds to its count
# when Python calls it, as it does on the card
BODIES = {"prefill16": {tfa.flash_decode: 2, tfa.cache_update: 2,
                        grouped_matmul: 6, ssd: 3},
          "prefill1": {tfa.flash_decode: 2, tfa.cache_update: 2},
          "decode": {tfa.flash_decode_paged: 2, tfa.cache_update_paged: 2,
                     grouped_matmul: 6}}


def _body(name):
    def run():
        for fn, n in BODIES[name].items():
            fn.launches += n
    return run


class _Inert:
    """A graph's replay runs no Python: no wrapper is called."""

    def replay(self):
        pass


def _record_calling(body, stream):
    body()                     # a capture calls every wrapper of the body
    return _Inert()


def _counts():
    return {fn.__name__: fn.launches for fn in tfa.KERNELS}


@pytest.mark.parametrize("order", [
    "prefill16 decode", "prefill16 prefill1 decode decode",
    "prefill16 prefill16 prefill1 decode prefill16 decode prefill1",
    "decode prefill1 prefill1 prefill1 prefill16 decode decode prefill16"])
def test_replays_of_several_graphs_count_the_eager_launches(order):
    """The first run of each body eager (the warm-up), then its capture,
    then a replay per later run, interleaved as an engine interleaves its
    prefill sizes and decode chunks: the totals equal the eager runs'."""
    runs = order.split()
    for name in runs:
        _body(name)()
    eager = _counts()
    tfa.reset_launch_counts()
    made = {}
    for name in runs:
        if name in made:
            made[name].replay()
            continue
        _body(name)()
        warm = _counts()
        made[name] = graphs.ChunkGraph(_body(name), None,
                                       record=_record_calling)
        assert _counts() == warm                   # the capture adds nothing
        assert made[name].launches == BODIES[name]
    assert _counts() == eager
    assert sum(g.replays for g in made.values()) == len(runs) - len(made)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_a_failed_prefill_capture_raises(pairs, mode, monkeypatch):
    """The capture of the first prefill chunk fails: the error comes out
    of ``generate``, no graph is kept and no chunk runs eagerly in its
    place."""
    cfg, run, ctx, params = pairs("zamba2-1.2b")[1]
    calls = []

    def refuse(b, stream):
        raise RuntimeError("capture refused")

    def capture(body, device, share=None):
        calls.append(body)
        body()                                     # the warm-up chunk
        return graphs.ChunkGraph(body, None, record=refuse)

    monkeypatch.setattr(graphs, "capture", capture)
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    eng.eager = False
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.generate(_reqs())
    assert len(calls) == 1
    assert eng.prefill_graphs == {} and eng.graph is None
    assert eng.finished == [] and eng.sync_count == 0


@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("plen,new", [(64, 1), (60, 5), (70, 1)])
def test_an_overrunning_prompt_is_refused_before_device_work(
        pairs, mode, plen, new, monkeypatch):
    """The lane's tensor offset has no row check: ``_validate_requests``
    refuses a request whose rows would pass ``max_seq`` before any state
    exists, any chunk runs or any graph is captured."""
    cfg, run, ctx, params = pairs("llama3.2-3b")[1]
    eng, captures = _graphed(cfg, run, ctx, params, monkeypatch,
                             **MODES[mode], **KW)
    ok = Request(uid=0, prompt=[5] * 7, max_new_tokens=2)
    bad = Request(uid=1, prompt=[5] * plen, max_new_tokens=new)
    with pytest.raises(ValueError, match="exceeds max_seq 64"):
        eng.generate([ok, bad])
    assert eng._cache is None and eng._lane is None
    assert captures.n == 0 and eng.sync_count == 0


@pytest.fixture
def card():
    """The card and its compiler, or a skip: decided here, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", JAX_CASES)
def test_graphed_prefill_equals_eager_on_the_card(card, arch, mode):
    """bf16, reduced: the graphed engine's streams and kernel launches
    equal the eager engine's bit for bit, every prefill chunk after its
    size's first use is a replay, and the split-KV counters are left at
    zero."""
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    pl = PREFIX if mode == "prefix" else 0
    out = {}
    for eager in (True, False):
        tfa.reset_launch_counts()
        hook = _PrefillChunks()
        eng = ServeEngine(cfg, run, Ctx(run, "cuda"), params, eager=eager,
                          power=hook, **MODES[mode], **KW)
        out[eager] = (_streams(eng.generate(_reqs(prefix_len=pl))),
                      _counts())
        if not eager:
            assert _replays(eng) == hook.chunks - len(eng.prefill_graphs)
            assert eng.graph.replays == eng.sync_count - 1
    assert out[True] == out[False]
    for counters in tfa._counters.values():
        assert not counters.any()
