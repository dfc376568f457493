"""The serving engine's decode chunk in place and as one CUDA graph
(``repro_torch/serving/graphs.py``), on the CPU at reduced size, for the
four families (llama3.2-3b, olmoe-1b-7b, mamba2-370m, zamba2-1.2b), dense
and, where the family pages, paged:

  * the in-place chunk's f32 token streams equal the JAX engine's, on two
    streams of one engine;
  * a later ``start()`` keeps the storage of the cache, the lane vectors,
    ``out`` and the block tables, and its stream equals a fresh engine's;
  * the graphed path (the first chunk eager, then capture, then replays)
    with a stand-in graph whose replay runs the captured body again on
    the tensors it was captured with, as a graph re-reads its addresses:
    the streams equal the eager engine's; a capture that fails raises;
  * the launch accounting of ``ChunkGraph``: a capture adds nothing, and
    the totals equal the eager counts for any number of replays;
  * ``eager=True`` and the default give equal streams on the CPU, where
    no graph is made.

On a card (the ``cuda`` case, which skips here) the graphed engine's
streams and launch counts equal the eager engine's."""

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
MODES = {"dense": {}, "paged": dict(paged=True, block_size=8)}


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


def _reqs(cls=Request, seed=0, n=5):
    """More requests than slots, prompts of mixed lengths (chunks of 16
    and shorter), budgets that end mid-chunk: slots are reused and lanes
    are done for part of a chunk."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(2, 500, int(rng.integers(
                    2, 40))).tolist(), max_new_tokens=int(rng.integers(2, 9)))
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


def _state(eng):
    """Every device tensor the decode chunk reads or writes, by name."""
    out = {"cur": eng._cur, "index": eng._index, "rem": eng._rem,
           "done": eng._done, "out": eng._out}
    for key, leaves in eng._cache.items():
        if key == "block_tables":
            out[key] = leaves
        else:
            out.update({f"{key}.{k}": a for k, a in leaves.items()})
    return out


@pytest.mark.parametrize("arch,mode", CASES)
def test_two_streams_equal_the_jax_engine(pairs, arch, mode):
    """The in-place chunk body, driven by one engine on two streams in
    turn, gives the JAX engine's f32 streams both times."""
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = pairs(arch)
    want = _streams(JServeEngine(jcfg, jrun, jctx, jparams, **MODES[mode],
                                 **KW).generate(_reqs(JRequest)))
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    assert _streams(eng.generate(_reqs())) == want
    assert _streams(eng.generate(_reqs())) == want
    assert {u: len(s) for u, s in want.items()} == {
        r.uid: r.max_new_tokens for r in _reqs()}


@pytest.mark.parametrize("arch,mode", CASES)
def test_a_later_stream_keeps_the_storage_and_equals_a_fresh_engine(
        pairs, arch, mode):
    cfg, run, ctx, params = pairs(arch)[1]
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    eng.generate(_reqs(seed=1))
    ptrs = {k: t.data_ptr() for k, t in _state(eng).items()}
    second = _streams(eng.generate(_reqs(seed=2)))
    assert {k: t.data_ptr() for k, t in _state(eng).items()} == ptrs
    fresh = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    assert second == _streams(fresh.generate(_reqs(seed=2)))
    if mode == "paged":
        assert eng._alloc.used_blocks == 0
        assert eng._cache["block_tables"].eq(eng.n_blocks).all()


class _ReplayBody:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    body again on the tensors it was captured with."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _capture_on_cpu(body, device, share=None):
    """``graphs.capture`` without a card: the eager warm-up chunk, then a
    stand-in graph of the same body."""
    body()
    return graphs.ChunkGraph(body, None,
                             record=lambda b, stream: _ReplayBody(b))


@pytest.mark.parametrize("arch,mode", CASES)
def test_the_graphed_path_gives_the_eager_streams(pairs, arch, mode,
                                                  monkeypatch):
    """The first chunk eager, then one capture and a replay per chunk, on
    two streams of one engine: the eager engine's streams both times."""
    cfg, run, ctx, params = pairs(arch)[1]
    want = _streams(ServeEngine(cfg, run, ctx, params, **MODES[mode],
                                **KW).generate(_reqs()))
    monkeypatch.setattr(graphs, "capture", _capture_on_cpu)
    eng = ServeEngine(cfg, run, ctx, params, **MODES[mode], **KW)
    eng.eager = False
    assert _streams(eng.generate(_reqs())) == want
    first = eng.graph
    assert first is not None and first.replays == eng.sync_count - 1
    assert _streams(eng.generate(_reqs())) == want
    assert eng.graph is first
    assert first.replays == eng.sync_count - 1   # the count of both streams


def test_a_failed_capture_raises(pairs, monkeypatch):
    cfg, run, ctx, params = pairs("llama3.2-3b")[1]

    def refuse(body, device, share=None):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "capture", refuse)
    eng = ServeEngine(cfg, run, ctx, params, **KW)
    eng.eager = False
    with pytest.raises(RuntimeError, match="capture refused"):
        eng.generate(_reqs())
    assert eng.graph is None


@pytest.mark.parametrize("arch", FAMILIES)
def test_eager_and_the_default_give_equal_streams_on_the_cpu(pairs, arch):
    cfg, run, ctx, params = pairs(arch)[1]
    default = ServeEngine(cfg, run, ctx, params, **KW)
    eager = ServeEngine(cfg, run, ctx, params, eager=True, **KW)
    assert default.eager and eager.eager        # the CPU has no graphs
    assert _streams(default.generate(_reqs())) \
        == _streams(eager.generate(_reqs()))
    assert default.graph is None and eager.graph is None


# launches per chunk of a captured body: each wrapper adds to its count
# when Python calls it, as it does on the card
PER_CHUNK = {tfa.flash_decode: 2, tfa.cache_update: 2, grouped_matmul: 6}


def _chunk_body():
    for fn, n in PER_CHUNK.items():
        fn.launches += n


class _Inert:
    """A graph's replay runs no Python: no wrapper is called."""

    def replay(self):
        pass


def _record_calling(body, stream):
    body()                     # a capture calls every wrapper of the body
    return _Inert()


def _counts():
    return {fn.__name__: fn.launches for fn in tfa.KERNELS}


@pytest.mark.parametrize("replays", [1, 3, 8])
def test_replays_count_the_launches_eager_chunks_count(replays):
    for _ in range(1 + replays):
        _chunk_body()
    eager = _counts()
    tfa.reset_launch_counts()
    _chunk_body()                                  # the eager first chunk
    warm = _counts()
    graph = graphs.ChunkGraph(_chunk_body, None, record=_record_calling)
    assert _counts() == warm                       # the capture adds nothing
    assert graph.launches == PER_CHUNK
    for _ in range(replays):
        graph.replay()
    assert _counts() == eager
    assert graph.replays == replays


def test_a_failed_capture_leaves_the_counts_as_they_were():
    def refuse(body, stream):
        body()
        raise RuntimeError("capture refused")

    _chunk_body()
    before = _counts()
    with pytest.raises(RuntimeError, match="capture refused"):
        graphs.ChunkGraph(_chunk_body, None, record=refuse)
    assert _counts() == before


@pytest.fixture
def card():
    """The card and its compiler, or a skip: decided here, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", CASES)
def test_graphed_streams_equal_eager_on_the_card(card, arch, mode):
    """bf16, reduced: the graphed engine's streams and kernel launches
    equal the eager engine's bit for bit, every chunk after the first is a
    replay, and the split-KV counters are left at zero."""
    cfg = reduced(get_model_config(arch))
    run = get_run_config(arch, remat="none")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    out = {}
    for eager in (True, False):
        tfa.reset_launch_counts()
        eng = ServeEngine(cfg, run, Ctx(run, "cuda"), params, eager=eager,
                          **MODES[mode], **KW)
        out[eager] = (_streams(eng.generate(_reqs())), _counts())
        if not eager:
            assert eng.graph.replays == eng.sync_count - 1
    assert out[True] == out[False]
    for counters in tfa._counters.values():
        assert not counters.any()
