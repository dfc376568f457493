"""The port's ServeEngine on the CPU: token streams equal to the JAX
engine's on the same weights, continuous batching equal to solo serving,
one host sync per decode chunk, the power hook, tracer spans, and entry
points that refuse to run on a missing card."""

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
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       load_numpy_params)
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "llama3.2-3b"
# the reference's continuous-batching workload (tests/test_serving.py:147)
MIXED_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [2, 4],
                 [9, 8, 7, 6, 5], [3, 1, 4, 1, 5, 9, 2, 6, 5]]
MIXED_NEW = [4, 6, 3, 5, 2]


def _reqs(cls=Request):
    return [cls(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(MIXED_PROMPTS, MIXED_NEW))]


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


@pytest.fixture(scope="module")
def port():
    cfg = reduced(get_model_config(ARCH))
    run = get_run_config(ARCH, remat="none")          # bf16 compute
    ctx = Ctx(run, "cpu")
    params = init_params(lm.model_decls(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    return cfg, run, ctx, params


def test_token_streams_equal_the_jax_engine(f32_pair):
    (jcfg, jrun, jctx, jparams), (cfg, run, ctx, params) = f32_pair
    kw = dict(batch_size=3, max_seq=32, decode_chunk=4, prefill_chunk=4)
    want = {r.uid: r.generated for r in JServeEngine(
        jcfg, jrun, jctx, jparams, **kw).generate(_reqs(JRequest))}
    got = {r.uid: r.generated for r in ServeEngine(
        cfg, run, ctx, params, **kw).generate(_reqs())}
    assert got == want
    assert [len(got[i]) for i in range(len(MIXED_NEW))] == MIXED_NEW


def test_continuous_batching_matches_solo(port):
    cfg, run, ctx, params = port
    batched = {r.uid: r.generated for r in ServeEngine(
        cfg, run, ctx, params, batch_size=3, max_seq=32,
        decode_chunk=4).generate(_reqs())}
    for req in _reqs():
        solo = ServeEngine(cfg, run, ctx, params, batch_size=1, max_seq=32,
                           decode_chunk=4).generate([req])[0]
        assert batched[req.uid] == solo.generated, req.uid
        assert all(0 <= t < cfg.vocab for t in solo.generated)


def test_one_host_sync_per_decode_chunk(port):
    cfg, run, ctx, params = port
    eng = ServeEngine(cfg, run, ctx, params, batch_size=2, max_seq=64,
                      decode_chunk=4)
    fetches = []
    real_fetch = eng._fetch
    eng._fetch = lambda x: (fetches.append(1), real_fetch(x))[1]
    done = eng.generate([Request(uid=i, prompt=[1 + i, 2, 3],
                                 max_new_tokens=10) for i in range(2)])
    assert all(len(r.generated) == 10 for r in done)
    assert len(fetches) == 3 == eng.sync_count          # ceil(10 / 4)


class _Rec:
    """Stands in for a power manager: records each phase entry."""

    def __init__(self):
        self.entries = []

    @contextlib.contextmanager
    def phase(self, name, calls=None):
        self.entries.append((name, calls))
        yield None


def test_power_hook_entered_per_prefill_and_decode_chunk(port):
    cfg, run, ctx, params = port
    pm = _Rec()
    eng = ServeEngine(cfg, run, ctx, params, batch_size=2, max_seq=64,
                      power=pm, decode_chunk=4, prefill_chunk=4)
    eng.generate([Request(uid=0, prompt=list(range(1, 8)), max_new_tokens=8),
                  Request(uid=1, prompt=[5, 6], max_new_tokens=8)])
    # prompt 7 -> chunks [4, 2, 1]; prompt 2 -> [2]; 8 tokens -> 2 chunks
    assert pm.entries == [("prefill", 3), ("prefill", 1),
                          ("decode", 4), ("decode", 4)]


def test_tracer_spans_emitted(port):
    cfg, run, ctx, params = port
    tr = Tracer()
    eng = ServeEngine(cfg, run, ctx, params, batch_size=2, max_seq=32,
                      decode_chunk=4, tracer=tr, trace_track="n0")
    eng.generate([Request(uid=i, prompt=[1 + i, 2], max_new_tokens=3)
                  for i in range(3)])
    assert [e.args["uid"] for e in tr.instants_by_name("submit")] == [0, 1, 2]
    phases = tr.spans_by_cat("phase")
    assert sorted(s.args["uid"] for s in phases if s.name == "prefill") \
        == [0, 1, 2]
    decodes = [s for s in phases if s.name == "decode"]
    chunks = tr.spans_by_cat("chunk")
    assert len(decodes) == len(chunks) == eng.sync_count
    assert all(s.track == "n0" and s.t1 > s.t0 for s in phases + chunks)


def test_submit_queue_depth_and_active_slots(port):
    cfg, run, ctx, params = port
    eng = ServeEngine(cfg, run, ctx, params, batch_size=2, max_seq=32,
                      decode_chunk=2)
    assert not eng.pending and eng.queue_depth == 0
    eng.submit([Request(uid=i, prompt=[1, 2], max_new_tokens=4)
                for i in range(3)])
    assert eng.queue_depth == 3 and eng.active_slots == 0
    eng.step()
    assert eng.queue_depth == 1 and eng.active_slots == 2
    while eng.pending:
        eng.step()
    assert sorted(r.uid for r in eng.finished) == [0, 1, 2]
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([Request(uid=9, prompt=[1] * 30, max_new_tokens=8)])


def test_an_idle_engine_drains_and_checkpoints_nothing(port):
    """The reference's idle-engine behaviour: with no stream, ``drain`` and
    ``checkpoint`` return no snapshot and ``abandon`` returns None."""
    cfg, run, ctx, params = port
    for paged in (False, True):
        eng = ServeEngine(cfg, run, ctx, params, paged=paged)
        assert eng.drain() == [] and eng.checkpoint() == []
        assert eng.abandon() is None
        assert not eng.pending and eng.queue_depth == 0


def test_default_device_entry_points_raise_without_cuda(port,
                                                        monkeypatch):
    cfg, run, _, params = port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, run, Ctx(run), params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(lm.model_decls(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--requests", "1"])


def test_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--requests", "3", "--new", "3",
                       "--max-seq", "32"])
    out = capsys.readouterr().out
    assert out.count("3 tokens ->") == 3
    assert "[throughput] 9 tokens" in out and "on cpu" in out
