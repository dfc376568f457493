"""The fleet over real engines, and the engine's benchmark interface, in the
port against the JAX package: reduced f32 llama3.2-3b (and mamba2-370m
for the crash replay), the JAX engines and the port's CPU engines on one
weight set (``models/params.load_numpy_params``):

  * ``ServeJob(engine=...)`` as ``tests/test_fleet.py`` drives it: to
    completion, a preemption that migrates the in-flight tokens, and the
    drop-and-restart mode: the fleet counters, the job's state after
    every move and the token streams equal;
  * ``tests/test_faults.py``'s crash replay: a shadow checkpoint at every
    chunk boundary, doomed decode, ``abandon``, the shadow restored on a
    fresh engine: every stream equals the JAX engine's uninterrupted one;
    the checkpoint is non-destructive and repeatable; an int8 shadow's
    restore equals the JAX engine's int8 restore and stays within the
    reference's 25 % edit-distance gate;
  * ``benchmarks/traffic_slo.py``'s engine arm (two paged engines, open
    loop, admission and the autoscaler, seed 0): equal fleet counters,
    SLO summaries and streams;
  * ``capacity_hint`` equal to the JAX engine's at every step of a dense
    and of a paged run (a tight pool, a slot limit, a drain);
  * ``completion_s`` holds every finished uid, on the eager engine, on
    the graphed path with a stand-in graph, and across a drain/restore;
  * ``StaticServeEngine``'s tokens equal ``repro.serving.legacy``'s over
    mixed prompt lengths;
  * ``chip_smoke.py``'s ``[fleet:engine]`` scenario at reduced size on
    the CPU: every arrival counted once, streams moved between the two
    engines, and completed streams equal to their requests served alone.

torch runs on one intra-op thread."""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs.registry as jregistry  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.workload as jworkload  # noqa: E402
import repro_torch.configs.registry as tregistry  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.workload as tworkload  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.hw.tpu import DEFAULT_SUPERCHIP  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.legacy import StaticServeEngine as JStatic  # noqa: E402
from repro.sharding import RULE_SETS  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.models.params import load_numpy_params  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serving.legacy import StaticServeEngine  # noqa: E402

N_PMAX = DEFAULT_SUPERCHIP.p_max
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Side:
    """One package's reduced f32 setup of ``arch``: config, engine maker,
    request class and fleet modules.  The port's weights are the JAX
    side's, carried across."""

    def __init__(self, arch, jax_side=None):
        self.jax = jax_side is None
        reg = jregistry if self.jax else tregistry
        self.full = reg.get_model_config(arch)
        self.cfg = (jreduced if self.jax else reduced)(self.full)
        self.run = reg.get_run_config(arch, remat="none", logits_chunk=16,
                                      compute_dtype="float32")
        if self.jax:
            self.ctx = JCtx(self.run, RULE_SETS[self.run.rules_name], None)
            self.params = jinit(jlm.model_decls(self.cfg),
                                jax.random.PRNGKey(0))
            self.Request, self.Engine, self.Static = (JRequest, JServeEngine,
                                                      JStatic)
            self.fleet, self.workload = jfleet, jworkload
        else:
            self.ctx = Ctx(self.run, "cpu")
            self.params = load_numpy_params(
                jax.tree.map(np.asarray, jax_side.params), "cpu")
            self.Request, self.Engine, self.Static = (Request, ServeEngine,
                                                      StaticServeEngine)
            self.fleet, self.workload = tfleet, tworkload

    def engine(self, **kw):
        return self.Engine(self.cfg, self.run, self.ctx, self.params, **kw)


@pytest.fixture(scope="module")
def sides():
    made = {}

    def get(arch):
        if arch not in made:
            j = _Side(arch)
            made[arch] = (j, _Side(arch, j))
        return made[arch]

    return get


def _streams(done):
    return {r.uid: list(r.generated) for r in done}


def _each(sides, arch, fn):
    """``fn(side)`` on the JAX side and on the port's."""
    j, t = sides(arch)
    return fn(j), fn(t)


# -- ServeJob over a real engine (tests/test_fleet.py) ----------------------

def _real_job(S, **kw):
    eng = S.engine(batch_size=2, max_seq=32, decode_chunk=4)
    reqs = [S.Request(uid=i, prompt=[3 * i + 1, 5, 7], max_new_tokens=6)
            for i in range(3)]
    job = S.fleet.ServeJob("real", S.full, batch=2, prompt=8, new_tokens=6,
                           total_requests=3, decode_chunk=4, engine=eng,
                           requests=reqs, **kw)
    return eng, reqs, job


def test_serve_job_drives_a_real_engine_equal(sides):
    def run(S):
        eng, reqs, job = _real_job(S)
        c = S.fleet.SimulatedCluster(n_nodes=1, cabinet_size=1,
                                     policy="even")
        out = c.run(jobs=[job], budget=N_PMAX, until_s=200.0)
        assert job.done and out["completions"] == 1
        return out, _streams(eng.finished), job.emitted

    ref, port = _each(sides, "llama3.2-3b", run)
    assert ref[0]["tokens"] == 18
    assert ref == port


def _job_state(job, eng, reqs):
    return (job.emitted, eng.in_flight_tokens, job.snapshot_tokens,
            job.snapshot_bytes, job.last_preempt_dropped, job.done,
            {r.uid: list(r.generated) for r in reqs})


@pytest.mark.parametrize("migrate", [True, False])
def test_serve_job_preemption_equal(sides, migrate):
    """``test_serve_job_preempt_migrates_in_flight_tokens`` and
    ``test_serve_job_drop_mode_regenerates_tokens``: the job's state
    after every advance and the preemption."""

    def run(S):
        eng, reqs, job = _real_job(S, migrate=migrate)
        seen = []
        job.advance(0.1)
        seen.append(_job_state(job, eng, reqs))
        job.preempt()
        seen.append(_job_state(job, eng, reqs))
        while not job.done:
            job.advance(0.1)
            seen.append(_job_state(job, eng, reqs))
        return seen

    ref, port = _each(sides, "llama3.2-3b", run)
    assert ref[-1][0] == 18
    if migrate:
        assert ref[1][2] > 0 and ref[1][3] > 0 and ref[1][4] == 0
    else:
        assert ref[1][4] > 0 and ref[1][2] == 0
    assert ref == port


# -- crash replay (tests/test_faults.py) ------------------------------------

def _ckpt_reqs(S):
    return [S.Request(uid=0, prompt=[1, 2, 3], max_new_tokens=10),
            S.Request(uid=1, prompt=[7, 5], max_new_tokens=8),
            S.Request(uid=2, prompt=[4, 4, 2, 1], max_new_tokens=6)]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-370m"])
def test_crash_at_every_chunk_equals_the_uninterrupted_streams(sides, arch):
    j, t = sides(arch)
    gold = _streams(j.engine(batch_size=2, max_seq=32, decode_chunk=3)
                    .generate(_ckpt_reqs(j)))
    eng = t.engine(batch_size=2, max_seq=32, decode_chunk=3)
    assert _streams(eng.generate(_ckpt_reqs(t))) == gold
    n_steps = eng.sync_count
    assert n_steps >= 3
    for cut in range(1, n_steps):
        eng = t.engine(batch_size=2, max_seq=32, decode_chunk=3)
        eng.start(_ckpt_reqs(t))
        for _ in range(cut):
            eng.step()
        snaps = eng.checkpoint()             # the periodic shadow
        got = _streams(eng.finished)
        if eng.pending:
            eng.step()                       # doomed decode past it...
        eng.abandon()                        # ...then the node dies
        eng2 = t.engine(batch_size=3, max_seq=32, decode_chunk=3)
        eng2.restore(snaps)
        while eng2.pending:
            eng2.step()
        got.update(_streams(eng2.finished))
        assert got == gold, f"{arch}: crash after chunk {cut}"


def test_checkpoint_is_non_destructive_and_repeatable(sides):
    j, t = sides("llama3.2-3b")
    gold = _streams(j.engine(batch_size=2, max_seq=32, decode_chunk=3)
                    .generate(_ckpt_reqs(j)))
    eng = t.engine(batch_size=2, max_seq=32, decode_chunk=3)
    eng.start(_ckpt_reqs(t))
    eng.step()
    snaps = eng.checkpoint()
    assert eng.pending
    before = {s.request.uid: list(s.request.generated) for s in snaps}
    eng.step()
    assert before == {s.request.uid: list(s.request.generated)
                      for s in snaps}
    done_before = _streams(eng.finished)

    def replay():
        e = t.engine(batch_size=2, max_seq=32, decode_chunk=3)
        e.restore([dataclasses.replace(s, request=s.request.clone())
                   for s in snaps])
        while e.pending:
            e.step()
        return {**done_before, **_streams(e.finished)}

    assert replay() == replay() == gold


def _edit_distance(a, b):
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev, dp[0] = dp[0], i
        for k in range(1, n + 1):
            cur = dp[k]
            dp[k] = min(dp[k] + 1, dp[k - 1] + 1,
                        prev + (a[i - 1] != b[k - 1]))
            prev = cur
    return dp[n]


@pytest.mark.parametrize("cut", [1, 2])
def test_int8_shadow_restore_equal_and_bounded(sides, cut):
    def run(S):
        eng = S.engine(batch_size=3, max_seq=32, decode_chunk=3,
                       snapshot_int8=True)
        eng.start(_ckpt_reqs(S))
        for _ in range(cut):
            eng.step()
        snaps = eng.checkpoint()
        got = _streams(eng.finished)
        eng.abandon()
        eng2 = S.engine(batch_size=3, max_seq=32, decode_chunk=3)
        eng2.restore(snaps)
        while eng2.pending:
            eng2.step()
        got.update(_streams(eng2.finished))
        return got

    j, _ = sides("llama3.2-3b")
    gold = _streams(j.engine(batch_size=3, max_seq=32, decode_chunk=3)
                    .generate(_ckpt_reqs(j)))
    ref, port = _each(sides, "llama3.2-3b", run)
    assert port == ref
    total = sum(len(v) for v in gold.values())
    assert {u: len(g) for u, g in port.items()} == \
        {u: len(g) for u, g in gold.items()}
    assert sum(_edit_distance(gold[u], port[u]) for u in gold) \
        <= 0.25 * total


# -- benchmarks/traffic_slo.py's engine arm ---------------------------------

def _engine_arm(S, seed=0):
    """``benchmarks/traffic_slo.py::_run_engine_arm`` (two paged engines of
    the reduced config, open loop, admission and the autoscaler)."""
    F, W = S.fleet, S.workload
    cluster = F.SimulatedCluster(n_nodes=2, cabinet_size=1,
                                 policy="sensitivity",
                                 idle_w=DEFAULT_SUPERCHIP.p_floor,
                                 wake_latency_s=2.0)
    tracker = W.SLOTracker(sink=cluster.telemetry)
    trace = [dataclasses.replace(
                 e, prompt_len=min(e.prompt_len, 24),
                 output_len=min(max(e.output_len, 1), 6))
             for e in W.diurnal_trace(seed=seed, until_s=20.0,
                                      base_rps=0.4, amplitude=0.5,
                                      period_s=20.0)]
    driver = W.WorkloadDriver(
        trace, tracker, admission=W.AdmissionController(),
        autoscaler=W.Autoscaler(min_slots=1, shrink_frac=0.5,
                                park_after_s=4.0, park_rest_s=2.0,
                                min_running=1, wake_threshold=4))
    jobs = [F.ServeJob(f"eng-{i}", S.cfg, batch=8, prompt=256,
                       new_tokens=64, total_requests=0, decode_chunk=8,
                       open_loop=True, partial=True, migrate=True,
                       value=2.0, slo=tracker,
                       engine=S.engine(batch_size=4, max_seq=32,
                                       prefill_chunk=8, decode_chunk=4,
                                       paged=True, block_size=8))
            for i in range(2)]
    counters = cluster.run(jobs=jobs, budget=0.75 * 2 * N_PMAX,
                           until_s=20.0, workload=driver)
    return (counters, tracker.summary(), len(trace),
            {j.name: _streams(j.requests or []) for j in jobs})


def test_traffic_slo_engine_arm_equal(sides):
    ref, port = _each(sides, "llama3.2-3b", _engine_arm)
    assert sum(s["completed"] for s in ref[1].values()) > 0
    assert ref == port


# -- capacity_hint -----------------------------------------------------------

HINT_ROWS = (1, 8, 9, 16, 31, 32)


def _hints(S, geom):
    """``capacity_hint`` at every step of a stream, across a slot limit
    and a drain/restore: before the stream, after each step, after a
    partial drain, after a full drain and after the restore."""
    eng = S.engine(**geom)
    reqs = [S.Request(uid=i, prompt=[(5 * i + j) % 97 + 1
                                     for j in range(2 + 3 * i % 7)],
                      max_new_tokens=3 + 2 * i % 5) for i in range(7)]
    seen = [[eng.capacity_hint(r) for r in HINT_ROWS]]
    eng.start(reqs)
    seen.append([eng.capacity_hint(r) for r in HINT_ROWS])
    step = 0
    while eng.pending:
        eng.step()
        step += 1
        if step == 2:
            eng.set_slot_limit(2)
            snaps = eng.drain(slots=eng.select_victims(1))
        if step == 3:
            snaps += eng.drain()
            seen.append([eng.capacity_hint(r) for r in HINT_ROWS])
            eng.set_slot_limit(eng.batch_size)
            eng.restore(snaps)
        seen.append([eng.capacity_hint(r) for r in HINT_ROWS])
    return seen, _streams(eng.finished)


@pytest.mark.parametrize("geom", [
    dict(batch_size=3, max_seq=32, decode_chunk=2),
    dict(batch_size=3, max_seq=32, decode_chunk=2, paged=True, block_size=8),
    dict(batch_size=3, max_seq=32, decode_chunk=2, paged=True, block_size=8,
         n_blocks=5),
    dict(batch_size=3, max_seq=32, decode_chunk=2, paged=True, block_size=4,
         n_blocks=12, prefix_sharing=True)],
    ids=["dense", "paged", "paged-tight", "paged-shared"])
def test_capacity_hint_equal_at_every_step(sides, geom):
    ref, port = _each(sides, "llama3.2-3b", lambda S: _hints(S, geom))
    assert len(ref[0]) > 4
    assert ref == port


# -- completion_s ------------------------------------------------------------

class _ReplayBody:
    """Stands in for a CUDA graph on the CPU (``tests/test_torch_graphs
    .py``): a replay runs the captured body again."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def _capture_on_cpu(body, device, share=None):
    body()
    return graphs.ChunkGraph(body, None,
                             record=lambda b, stream: _ReplayBody(b))


def _completion_reqs():
    return [Request(uid=10 + i, prompt=[(3 * i + j) % 50 + 1
                                        for j in range(1 + 2 * i)],
                    max_new_tokens=2 + 3 * i) for i in range(5)]


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_completion_s_holds_every_finished_uid(sides, graphed, paged,
                                               monkeypatch):
    _, t = sides("llama3.2-3b")
    kw = dict(batch_size=2, max_seq=32, decode_chunk=2)
    if paged:
        kw.update(paged=True, block_size=8)
    want = _streams(t.engine(**kw).generate(_completion_reqs()))
    if graphed:
        monkeypatch.setattr(graphs, "capture", _capture_on_cpu)
    eng = t.engine(**kw)
    eng.eager = not graphed
    order = []
    eng.start(_completion_reqs())
    while eng.pending:
        order.append([r.uid for r in eng.step()])
    assert _streams(eng.finished) == want
    assert set(eng.completion_s) == set(want)
    if graphed:
        assert eng.graph is not None and eng.graph.replays > 0
    # later chunks finish later: the seconds follow the finishing order
    times = [max(eng.completion_s[u] for u in uids)
             for uids in order if uids]
    assert all(x >= 0 for x in eng.completion_s.values())
    assert times == sorted(times)
    assert eng.sync_count == len(order)       # no sync added for it


def test_completion_s_across_a_drain_and_restore(sides):
    _, t = sides("llama3.2-3b")
    src = t.engine(batch_size=2, max_seq=32, decode_chunk=2)
    src.start(_completion_reqs())
    src.step()
    src.step()
    snaps = src.drain()
    dst = t.engine(batch_size=3, max_seq=32, decode_chunk=2)
    dst.restore(snaps)
    while dst.pending:
        dst.step()
    assert set(src.completion_s) == {r.uid for r in src.finished}
    assert set(dst.completion_s) == {r.uid for r in dst.finished}
    assert set(src.completion_s) | set(dst.completion_s) == \
        {r.uid for r in _completion_reqs()}


# -- StaticServeEngine -------------------------------------------------------

STATIC_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [2, 4, 6],
                  [9, 8, 7, 6, 5], [3, 1, 4], [5, 9, 2, 6, 5],
                  [7, 7, 7, 1, 2, 3, 4]]
STATIC_NEW = [4, 6, 3, 5, 2, 7, 1]


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_static_engine_equals_the_reference(sides, batch_size):
    def run(S):
        eng = S.Static(S.cfg, S.run, S.ctx, S.params, batch_size=batch_size,
                       max_seq=32)
        done = eng.generate([S.Request(uid=i, prompt=list(p),
                                       max_new_tokens=n)
                             for i, (p, n) in enumerate(zip(STATIC_PROMPTS,
                                                            STATIC_NEW))])
        assert set(eng.completion_s) == set(range(len(STATIC_PROMPTS)))
        return [r.uid for r in done], _streams(done)

    ref, port = _each(sides, "llama3.2-3b", run)
    assert all(len(ref[1][i]) == n for i, n in enumerate(STATIC_NEW))
    assert ref == port


def test_static_engine_syncs_once_a_token_step(sides):
    _, t = sides("llama3.2-3b")
    eng = StaticServeEngine(t.cfg, t.run, t.ctx, t.params, batch_size=2,
                            max_seq=32)
    eng.generate([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4),
                  Request(uid=1, prompt=[4, 5, 6], max_new_tokens=2)])
    assert eng.sync_count == 4     # one batch: a sync per delivered step


# -- chip_smoke.py's [fleet:engine] scenario at reduced size ----------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_card_fleet_scenario_moves_streams_between_engines(sides):
    """The scenario the card runs, with the same full-width config pacing
    the virtual clock and reduced engines of the card's geometry: every
    arrival counted once, both whole-job drains and cross-engine
    adoptions, and the adopted streams' requests served alone equal."""
    from repro_torch.hw.h100 import H100_SUPERCHIP
    cs = _chip_smoke()
    _, t = sides("llama3.2-3b")
    engines = [t.engine(batch_size=8, max_seq=2048, prefill_chunk=256,
                        decode_chunk=8, **kw) for kw in cs.FLEET_ENGINES]
    out = cs.fleet_scenario(tfleet, tworkload, t.full, engines,
                            H100_SUPERCHIP)
    acct = cs.fleet_accounting(out)
    c = out["counters"]
    assert acct["completed"] > 0
    assert c["preemptions"] >= 1 and c["migrated_tokens"] > 0
    assert c["adoptions"] >= 1 and c["adopted_tokens"] > 0
    # the longest completed streams of each engine, served alone again
    for job in out["jobs"]:
        done = sorted((r for r in job.requests or [] if r.done),
                      key=lambda r: (-len(r.generated), r.uid))[:4]
        alone = _streams(job.engine.generate([
            Request(uid=r.uid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens) for r in done]))
        assert alone == _streams(done)
