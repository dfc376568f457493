"""The port's fleet layer (``repro_torch.fleet``: telemetry, Pareto curves,
the hierarchical controller, fault injection, the scheduler, the
simulated cluster) and its launcher against ``repro.fleet`` and
``repro.launch.fleet``, on modelled jobs: the same scenarios through both
packages, each with its own ``ModelConfig``, every result equal with
``==``:

  * the reference tests' cluster scenarios (``tests/test_fleet.py``'s
    determinism run under every policy, ``tests/test_pareto.py``'s
    pareto and sensitivity runs, ``tests/test_faults.py``'s chaos runs
    with and without recovery and its hang) and a budget dip that
    preempts: counter dicts, allocations and the jobs' states;
  * the controller's allocations and the curve fits over the reference's
    hypothesis strategies, every policy, with and without cabinet
    ceilings;
  * ``chaos_schedule``, the modelled shadow checkpoint and
    ``StepwiseSupervisor``;
  * ``python -m repro_torch.launch.fleet`` against ``repro.launch.fleet``:
    the same stdout for the same flags.

Pure Python on both sides (the fleet over real engines is
``tests/test_torch_fleet_engine.py``)."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import math
import random
import sys
import types

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

import repro.configs.registry as jregistry
import repro.fleet as jfleet
import repro.fleet.controller as jcontroller
import repro.fleet.pareto as jpareto
import repro.hw.tpu as jtpu
import repro.launch.fleet as jlaunch
import repro.runtime.supervisor as jsupervisor
import repro_torch.configs.registry as tregistry
import repro_torch.fleet as tfleet
import repro_torch.fleet.controller as tcontroller
import repro_torch.fleet.pareto as tpareto
import repro_torch.hw.tpu as ttpu
import repro_torch.launch.fleet as tlaunch
import repro_torch.runtime.supervisor as tsupervisor

PKGS = {
    "repro": types.SimpleNamespace(
        fleet=jfleet, controller=jcontroller, pareto=jpareto, tpu=jtpu,
        supervisor=jsupervisor, cfg=jregistry.get_model_config),
    "repro_torch": types.SimpleNamespace(
        fleet=tfleet, controller=tcontroller, pareto=tpareto, tpu=ttpu,
        supervisor=tsupervisor, cfg=tregistry.get_model_config),
}
POLICIES = ("even", "sensitivity", "pareto")


def _both(fn, *args, **kw):
    return fn(PKGS["repro"], *args, **kw), fn(PKGS["repro_torch"], *args,
                                              **kw)


def _jobs_state(jobs):
    """What a run leaves in its jobs: tokens, steps, restarts, history."""
    out = []
    for j in jobs:
        out.append((j.name, getattr(j, "emitted", None),
                    getattr(j, "steps_done", None),
                    j.supervisor.restarts, list(j.supervisor.history),
                    getattr(j, "dropped_total", None)))
    return out


# -- cluster scenarios -------------------------------------------------------

def _mixed_jobs(P):
    """``tests/test_fleet.py::_mixed_jobs``."""
    F, llama, mamba = P.fleet, P.cfg("llama3.2-3b"), P.cfg("mamba2-370m")
    return [
        F.TrainJob("train-llama", llama, batch=8, seq=512,
                   total_steps=10**9),
        F.ServeJob("serve-decode", llama, batch=64, prompt=2048,
                   new_tokens=512, total_requests=10**9, decode_chunk=32),
        F.ServeJob("serve-prefill", llama, batch=16, prompt=8192,
                   new_tokens=32, total_requests=10**9, decode_chunk=32),
        F.TrainJob("train-mamba", mamba, batch=8, seq=512,
                   total_steps=10**9),
    ]


def _dip_run(P, policy):
    """``tests/test_fleet.py::test_cluster_counters_bit_identical_across_
    runs`` under ``policy``."""
    n_pmax = P.tpu.DEFAULT_SUPERCHIP.p_max
    trace = [(0.0, 0.6 * 4 * n_pmax), (5.0, 0.4 * 4 * n_pmax),
             (8.0, 0.12 * 4 * n_pmax), (11.0, 0.4 * 4 * n_pmax)]
    c = P.fleet.SimulatedCluster(n_nodes=4, cabinet_size=2, policy=policy)
    jobs = _mixed_jobs(P)
    out = c.run(jobs=jobs, budget=trace, until_s=15.0)
    return out, _jobs_state(jobs), [dataclasses.astuple(a)
                                    for a in c.allocations]


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_run_equal(policy):
    ref, port = _both(_dip_run, policy)
    assert ref[0]["tokens"] > 0 and ref[0]["energy_j"] > 0
    assert ref == port


def _pareto_counters(P, policy):
    """``tests/test_pareto.py::_cluster_counters``."""
    F, cfg = P.fleet, P.cfg("llama3.2-3b")
    jobs = [F.TrainJob("t0", cfg, batch=8, seq=512, total_steps=10**9),
            F.ServeJob("s0", cfg, batch=64, prompt=2048, new_tokens=512,
                       total_requests=10**9, decode_chunk=32),
            F.ServeJob("s1", cfg, batch=16, prompt=8192, new_tokens=32,
                       total_requests=10**9, decode_chunk=32),
            F.TrainJob("t1", cfg, batch=8, seq=512, total_steps=10**9)]
    c = F.SimulatedCluster(n_nodes=4, cabinet_size=2, policy=policy)
    out = c.run(jobs=jobs, budget=[(0.0, 1000.0)], until_s=20.0)
    conf = c.curves.confidences() if c.curves is not None else None
    return out, conf, _jobs_state(jobs)


@pytest.mark.parametrize("policy", ["pareto", "sensitivity"])
def test_pareto_cluster_equal(policy):
    ref, port = _both(_pareto_counters, policy)
    if policy == "pareto":
        assert ref[0]["curve_samples"] > 0 and ref[0]["explore_probes"] > 0
    assert ref == port


def _budget_dip(P):
    """``tests/test_fleet.py::test_budget_dip_preempts_train_first_then_
    resumes``."""
    F, llama = P.fleet, P.cfg("llama3.2-3b")
    n_pmax = P.tpu.DEFAULT_SUPERCHIP.p_max
    dip = [(0.0, 0.6 * 2 * n_pmax), (5.0, 100.0), (8.0, 0.6 * 2 * n_pmax)]
    c = F.SimulatedCluster(n_nodes=2, cabinet_size=2, policy="sensitivity")
    jobs = [F.TrainJob("t", llama, batch=8, seq=512, total_steps=10**9,
                       ckpt_every=5),
            F.ServeJob("s", llama, batch=64, prompt=2048, new_tokens=512,
                       total_requests=10**9, decode_chunk=32)]
    out = c.run(jobs=jobs, budget=dip, until_s=12.0)
    return out, _jobs_state(jobs), [n.job.name if n.job else None
                                    for n in c.nodes]


def test_budget_dip_preemption_equal():
    ref, port = _both(_budget_dip)
    assert ref[0]["preemptions"] == 1
    assert ref == port


def _completion(P):
    """``tests/test_fleet.py::test_jobs_run_to_completion_and_release_
    nodes``."""
    F, mamba = P.fleet, P.cfg("mamba2-370m")
    c = F.SimulatedCluster(n_nodes=2, cabinet_size=2, policy="even")
    jobs = [F.TrainJob("t", mamba, batch=2, seq=64, total_steps=3),
            F.ServeJob("s", mamba, batch=4, prompt=64, new_tokens=8,
                       total_requests=2, decode_chunk=8)]
    out = c.run(jobs=jobs, budget=2 * P.tpu.DEFAULT_SUPERCHIP.p_max,
                until_s=50.0)
    return out, _jobs_state(jobs)


def test_jobs_to_completion_equal():
    ref, port = _both(_completion)
    assert ref[0]["completions"] == 2
    assert ref == port


# -- faults ------------------------------------------------------------------

def _chaos_run(P, watchdog, ckpt, seed):
    """``tests/test_faults.py::_chaos_run``."""
    F, llama = P.fleet, P.cfg("llama3.2-3b")
    names = [f"cab{i // 4}/n{i:02d}" for i in range(3)]
    evs = F.chaos_schedule(seed, names, 40.0, crashes=1, hangs=0,
                           cap_faults=1, telemetry_faults=1, stragglers=1,
                           repair_s=8.0)
    c = F.SimulatedCluster(
        n_nodes=4, cabinet_size=4, faults=F.FaultInjector(evs, seed=seed),
        watchdog_deadline_s=2.5 if watchdog else None,
        shadow_ckpt_s=3.0 if ckpt else None)
    jobs = [F.ServeJob(f"s{i}", llama, batch=8, prompt=256, new_tokens=64,
                       total_requests=10 ** 6, decode_chunk=8, migrate=True,
                       partial=True, max_restarts=16, backoff_jitter=0.25)
            for i in range(3)]
    out = c.run(jobs, budget=4 * P.tpu.DEFAULT_SUPERCHIP.p_max,
                until_s=40.0)
    return out, _jobs_state(jobs), [(n.name, n.crashed, n.busy)
                                    for n in c.nodes]


@pytest.mark.parametrize("watchdog,ckpt,seed", [(True, True, 0),
                                                (False, False, 0),
                                                (True, True, 3),
                                                (True, False, 1)])
def test_chaos_run_equal(watchdog, ckpt, seed):
    ref, port = _both(_chaos_run, watchdog, ckpt, seed)
    assert ref[0]["crashes"] >= 1
    assert ref == port


def _hang(P):
    """``tests/test_faults.py::test_hang_is_fenced_like_a_crash``."""
    F, llama = P.fleet, P.cfg("llama3.2-3b")
    names = [f"cab0/n{i:02d}" for i in range(2)]
    evs = [F.FaultEvent(t=3.0, kind="hang", node=names[0], duration_s=8.0)]
    c = F.SimulatedCluster(n_nodes=2, cabinet_size=2,
                           faults=F.FaultInjector(evs),
                           watchdog_deadline_s=2.5)
    jobs = [F.TrainJob("t0", llama, batch=8, seq=512, total_steps=10 ** 9,
                       max_restarts=16)]
    out = c.run(jobs=jobs, budget=2 * P.tpu.DEFAULT_SUPERCHIP.p_max,
                until_s=15.0)
    return out, _jobs_state(jobs)


def test_hang_equal():
    ref, port = _both(_hang)
    assert ref[0]["dead_declared"] >= 1 and ref[0]["crashes"] == 0
    assert ref == port


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7])
def test_chaos_schedule_equal(seed):
    def schedule(P):
        names = [f"cab{i // 3}/n{i:02d}" for i in range(6)]
        return [dataclasses.astuple(e) for e in P.fleet.chaos_schedule(
            seed, names, 60.0, repair_s=15.0)]

    ref, port = _both(schedule)
    assert ref and ref == port


def _shadow(P):
    """``tests/test_faults.py::test_modeled_shadow_checkpoint_bounds_crash_
    loss``: the job's counters after each move."""
    j = P.fleet.ServeJob("s", P.cfg("llama3.2-3b"), batch=4, prompt=64,
                         new_tokens=32, total_requests=10 ** 6,
                         decode_chunk=8, migrate=True, max_restarts=8)
    seen = []
    for _ in range(3):
        j.advance(0.1, now=0.3)
    seen.append((j.emitted, j.shadow_checkpoint(0.3)))
    for now in (0.4, 0.5):
        j.advance(0.1, now=now)
        j.on_crash()
        seen.append((j.emitted, j.last_crash_lost, j.last_crash_replayed,
                     j.dropped_total))
    return seen


def test_modelled_shadow_checkpoint_equal():
    ref, port = _both(_shadow)
    assert ref[1][1] == 32
    assert ref == port


def test_stepwise_supervisor_equal():
    def events(P):
        sup = P.supervisor.StepwiseSupervisor(max_restarts=4, backoff_s=0.5,
                                              jitter=0.25, seed=3)
        out = [sup.preempted(), sup.crashed("boom"),
               sup.crashed(ValueError("x")), sup.preempted()]
        with pytest.raises(RuntimeError, match="max_restarts"):
            sup.preempted()
        sup.completed("done")
        return out, sup.history, sup.restarts

    ref, port = _both(events)
    assert ref == port


# -- the controller and the curves (the reference's strategies) --------------

@dataclasses.dataclass
class _StubNode:
    """``tests/test_fleet.py``'s controller-facing double."""

    name: str
    cabinet: str
    request: float
    scale: float
    floor_w: float = 50.0
    ceil_w: float = 330.0
    grant_w: float = 100.0

    def request_w(self) -> float:
        return max(self.request, self.floor_w)

    def throughput_at(self, g: float) -> float:
        eff = min(max(g, self.floor_w), self.request_w())
        return self.scale * (eff - 40.0) ** 0.5

    def sensitivity(self) -> float:
        return (self.throughput_at(self.grant_w + 8)
                - self.throughput_at(self.grant_w - 8)) / 16.0


def _allocate(P, cfgs, budget, policy, ceil):
    nodes = [_StubNode(name=f"cab{i % 2}/{k}", cabinet=f"cab{i % 2}",
                       request=req, scale=sc)
             for i, (k, (req, sc, _)) in enumerate(sorted(cfgs.items()))]
    if policy == "pareto":
        ctl = P.fleet.FleetPowerController(
            policy="pareto", curves=P.fleet.CurveBank(), explore_budget=0.25)
    else:
        ctl = P.fleet.FleetPowerController(policy=policy)
    ceils = None if ceil is None else {"cab0": ceil, "cab1": ceil * 1.3}
    out = []
    for t in (1.0, 2.0, 3.0):                  # a few re-decides in a row
        alloc = ctl.redistribute(budget, nodes, t=t, cabinet_ceils=ceils)
        out.append(dataclasses.astuple(alloc))
        for n in nodes:
            n.grant_w = alloc.node_w[n.name]
    return out


_IDS = st.sampled_from(["a", "b", "c", "d", "e", "f", "g", "h"])
_CFGS = st.dictionaries(_IDS,
                        st.tuples(st.floats(min_value=60.0, max_value=330.0),
                                  st.floats(min_value=1.0, max_value=50.0),
                                  st.booleans()),
                        min_size=1, max_size=8)


@pytest.mark.parametrize("policy", POLICIES)
@settings(max_examples=25, deadline=None)
@given(_CFGS, st.floats(min_value=150.0, max_value=1500.0))
def test_controller_allocations_equal(policy, cfgs, budget):
    ref, port = _both(_allocate, cfgs, budget, policy, None)
    assert ref == port


@pytest.mark.parametrize("policy", POLICIES)
@settings(max_examples=25, deadline=None)
@given(_CFGS, st.floats(min_value=150.0, max_value=1500.0),
       st.floats(min_value=120.0, max_value=700.0))
def test_controller_allocations_with_ceilings_equal(policy, cfgs, budget,
                                                    cab_ceil):
    ref, port = _both(_allocate, cfgs, budget, policy, cab_ceil)
    assert ref == port


_GRID = [90.0, 120.0, 150.0, 180.0, 210.0, 240.0, 270.0, 300.0, 330.0]


def _fit(P, lin, root, eff, seed):
    """``tests/test_pareto.py::test_curve_fit_recovers_known_optimum``'s
    noisy samples: the fitted curve, its confidence and its ED pick."""
    Pa = P.pareto
    rng = random.Random(seed)
    model = Pa.PowerCurveModel()
    for _ in range(6):
        for cap in _GRID:
            perf = lin * cap + root * math.sqrt(cap)
            noise = 1.0 + rng.uniform(-0.01, 0.01)
            model.observe(cap, perf * noise, (eff * cap) * noise)
    fitted = [Pa.GrantPoint(c, *Pa.fitted_cost_per_token(model, c))
              for c in _GRID]
    return ([(model.predict_perf(c), model.predict_watts(c)) for c in _GRID],
            model.confidence, model.ready, model.support,
            Pa.pareto_cap(fitted))


@settings(max_examples=25, deadline=None)
@given(st.floats(min_value=0.05, max_value=0.6),
       st.floats(min_value=5.0, max_value=40.0),
       st.floats(min_value=0.5, max_value=0.9),
       st.integers(min_value=0, max_value=10_000))
def test_curve_fit_equal(lin, root, eff, seed):
    ref, port = _both(_fit, lin, root, eff, seed)
    assert ref[2] and ref == port


# -- the launcher -------------------------------------------------------------

def _launch(module, argv):
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["fleet"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = old
    return buf.getvalue()


@pytest.mark.parametrize("flags", [
    "", "--pareto", "--workload diurnal --autoscale",
    "--chaos-seed 3 --watchdog-s 2.5 --ckpt-s 3",
    "--policy even --budget-frac 0.7,0.45,0.12,0.45",
    "--partial --snapshot-int8 --budget-frac 0.7,0.45,0.12,0.45",
    "--nodes 6 --duration 30"])
def test_launcher_stdout_equal(flags):
    argv = flags.split()
    ref, port = _launch(jlaunch, argv), _launch(tlaunch, argv)
    assert ref.startswith("[fleet]") and ref == port
