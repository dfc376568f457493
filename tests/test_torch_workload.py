"""The port's workload layer (``repro_torch.workload``: arrivals, SLO
classes and tracking, admission control, the autoscaler) against
``repro.workload``: the same calls through both packages, each with its
own ``ModelConfig``, and every result equal with ``==``:

  * ``diurnal_trace`` event by event for several seeds and rates, and a
    ``TrafficGenerator`` with its own bursts;
  * ``LengthSampler`` over the reference's hypothesis strategy;
  * ``SLOTracker.summary()`` over a scripted offer/complete/reject mix;
  * the reference's open-loop scenarios (``tests/test_workload.py``'s
    ``_run_workload``): fleet counters and SLO summaries, with and
    without the autoscaler.

Pure Python on both sides: neither package runs a model here."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

import repro.configs.registry as jregistry
import repro.fleet as jfleet
import repro.workload as jworkload
import repro_torch.configs.registry as tregistry
import repro_torch.fleet as tfleet
import repro_torch.workload as tworkload

PKGS = {
    "repro": types.SimpleNamespace(fleet=jfleet, workload=jworkload,
                                   cfg=jregistry.get_model_config),
    "repro_torch": types.SimpleNamespace(fleet=tfleet, workload=tworkload,
                                         cfg=tregistry.get_model_config),
}


def _both(fn, *args, **kw):
    """``fn(pkg, ...)`` through the reference and the port."""
    return fn(PKGS["repro"], *args, **kw), fn(PKGS["repro_torch"], *args,
                                              **kw)


def _events(events):
    return [dataclasses.astuple(e) for e in events]


# -- arrivals ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 11, 2024])
@pytest.mark.parametrize("base_rps", [0.4, 4.0, 6.0])
def test_diurnal_trace_equal_event_by_event(seed, base_rps):
    ref, port = _both(lambda P: _events(P.workload.diurnal_trace(
        seed=seed, until_s=60.0, base_rps=base_rps)))
    assert ref and ref == port


def test_traffic_generator_with_bursts_equal():
    def trace(P):
        W = P.workload
        gen = W.TrafficGenerator(
            seed=3, rate=W.DiurnalRate(base_rps=5.0, amplitude=0.8,
                                       period_s=20.0, phase_s=2.0),
            bursts=(W.Burst(t0=4.0, duration_s=3.0, rps=12.0),
                    W.Burst(t0=15.0, duration_s=1.0, rps=30.0)))
        return _events(gen.events(30.0))

    ref, port = _both(trace)
    assert ref == port


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=1, max_value=64),
       st.integers(min_value=0, max_value=512),
       st.floats(min_value=0.3, max_value=4.0),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_length_sampler_equal(lo, span, alpha, seed):
    def draws(P):
        s = P.workload.LengthSampler(lo=lo, hi=lo + span, alpha=alpha)
        rng = np.random.default_rng(seed)
        return [s.sample(rng) for _ in range(32)]

    ref, port = _both(draws)
    assert ref == port


@pytest.mark.parametrize("name", ["interactive", "standard", "batch"])
def test_slo_classes_equal(name):
    ref, port = _both(lambda P: dataclasses.astuple(
        P.workload.class_by_name(name)))
    assert ref == port


# -- SLO accounting ----------------------------------------------------------

def _slo_script(P):
    """Offers, completions (met and missed) and rejections of every class,
    from one seeded trace: the summary and the goodput."""
    tr = P.workload.SLOTracker()
    events = P.workload.diurnal_trace(seed=5, until_s=30.0, base_rps=3.0)
    rng = np.random.default_rng(9)
    for e in events:
        tr.offer(e.slo, now=e.t)
        u = rng.random()
        if u < 0.15:
            tr.reject(e.slo, now=e.t)
        else:
            latency = float(rng.uniform(0.05, 2.0)) * e.deadline_s
            tr.complete(e.slo, latency, e.output_len, e.deadline_s,
                        now=e.t + latency)
    return tr.summary(), tr.goodput_tokens()


def test_slo_tracker_summary_equal():
    ref, port = _both(_slo_script)
    assert ref[0] and ref == port


# -- open-loop fleet scenarios (tests/test_workload.py) ---------------------

def _serve(P, name, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("prompt", 64)
    kw.setdefault("new_tokens", 16)
    kw.setdefault("decode_chunk", 8)
    return P.fleet.ServeJob(name, P.cfg("llama3.2-3b"), total_requests=0,
                            open_loop=True, partial=True, migrate=True, **kw)


def _fleet(P, n=3, idle_w=50.0):
    return P.fleet.SimulatedCluster(n_nodes=n, cabinet_size=max(n // 2, 1),
                                    policy="sensitivity", idle_w=idle_w,
                                    wake_latency_s=1.0)


def _run_workload(P, autoscale, seed=0, until_s=40.0, base_rps=4.0):
    W = P.workload
    cluster = _fleet(P)
    tracker = W.SLOTracker(sink=cluster.telemetry)
    driver = W.WorkloadDriver(
        W.diurnal_trace(seed=seed, until_s=until_s, base_rps=base_rps),
        tracker,
        admission=W.AdmissionController() if autoscale else None,
        autoscaler=W.Autoscaler(park_after_s=2.0, park_rest_s=1.0,
                                wake_threshold=4) if autoscale else None)
    n = len(cluster.nodes)
    jobs = [_serve(P, f"svc-{i}", slo=tracker, batch=8) for i in range(n)]
    counters = cluster.run(jobs=jobs, budget=0.8 * n * 330.0,
                           until_s=until_s, workload=driver)
    return counters, tracker.summary(), tracker.goodput_tokens()


@pytest.mark.parametrize("autoscale,seed", [(True, 0), (False, 0),
                                            (True, 11)])
def test_open_loop_fleet_runs_equal(autoscale, seed):
    ref, port = _both(_run_workload, autoscale, seed=seed)
    assert ref == port
    if autoscale and seed == 0:
        assert ref[0]["sleeps"] >= 1         # the reference's own gate
