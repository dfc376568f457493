"""The port's observability layer (``repro_torch.obs``: the trace export,
the energy ledger, the SLO burn monitor) against ``repro.obs``:

  * ``tests/test_obs.py``'s traced chaos run (faults, watchdog, shadow
    checkpoints, open-loop SLO traffic) through both packages: the
    Chrome/Perfetto trace JSON and the metrics JSONL equal byte for
    byte, and the ledger's rollup, summary and conservation error equal
    with ``==``, for three seeds;
  * the launcher's ``--trace-out``/``--metrics-out`` files, byte for byte;
  * ``SLOBurnMonitor`` over a scripted resolve stream;
  * ``request_costs`` over a traced serving engine with a power session
    (reduced f32 llama3.2-3b; the JAX engine and the port's CPU engine on
    one weight set): equal costs per request, and every modelled joule
    the engine traced lands on exactly one request."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs.registry as jregistry  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.hw.tpu as jtpu  # noqa: E402
import repro.launch.fleet as jlaunch  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.workload as jworkload  # noqa: E402
import repro_torch.configs.registry as tregistry  # noqa: E402
import repro_torch.fleet as tfleet  # noqa: E402
import repro_torch.hw.tpu as ttpu  # noqa: E402
import repro_torch.launch.fleet as tlaunch  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.workload as tworkload  # noqa: E402

PKGS = {
    "repro": types.SimpleNamespace(fleet=jfleet, workload=jworkload,
                                   obs=jobs, tpu=jtpu,
                                   cfg=jregistry.get_model_config),
    "repro_torch": types.SimpleNamespace(fleet=tfleet, workload=tworkload,
                                         obs=tobs, tpu=ttpu,
                                         cfg=tregistry.get_model_config),
}


def _both(fn, *args, **kw):
    return fn(PKGS["repro"], *args, **kw), fn(PKGS["repro_torch"], *args,
                                              **kw)


def _traced_chaos_run(P, seed):
    """``tests/test_obs.py::_traced_chaos_run`` through package ``P``."""
    F, W, O = P.fleet, P.workload, P.obs
    names = [f"cab{i // 4}/n{i:02d}" for i in range(3)]
    evs = F.chaos_schedule(seed, names, 40.0, crashes=1, hangs=0,
                           cap_faults=1, telemetry_faults=1, stragglers=1,
                           repair_s=8.0)
    tracer = O.Tracer()
    c = F.SimulatedCluster(
        n_nodes=4, cabinet_size=4, faults=F.FaultInjector(evs, seed=seed),
        watchdog_deadline_s=2.5, shadow_ckpt_s=3.0, tracer=tracer)
    monitor = O.SLOBurnMonitor(window_s=10.0)
    tracker = W.SLOTracker(sink=c.telemetry, monitor=monitor)
    driver = W.WorkloadDriver(
        list(W.diurnal_trace(seed=seed, until_s=40.0, base_rps=4.0)),
        tracker)
    cfg = P.cfg("llama3.2-3b")
    jobs_ = [F.ServeJob(f"s{i}", cfg, batch=8, prompt=256, new_tokens=64,
                        total_requests=0, decode_chunk=8, open_loop=True,
                        migrate=True, partial=True, max_restarts=16,
                        backoff_jitter=0.25, slo=tracker)
             for i in range(3)]
    out = c.run(jobs_, budget=4 * P.tpu.DEFAULT_SUPERCHIP.p_max,
                until_s=40.0, workload=driver)
    return tracer, out, monitor.snapshot(), tracker.summary()


@pytest.fixture(scope="module")
def chaos_runs():
    return {seed: _both(_traced_chaos_run, seed) for seed in (0, 1, 2)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_exports_equal_byte_for_byte(chaos_runs, seed, tmp_path):
    (jt, jout, _, _), (tt, tout, _, _) = chaos_runs[seed]
    assert jout == tout
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    jobs.dump_chrome_trace(jt, str(a))
    tobs.dump_chrome_trace(tt, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert tobs.chrome_trace(tt) == jobs.chrome_trace(jt)
    assert tobs.metrics_jsonl(tt) == jobs.metrics_jsonl(jt)
    a, b = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    jobs.dump_metrics_jsonl(jt, str(a))
    tobs.dump_metrics_jsonl(tt, str(b))
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energy_ledger_equal_and_conserved(chaos_runs, seed):
    (jt, jout, _, _), (tt, tout, _, _) = chaos_runs[seed]
    jl, tl = jobs.EnergyLedger(jt), tobs.EnergyLedger(tt)
    assert tl.rollup == jl.rollup
    assert tl.summary() == jl.summary()
    assert tl.phase_j() == jl.phase_j()
    assert tl.conservation_error(tout["energy_j"]) == \
        jl.conservation_error(jout["energy_j"])
    tl.assert_conserved(tout["energy_j"])
    if seed == 1:               # the seed whose telemetry fault bites
        assert tl.lost_j > 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_burn_snapshot_equal(chaos_runs, seed):
    (_, _, jsnap, jsum), (_, _, tsnap, tsum) = chaos_runs[seed]
    assert jsnap and tsnap == jsnap
    assert tsum == jsum


def _burn_script(P):
    m = P.obs.SLOBurnMonitor(window_s=5.0,
                             targets={"interactive": 0.99})
    rng = np.random.default_rng(4)
    out = []
    for i in range(200):
        t = 0.1 * i
        name = ("interactive", "standard", "batch")[i % 3]
        m.resolve(name, bool(rng.random() < 0.9), t)
        if i % 20 == 19:
            out.append((m.snapshot(t), m.burning(t),
                        m.attainment("interactive", t),
                        m.burn_rate("batch", t)))
    return out


def test_slo_burn_monitor_scripted_equal():
    ref, port = _both(_burn_script)
    assert ref == port


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


@pytest.mark.parametrize("extra", [["--chaos-seed", "1", "--watchdog-s",
                                    "2.5", "--ckpt-s", "3"],
                                   ["--workload", "diurnal", "--autoscale"]])
def test_launcher_trace_files_equal(extra, tmp_path):
    outs, files = [], []
    for name, module in (("ref", jlaunch), ("port", tlaunch)):
        tr, mx = tmp_path / f"{name}.json", tmp_path / f"{name}.jsonl"
        out = _launch(module, ["--nodes", "4", "--duration", "20",
                               "--trace-out", str(tr), "--metrics-out",
                               str(mx)] + extra)
        outs.append(out.replace(str(tr), "TRACE").replace(str(mx), "MX"))
        files.append((tr.read_bytes(), mx.read_bytes()))
    assert outs[0] == outs[1] and "[obs] energy attribution" in outs[0]
    assert files[0] == files[1]


# -- request_costs over a traced engine -------------------------------------

def _costs(costs):
    return {uid: dataclasses.astuple(c) for uid, c in sorted(costs.items())}


def test_request_costs_equal_and_conserved():
    """``tests/test_obs.py::test_request_costs_decomposition`` on both
    engines: a modelled power session, a traced engine, three requests
    through two slots."""
    from repro.configs.base import reduced as jreduced
    from repro.models import lm as jlm
    from repro.models.layers import Ctx as JCtx
    from repro.models.params import init_params as jinit
    from repro.power import PowerManager as JPowerManager
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServeEngine as JServeEngine
    from repro.serving.engine import serve_phase_tasks as jtasks
    from repro.sharding import RULE_SETS
    from repro_torch.configs.base import reduced
    from repro_torch.models.layers import Ctx
    from repro_torch.models.params import load_numpy_params
    from repro_torch.power import PowerManager
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.engine import serve_phase_tasks

    arch = "llama3.2-3b"
    jcfg = jreduced(jregistry.get_model_config(arch))
    jrun = jregistry.get_run_config(arch, remat="none", logits_chunk=16,
                                    compute_dtype="float32")
    jparams = jinit(jlm.model_decls(jcfg), jax.random.PRNGKey(0))
    jtracer = jobs.Tracer()
    jeng = JServeEngine(
        jcfg, jrun, JCtx(jrun, RULE_SETS[jrun.serve_rules_name], None),
        jparams, batch_size=2, max_seq=32, decode_chunk=4, tracer=jtracer,
        power=JPowerManager(tasks=jtasks(
            jregistry.get_model_config(arch), batch=128, prompt=32768,
            new_tokens=8, chips=256)))
    jdone = jeng.generate([JRequest(uid=i, prompt=[1 + i, 2, 3],
                                    max_new_tokens=4) for i in range(3)])

    cfg = reduced(tregistry.get_model_config(arch))
    run = tregistry.get_run_config(arch, remat="none", logits_chunk=16,
                                   compute_dtype="float32")
    params = load_numpy_params(jax.tree.map(np.asarray, jparams), "cpu")
    tracer = tobs.Tracer()
    eng = ServeEngine(
        cfg, run, Ctx(run, "cpu"), params, batch_size=2, max_seq=32,
        decode_chunk=4, tracer=tracer,
        power=PowerManager(tasks=serve_phase_tasks(
            tregistry.get_model_config(arch), batch=128, prompt=32768,
            new_tokens=8, chips=256)))
    done = eng.generate([Request(uid=i, prompt=[1 + i, 2, 3],
                                 max_new_tokens=4) for i in range(3)])
    assert {r.uid: r.generated for r in done} == \
        {r.uid: r.generated for r in jdone}

    costs = tobs.request_costs(tracer)
    assert _costs(costs) == _costs(jobs.request_costs(jtracer))
    assert sorted(costs) == [0, 1, 2]
    assert max(c.queue_wait_s for c in costs.values()) > 0.0
    span_j = sum(float(s.args.get("energy_j", 0.0))
                 for s in tracer.spans_by_cat("phase"))
    assert span_j > 0.0
    assert sum(c.total_j for c in costs.values()) == \
        pytest.approx(span_j, rel=1e-9)
    assert tobs.chrome_trace(tracer) == jobs.chrome_trace(jtracer)
