"""The port's power stack on the CPU against the JAX package's, on the same
inputs and the modelled TPU spec: the copies (``hw``, ``core``,
``power``, ``train/phases.py``, ``serve_phase_tasks``) must give the
reference's numbers bit for bit.  Also the H100 spec's own properties."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro import power as jpower  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_model_config as jget_cfg  # noqa: E402
from repro.core.trace import generate_trace as jgenerate_trace  # noqa: E402
from repro.hw import flops as jflops  # noqa: E402
from repro.models.lsms import paper_calibrated_tasks as jlsms_tasks  # noqa: E402
from repro.power.backends import RetryingBackend as JRetrying  # noqa: E402
from repro.serving.engine import serve_phase_tasks as jserve_tasks  # noqa: E402
from repro.train.phases import PhaseEnergyLedger as JLedger  # noqa: E402
from repro.train.phases import training_phase_tasks as jtrain_tasks  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch import power  # noqa: E402
from repro_torch.configs.base import SHAPES, reduced  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_model_config  # noqa: E402
from repro_torch.core.trace import generate_trace  # noqa: E402
from repro_torch.hw import dvfs, flops  # noqa: E402
from repro_torch.hw.h100 import (H100_SUPERCHIP, calibration_profiles,  # noqa: E402
                                 fit_envelope)
from repro_torch.models import lsms  # noqa: E402
from repro_torch.power.backends import RetryingBackend  # noqa: E402
from repro_torch.serving.engine import serve_phase_tasks  # noqa: E402
from repro_torch.train.phases import (PhaseEnergyLedger,  # noqa: E402
                                      training_phase_tasks)

METRICS = ("sed", "ed", "edw")


def _port(tasks):
    """The reference's Task objects as the port's."""
    return [core.Task(**dataclasses.asdict(t)) for t in tasks]


def _rows(table):
    return [dataclasses.astuple(r) for r in table.rows]


def _mixes():
    """name -> reference Task list: the paper's LSMS mix, and each ported
    arch's serving and training phases (full width)."""
    out = {"lsms": jlsms_tasks()}
    for arch in ARCH_IDS:
        cfg = jget_cfg(arch)
        out[f"serve-{arch}"] = jserve_tasks(cfg, batch=128, prompt=32768,
                                            new_tokens=16, chips=256)
        out[f"train-{arch}"] = jtrain_tasks(cfg, batch=8, seq=256)
    return out


MIXES = _mixes()
#: the port's side of each mix: the LSMS mix from the port's own
#: ``paper_calibrated_tasks``, the others the reference's Tasks as the port's
PORT_MIXES = {name: _port(tasks) for name, tasks in MIXES.items()}
PORT_MIXES["lsms"] = lsms.paper_calibrated_tasks()


def test_port_lsms_mix_is_the_references():
    """The port's ``paper_calibrated_tasks`` equals the reference's, field
    for field, so every test below holds the port's own mix."""
    assert PORT_MIXES["lsms"] == _port(MIXES["lsms"])
NOISES = {"exact": None,
          "noisy": dict(sigma_runtime=0.03, sigma_power=0.05, seed=7)}


@pytest.mark.parametrize("noise", NOISES)
@pytest.mark.parametrize("mix", MIXES)
def test_sweep_tables_equal(mix, noise):
    """``measure_sweep`` (every ``simulate_task``) row for row, bit for bit,
    with and without the seeded noise model."""
    kw = NOISES[noise]
    want = jcore.measure_sweep(MIXES[mix], noise=kw and jcore.NoiseModel(**kw))
    got = core.measure_sweep(PORT_MIXES[mix],
                             noise=kw and core.NoiseModel(**kw))
    assert _rows(got) == _rows(want)
    assert got.table1() == want.table1()
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("mix", MIXES)
def test_picks_equal(mix):
    """SED, ED and edw scores and picks, ``rank_caps``, Table 2, GPS-UP and
    the weighted impact for every task, bit for bit."""
    jt = jcore.measure_sweep(MIXES[mix])
    pt = core.measure_sweep(PORT_MIXES[mix])
    for task in jt.tasks():
        for m in METRICS:
            assert power.get_metric(m).score(pt, task) \
                == jpower.get_metric(m).score(jt, task)
            assert power.optimal_cap(m, pt, task) \
                == jpower.optimal_cap(m, jt, task)
            assert power.rank_caps(m, pt, task) \
                == jpower.rank_caps(m, jt, task)
        assert core.sed_optimal_cap(pt, task) \
            == jcore.sed_optimal_cap(jt, task)
        # the ED pin of tests/test_paper_claims.py, on the port's side
        assert power.optimal_cap("ed", pt, task) \
            == core.ed_optimal_cap(pt, task) == jcore.ed_optimal_cap(jt, task)
        assert core.ed_argmin_is_pareto(pt, task)
        assert {c: dataclasses.astuple(g)
                for c, g in core.gps_up(pt, task).items()} \
            == {c: dataclasses.astuple(g)
                for c, g in jcore.gps_up(jt, task).items()}
    assert [dataclasses.astuple(r) for r in core.table2(pt)] \
        == [dataclasses.astuple(r) for r in jcore.table2(jt)]
    assert core.weighted_application_impact(pt) \
        == jcore.weighted_application_impact(jt)


def _session(pkg_core, pkg_power, tasks, **kw):
    """One PowerManager session: decide, phases with calls=, direct
    observations, a grant, re-decisions and exploration."""
    pm = pkg_power.PowerManager(tasks=tasks, **kw)
    log = [tuple((d.task, d.cap, d.metric, d.energy_reduction_pct,
                  d.runtime_increase_pct) for d in pm.decide())]
    names = [t.name for t in tasks]
    for i in range(12):
        name = names[i % len(names)]
        with pm.phase(name, calls=1 + i % 3) as rec:
            pass
        log.append((rec.name, rec.cap,
                    dataclasses.astuple(rec.modeled) if rec.modeled
                    else None))
        if i == 5:
            pm.observe(names[0], 1.5, 300.0)
            pm.set_grant(200.0)
        if i == 9:
            pm.set_grant(None)
    log += [pm.transitions, pm.apply_failures, pm.modeled_energy_j,
            pm.modeled_runtime_s, pm.virtual_now, pm.overhead_totals(),
            dict(pm.schedule.caps), _rows(pm.table),
            pm.applied_caps(), pm.account_step()]
    return log


SESSIONS = {
    "static": dict(metric="sed"),
    "ed-redecide": dict(metric="ed", redecide_every=2, ema_alpha=0.3),
    "explore": dict(metric="edw", redecide_every=3, explore_every=2),
    "goal": {"goal": "goal"},
}


@pytest.mark.parametrize("session", SESSIONS)
@pytest.mark.parametrize("mix", ["lsms", "serve-llama3.2-3b",
                                 "train-olmoe-1b-7b"])
def test_power_manager_sessions_equal(mix, session):
    """The same session on both packages: the same decisions, schedules,
    transitions, modelled totals and refined tables."""
    kw = dict(SESSIONS[session])
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("goal") == "goal":
        jkw["goal"] = jpower.PowerGoal(metric="ed",
                                       max_runtime_increase_pct=5.0)
        pkw["goal"] = power.PowerGoal(metric="ed",
                                      max_runtime_increase_pct=5.0)
    want = _session(jcore, jpower, MIXES[mix], **jkw)
    got = _session(core, power, PORT_MIXES[mix], **pkw)
    assert got == want


def test_phase_energy_ledger_equal():
    tasks = MIXES["train-llama3.2-3b"]
    jpm = jpower.PowerManager(tasks=tasks)
    ppm = power.PowerManager(tasks=_port(tasks))
    want = JLedger(jpm.schedule, tasks)
    got = PhaseEnergyLedger(ppm.schedule, _port(tasks))
    assert got.applied_caps() == want.applied_caps()
    assert got.account_step() == want.account_step()


SPLITS = [
    ({"a": 300.0, "b": 250.0, "c": 120.0}, 600.0, 50.0, None, None),
    ({"a": 300.0, "b": 250.0, "c": 120.0}, 400.0, 50.0, 280.0,
     {"a": 1.0, "b": 3.0, "c": 0.0}),
    ({"a": 330.0, "b": 90.0}, 100.0, {"a": 60.0, "b": 60.0}, None, None),
    ({"x": 200.0}, 1000.0, 0.0, {"x": 150.0}, None),
    ({}, 100.0, 0.0, None, None),
]


@pytest.mark.parametrize("case", range(len(SPLITS)))
def test_weighted_split_equal(case):
    req, budget, floor, ceil, weights = SPLITS[case]
    assert power.weighted_split(req, budget, floor, ceil, weights) \
        == jpower.weighted_split(req, budget, floor, ceil, weights)


@pytest.mark.parametrize("budget", [200.0, 500.0, 900.0, 2000.0])
def test_pod_arbiter_grants_equal(budget):
    tasks = MIXES["train-llama3.2-3b"]
    jsched = jpower.PowerManager(tasks=tasks).schedule
    psched = power.PowerManager(tasks=_port(tasks)).schedule
    rng = np.random.default_rng(int(budget))
    req = {f"chip{i}": float(rng.uniform(60, 330)) for i in range(6)}
    ja, pa = jpower.PodPowerArbiter(budget), power.PodPowerArbiter(budget)
    assert pa.split(req) == ja.split(req)
    for phase in ("attention", "ffn", "optimizer"):
        assert pa.split_phase({f"c{i}": psched for i in range(4)}, phase) \
            == ja.split_phase({f"c{i}": jsched for i in range(4)}, phase)


class _Flaky:
    """A backend whose apply fails ``fails`` times in a row, then lands."""

    transition_seconds = 1e-4
    transition_energy_j = 2e-3

    def __init__(self, fails):
        self.fails, self.current_cap = fails, None

    def apply(self, cap):
        if self.fails:
            self.fails -= 1
            raise RuntimeError("transient")
        self.current_cap = cap

    def measure(self, task, cap):
        raise OSError("no telemetry")


@pytest.mark.parametrize("fails", [0, 2, 3, 7])
def test_retrying_backend_counts_equal(fails):
    """Retries, give-ups, accounted backoff and the last-known-good cap."""
    out = []
    for cls in (JRetrying, RetryingBackend):
        b = cls(_Flaky(fails), max_retries=3, seed=5)
        for cap in (300.0, 250.0, 200.0):
            b.apply(cap)
        out.append((b.retries, b.failed_applies, b.backoff_total_s,
                    b.current_cap, b.measure(None, 1.0), b.failed_measures))
    assert out[0] == out[1]


CFGS = [(arch, red) for arch in ARCH_IDS for red in (False, True)]


@pytest.mark.parametrize("arch,red", CFGS)
def test_phase_tasks_equal(arch, red):
    """``serve_phase_tasks`` and ``training_phase_tasks`` field for field,
    and the parameter counts of ``hw/flops.py`` (over the port's own
    declarations) against the reference's, for every ported arch."""
    jcfg, pcfg = jget_cfg(arch), get_model_config(arch)
    if red:
        jcfg, pcfg = jreduced(jcfg), reduced(pcfg)
    assert flops.active_param_count(pcfg) == jflops.active_param_count(jcfg)
    assert flops.total_param_count(pcfg) == jflops.total_param_count(jcfg)
    for kw in (dict(batch=8, prompt=527, new_tokens=86),
               dict(batch=128, prompt=32768, new_tokens=16, chips=256)):
        assert _port(jserve_tasks(jcfg, **kw)) == serve_phase_tasks(pcfg,
                                                                    **kw)
    for kw in (dict(batch=2, seq=2048), dict(batch=8, seq=256, chips=4)):
        assert _port(jtrain_tasks(jcfg, **kw)) \
            == training_phase_tasks(pcfg, **kw)
    for name, shape in JSHAPES.items():
        assert flops.model_flops(pcfg, SHAPES[name]) \
            == jflops.model_flops(jcfg, shape)
        assert flops.model_bytes(pcfg, SHAPES[name]) \
            == jflops.model_bytes(jcfg, shape)


def test_power_trace_equal():
    want = jgenerate_trace(MIXES["lsms"], 240.0, jitter_sigma=2.0, seed=3)
    got = generate_trace(PORT_MIXES["lsms"], 240.0, jitter_sigma=2.0, seed=3)
    assert [dataclasses.astuple(p) for p in got.points] \
        == [dataclasses.astuple(p) for p in want.points]
    assert (got.energy_total, got.energy_chip, got.energy_host) \
        == (want.energy_total, want.energy_chip, want.energy_host)


def test_retired_steering_names_point_to_power():
    with pytest.raises(AttributeError, match="repro_torch.power"):
        core.PowerSteeringController  # noqa: B018


# ---------------------------------------------------------------------------
# the H100 spec
# ---------------------------------------------------------------------------

def test_h100_caps_and_budget():
    """The sweep runs over whole watts from the card's minimum to its
    maximum limit, the top one the default; the card is the budget."""
    sweep = H100_SUPERCHIP.cap_sweep()
    assert len(sweep) == 9 and sweep == tuple(sorted(sweep))
    assert sweep[0] == H100_SUPERCHIP.limit_min
    assert sweep[-1] == H100_SUPERCHIP.limit_max == H100_SUPERCHIP.p_default
    assert all(c == round(c) for c in sweep)
    assert H100_SUPERCHIP.p_max == H100_SUPERCHIP.limit_max
    assert H100_SUPERCHIP.p_floor == H100_SUPERCHIP.chip.p_idle_floor
    assert H100_SUPERCHIP.chip.peak_flops_bf16 == 989e12
    assert H100_SUPERCHIP.chip.hbm_bandwidth == 3.35e12


@pytest.mark.parametrize("mix", ["lsms", "serve-llama3.2-3b",
                                 "train-mamba2-370m"])
def test_h100_zero_draw_host_stays_finite(mix):
    """A host with no draw divides by zero nowhere: every row finite and
    positive where the task does work, idle phases included, and the pod
    arbiter's floors hold."""
    table = core.measure_sweep(PORT_MIXES[mix], spec=H100_SUPERCHIP)
    for r in table.rows:
        assert math.isfinite(r.runtime) and math.isfinite(r.energy)
        assert r.energy >= 0 and r.runtime >= 0
    pm = power.PowerManager(tasks=PORT_MIXES[mix], spec=H100_SUPERCHIP)
    assert all(c in H100_SUPERCHIP.cap_sweep()
               for c in pm.schedule.caps.values())
    step = pm.account_step()
    assert math.isfinite(step["energy_saving_pct"])
    arb = power.PodPowerArbiter(1500.0, spec=H100_SUPERCHIP)
    grants = arb.split({"a": 700.0, "b": 700.0, "c": 700.0})
    assert sum(grants.values()) == pytest.approx(1500.0)
    assert min(grants.values()) >= H100_SUPERCHIP.p_floor


def test_fit_envelope_reproduces_the_windows():
    """The fitted envelope gives back the measured mean draws of the
    compute- and memory-bound windows at f = 1."""
    fit = fit_envelope(72.0, 690.0, 410.0)
    chip = dataclasses.replace(H100_SUPERCHIP.chip, **fit)
    mm, cp = calibration_profiles(chip)
    assert dvfs.chip_power(chip, mm, 1.0) == pytest.approx(690.0)
    assert dvfs.chip_power(chip, cp, 1.0) == pytest.approx(410.0)
    assert fit["p_static"] == 72.0
