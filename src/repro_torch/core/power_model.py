"""Analytic power/energy model: (task, superchip cap) -> (runtime, energy).

A copy of ``repro/core/power_model.py`` for the port.

This is the measurement substrate that replaces the paper's Score-P/PAPI/NVML
telemetry where there are no power counters (on the card,
``power/metered.py`` measures instead).  It composes

  * the DVFS model (hw/dvfs.py): cap -> sustainable clock -> phase times,
  * GH200-style automatic power steering: within one superchip budget the
    HOST draws first and the remaining headroom is steered to the accelerator
    (paper section 2), and
  * an optional seeded measurement-noise model so downstream metric code is
    exercised against non-smooth data, as real 5 ms sampling would produce.

The model is intentionally first-principles: the paper's qualitative claims
(compute-bound tasks throttle early and want high caps; memory-bound tasks are
insensitive and want low caps; idle phases want the floor) all FALL OUT of the
roofline + f^3 decomposition rather than being hard-coded.  Tests in
tests/test_paper_claims.py assert exactly those emergent behaviors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.tasks import Task, TaskMeasurement, TaskTable
from repro_torch.hw.dvfs import chip_power, clock_for_cap, idle_power
from repro_torch.hw.tpu import DEFAULT_SUPERCHIP, SuperchipSpec


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Multiplicative log-normal measurement noise, seeded and per-(task,cap)
    deterministic so repeated 'runs' average like the paper's 3-run mean."""

    sigma_runtime: float = 0.0
    sigma_power: float = 0.0
    runs: int = 3
    seed: int = 0

    def apply(self, task: str, cap: float, runtime: float,
              energy: float) -> tuple[float, float]:
        if self.sigma_runtime == 0 and self.sigma_power == 0:
            return runtime, energy
        key = abs(hash((task, int(cap * 1000), self.seed))) % (2**32)
        rng = np.random.default_rng(key)
        rt = float(np.mean(runtime *
                           np.exp(rng.normal(0, self.sigma_runtime, self.runs))))
        en = float(np.mean(energy *
                           np.exp(rng.normal(0, self.sigma_power, self.runs))))
        return rt, en


def _host_clock_for_budget(spec: SuperchipSpec, budget: float) -> float:
    """Max host clock fraction whose power fits in ``budget`` (host priority,
    but it can never squeeze the chip below static draw)."""
    host = spec.host
    lo, hi = host.f_min, host.f_max

    def p(f: float) -> float:
        return host.p_idle + (host.p_max - host.p_idle) * f**3

    if p(hi) <= budget:
        return hi
    if p(lo) >= budget:
        return lo
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if p(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def simulate_task(task: Task, cap: float,
                  spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                  noise: NoiseModel | None = None) -> TaskMeasurement:
    """Run one task (all its calls) under one superchip-level cap."""
    chip, host = spec.chip, spec.host

    if task.is_idle:
        # --- host-compute phase: accelerator idle, host does the work -----
        # Steering: host draws first, up to (cap - chip deep-idle floor).
        host_budget = max(cap - chip.p_idle_floor, host.p_idle)
        f_h = _host_clock_for_budget(spec, host_budget)
        host_seconds = (task.host_seconds if task.host_seconds > 0
                        else task.host_flops / (host.peak_flops * f_h)
                        if task.host_flops > 0 else 0.0)
        if task.host_seconds > 0:
            host_seconds = task.host_seconds / f_h
        runtime = host_seconds * task.calls
        p_host = host.p_idle + (host.p_max - host.p_idle) * f_h**3
        # whatever the host does not take is available to the (idle) chip,
        # which parks at a budget-dependent clock (see hw.dvfs.idle_power).
        p_chip = idle_power(chip, max(cap - p_host, chip.p_idle_floor))
        energy = runtime * (p_host + p_chip)
        clock = f_h
    else:
        # --- accelerator phase: host near-idle, chip gets the headroom -----
        p_host = host.p_idle
        chip_budget = max(cap - p_host, chip.p_static)
        work = task.work_profile(chip)
        f = clock_for_cap(chip, work, chip_budget)
        per_call = work.duration(f)
        runtime = per_call * task.calls
        p_chip = chip_power(chip, work, f)
        energy = runtime * (p_chip + p_host)
        clock = f

    if noise is not None:
        runtime, energy = noise.apply(task.name, cap, runtime, energy)
    return TaskMeasurement(task=task.name, cap=cap, runtime=runtime,
                           energy=energy, clock_fraction=clock)


def measure_sweep(tasks: list[Task],
                  caps: tuple[float, ...] | None = None,
                  spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                  noise: NoiseModel | None = None) -> TaskTable:
    """The paper's experiment: run every task at every cap setting."""
    caps = caps if caps is not None else spec.cap_sweep()
    rows = [simulate_task(t, c, spec, noise) for t in tasks for c in caps]
    return TaskTable(rows)
