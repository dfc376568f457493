"""Cap backends: the hardware-abstraction layer under ``PowerManager``.

A copy of ``repro/power/backends.py`` for the port.

A backend owns (a) the actual power-limit write and (b) the cost of one
write (``transition_seconds`` / ``transition_energy_j``) — previously
hard-coded in ``CapSchedule``.  Backends that can also *measure* a task
under a cap (the analytic model stands in for Score-P/PAPI/NVML where
there is no telemetry; ``power/nvml.py`` is the card's) return
``TaskMeasurement`` from ``measure``; write-only backends return
``None`` and the manager falls back to its table.

  SimulatedBackend  drives the energy ledger via the DVFS model (default)
  LoggingBackend    wraps any backend, recording every applied cap
  HwmonBackend      stub for real sysfs power-API writes (gated: inert
                    unless the hwmon node exists; apply/measure failures
                    are counted, never raised mid-phase)
  RetryingBackend   decorator: bounded retries with seeded-jitter
                    exponential backoff, last-known-good fallback when
                    the retry budget is exhausted
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

from repro_torch.core.power_model import (NoiseModel, measure_sweep,
                                          simulate_task)
from repro_torch.core.tasks import Task, TaskMeasurement, TaskTable
from repro_torch.hw.tpu import DEFAULT_SUPERCHIP, SuperchipSpec

#: One hwmon power-limit write: syscall + firmware ack (paper section 4:
#: per-task capping must amortize its switching overhead).
TRANSITION_SECONDS = 100e-6
TRANSITION_ENERGY_J = 2e-3


@runtime_checkable
class CapBackend(Protocol):
    """Applies superchip power caps and prices cap transitions."""

    transition_seconds: float
    transition_energy_j: float

    def apply(self, cap: float) -> None:
        """Set the power limit to ``cap`` watts (one power-API write)."""
        ...

    def measure(self, task: Task, cap: float) -> Optional[TaskMeasurement]:
        """Run/estimate ``task`` under ``cap``; None if this backend cannot
        measure (write-only hardware paths)."""
        ...


@dataclasses.dataclass
class SimulatedBackend:
    """Analytic DVFS-model backend: 'applying' a cap is bookkeeping, and
    measurement comes from the first-principles power model."""

    spec: SuperchipSpec = dataclasses.field(
        default_factory=lambda: DEFAULT_SUPERCHIP)
    noise: NoiseModel | None = None
    transition_seconds: float = TRANSITION_SECONDS
    transition_energy_j: float = TRANSITION_ENERGY_J
    current_cap: float | None = None
    writes: int = 0

    def apply(self, cap: float) -> None:
        self.current_cap = cap
        self.writes += 1

    def measure(self, task: Task, cap: float) -> TaskMeasurement:
        return simulate_task(task, cap, self.spec, self.noise)

    def sweep(self, tasks: list[Task],
              caps: tuple[float, ...] | None = None) -> TaskTable:
        """The paper's offline experiment: every task at every cap."""
        return measure_sweep(tasks, caps, self.spec, self.noise)


@dataclasses.dataclass
class LoggingBackend:
    """Decorator backend: records every applied cap (and forwards to an
    inner backend when given one) — the audit trail for production runs."""

    inner: CapBackend | None = None
    log: list[float] = dataclasses.field(default_factory=list)

    @property
    def transition_seconds(self) -> float:
        return self.inner.transition_seconds if self.inner \
            else TRANSITION_SECONDS

    @property
    def transition_energy_j(self) -> float:
        return self.inner.transition_energy_j if self.inner \
            else TRANSITION_ENERGY_J

    def apply(self, cap: float) -> None:
        self.log.append(cap)
        if self.inner is not None:
            self.inner.apply(cap)

    def measure(self, task: Task, cap: float) -> Optional[TaskMeasurement]:
        return self.inner.measure(task, cap) if self.inner else None


class HwmonBackend:
    """Real power-API write path (stub): ``power1_cap`` under a hwmon node,
    in microwatts.  Inert where the node does not exist (``available()``
    is False); the card's counterpart is ``power.nvml.NvmlBackend``.

    A flipped-read-only or vanished hwmon node must not kill a run
    mid-phase: apply failures (missing node, ``OSError``,
    ``PermissionError``) are counted in ``errors`` and otherwise
    swallowed; the manager's phase loop keeps running at whatever cap
    last stuck.  On GH200-class hosts the node is e.g.
    ``/sys/class/hwmon/hwmon*/device/power1_cap``; deployment wires the
    concrete path in.
    """

    transition_seconds = TRANSITION_SECONDS
    transition_energy_j = TRANSITION_ENERGY_J

    def __init__(self, node: str = "/sys/class/hwmon/hwmon0/power1_cap"):
        self.node = node
        self.errors = 0
        self.current_cap: float | None = None

    def available(self) -> bool:
        import os
        try:
            return os.access(self.node, os.W_OK)
        except OSError:
            return False

    def apply(self, cap: float) -> None:
        try:
            with open(self.node, "w") as f:
                f.write(str(int(cap * 1e6)))  # watts -> microwatts
            self.current_cap = cap
        except (OSError, PermissionError):
            self.errors += 1

    def measure(self, task: Task, cap: float) -> None:
        return None  # write-only: measurements come from real telemetry


def jitter_unit(seed: int, n: int) -> float:
    """Deterministic hash of (seed, n) to [0, 1): stable across processes
    (unlike ``hash``) and free of shared-RNG ordering hazards."""
    x = (seed * 0x9E3779B1 + n * 0x85EBCA6B + 0x27D4EB2F) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & 0xFFFFFFFF
    x ^= x >> 12
    return x / 2 ** 32


@dataclasses.dataclass
class RetryingBackend:
    """Decorator: tolerate transient apply/measure failures.

    ``apply`` retries up to ``max_retries`` extra attempts with
    exponential backoff (seeded jitter keeps many nodes from hammering a
    shared power API in lockstep while staying deterministic).  When the
    budget is exhausted the failure is swallowed: ``current_cap`` keeps
    the last cap that actually stuck (last-known-good fallback) and
    ``failed_applies`` is incremented so callers — ``PowerManager``
    checks exactly this — can see the write did not land.  ``measure``
    failures degrade to ``None`` (manager falls back to its table).

    Backoff is *accounted*, not slept, unless a ``sleep_fn`` is given:
    virtual-clock callers read ``backoff_total_s`` and charge it
    themselves.

    ``tracer``/``trace_track``/``now_fn`` optionally emit a
    ``cap_retry`` instant per retry and a ``cap_giveup`` instant per
    exhausted budget (``now_fn`` supplies the virtual timestamp — the
    fault injector wires it to its own clock).
    """

    inner: CapBackend
    max_retries: int = 3
    backoff_s: float = 1e-3
    jitter: float = 0.25
    seed: int = 0
    sleep_fn: object = None
    retries: int = 0
    failed_applies: int = 0
    failed_measures: int = 0
    backoff_total_s: float = 0.0
    current_cap: float | None = None
    tracer: object = None
    trace_track: str = "power"
    now_fn: object = None

    def _emit(self, name: str, args: dict) -> None:
        tr = self.tracer
        if tr is None or not tr.enabled:
            return
        t = self.now_fn() if self.now_fn is not None else 0.0
        tr.instant(name, t, self.trace_track, cat="power", args=args)

    def apply(self, cap: float) -> None:
        for attempt in range(self.max_retries + 1):
            try:
                self.inner.apply(cap)
                self.current_cap = cap
                return
            except (OSError, RuntimeError):
                if attempt == self.max_retries:
                    self.failed_applies += 1
                    self._emit("cap_giveup",
                               {"cap_w": cap, "attempts": attempt + 1})
                    return  # fall back to last-known-good (current_cap)
                self.retries += 1
                delay = self.backoff_s * 2 ** attempt
                delay *= 1.0 + self.jitter * jitter_unit(self.seed,
                                                         self.retries)
                self.backoff_total_s += delay
                self._emit("cap_retry",
                           {"cap_w": cap, "attempt": attempt + 1,
                            "backoff_s": delay})
                if self.sleep_fn is not None:
                    self.sleep_fn(delay)

    def measure(self, task: Task, cap: float) -> Optional[TaskMeasurement]:
        try:
            return self.inner.measure(task, cap)
        except (OSError, RuntimeError):
            self.failed_measures += 1
            return None

    @property
    def transition_seconds(self) -> float:
        return self.inner.transition_seconds

    @property
    def transition_energy_j(self) -> float:
        return self.inner.transition_energy_j

    def __getattr__(self, name: str):
        # Forward e.g. SimulatedBackend.sweep/writes so capability probes
        # (hasattr) see exactly what the inner backend offers.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)
