"""PowerManager: the online power-capping session.

A copy of ``repro/power/manager.py`` for the port.

This is the runtime form of the paper's future work ("adaptive,
task-specific dynamic power-cap adjustment"): one object that

  1. decides per-task caps from a TaskTable with any registered metric,
     under an optional user goal (max runtime increase / min energy
     saving — paper section 4, last paragraph),
  2. applies caps through a pluggable ``CapBackend`` as the loop enters
     phases (``with pm.phase("attention"): ...``), coalescing writes the
     backend would charge for,
  3. refines the TaskTable online from ``observe()``-fed measurements
     (EWMA) and periodically re-decides the schedule — with optional
     round-robin cap exploration so drifted tasks get re-profiled, and
  4. accounts modeled per-step energy (the ``PhaseEnergyLedger`` duties,
     now owned here).

Offline use (the old ``PowerSteeringController`` flow) is
``PowerManager(table=...).schedule``; the ``core.steering`` shim is
retired (importing it raises with a pointer here).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator

from repro_torch.core.tasks import (Task, TaskMeasurement, TaskTable,
                                    caps_equal)
from repro_torch.hw.tpu import DEFAULT_SUPERCHIP, SuperchipSpec
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.power.backends import (CapBackend, SimulatedBackend,
                                        TRANSITION_ENERGY_J,
                                        TRANSITION_SECONDS)
from repro_torch.power.metrics import (Metric, get_metric, optimal_cap,
                                       rank_caps)


@dataclasses.dataclass(frozen=True)
class PowerGoal:
    """User-defined filter over candidate caps (paper section 4, last
    paragraph).  ``metric`` may be a registry name or a Metric instance."""

    metric: "str | Metric" = "sed"
    max_runtime_increase_pct: float | None = None
    min_energy_saving_pct: float | None = None


#: Historical name, kept as a true alias so old isinstance checks hold.
SteeringGoal = PowerGoal


@dataclasses.dataclass(frozen=True)
class CapDecision:
    task: str
    cap: float
    metric: str
    energy_reduction_pct: float
    runtime_increase_pct: float


@dataclasses.dataclass
class CapSchedule:
    """phase name -> superchip cap (W), plus transition cost accounting.

    Transition costs default to the module constants but are stamped from
    the owning backend when a ``PowerManager`` builds the schedule."""

    caps: dict[str, float]
    default_cap: float
    transition_seconds: float = TRANSITION_SECONDS
    transition_energy_j: float = TRANSITION_ENERGY_J

    def cap_for(self, phase: str) -> float:
        return self.caps.get(phase, self.default_cap)

    def transitions(self, phase_sequence: list[str]) -> int:
        """Number of cap changes across a phase sequence (coalescing
        equal — within tolerance — neighboring caps: no API write if the
        setting does not change)."""
        n, prev = 0, None
        for ph in phase_sequence:
            cap = self.cap_for(ph)
            if prev is not None and not caps_equal(cap, prev):
                n += 1
            prev = cap
        return n

    def overhead(self, phase_sequence: list[str]) -> tuple[float, float]:
        n = self.transitions(phase_sequence)
        return n * self.transition_seconds, n * self.transition_energy_j


@dataclasses.dataclass
class PhaseRecord:
    """One ``pm.phase(...)`` entry: what cap ran and what it cost."""

    name: str
    cap: float
    wall_s: float = 0.0
    modeled: TaskMeasurement | None = None


class PowerManager:
    """Session object owning table -> decisions -> applied caps, online.

    Parameters
    ----------
    table:     (task x cap) measurements.  Omit it and pass ``tasks`` to
               have the backend sweep them (simulated backends only).
    tasks:     Task definitions, enabling modeled measurement inside
               ``phase()`` and ``account_step()``.
    metric:    registry name or Metric instance (ignored when ``goal``
               is given — the goal carries its own metric).
    backend:   CapBackend; default SimulatedBackend(spec).
    min_dwell_s:     phases whose uncapped runtime is shorter inherit the
               previous cap instead of paying a power-API write.
    redecide_every:  re-decide the schedule after every N observations
               (0 = offline/static schedule).
    ema_alpha:       weight of a new observation when refining the table.
    explore_every:   every N-th visit to a phase probes a sweep cap
               instead of the scheduled one (0 = never), so online
               observations keep the whole curve fresh under drift.
    cap_limit:       externally imposed ceiling on every applied cap
               (watts) — the hook a fleet-level arbiter uses to grant this
               node less than its schedule asks for.  ``None`` = no limit;
               see ``set_grant``.
    history_limit:   PhaseRecords kept (tail); aggregate counters are
               unbounded.
    tracer:    optional ``repro_torch.obs.Tracer``: every landed cap write
               and every modeled phase measurement is emitted as an instant /
               span on track ``trace_track`` at the session's modeled
               virtual time (``virtual_now``).  Default ``NULL_TRACER``
               (zero cost).  Fleet nodes leave this off — the node's
               ``run_quantum`` emits richer spans on the cluster clock.
    """

    def __init__(self, table: TaskTable | None = None, *,
                 tasks: list[Task] | None = None,
                 metric: "str | Metric" = "sed",
                 goal: PowerGoal | None = None,
                 backend: CapBackend | None = None,
                 spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                 schedule: CapSchedule | None = None,
                 min_dwell_s: float = 1e-3,
                 redecide_every: int = 0,
                 ema_alpha: float = 0.5,
                 explore_every: int = 0,
                 cap_limit: float | None = None,
                 history_limit: int = 1024,
                 tracer=None, trace_track: str = "power"):
        self.spec = spec
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_track = trace_track
        self.backend = backend if backend is not None \
            else SimulatedBackend(spec)
        self.goal = goal if goal is not None else PowerGoal(metric=metric)
        self.tasks: dict[str, Task] = {t.name: t for t in (tasks or [])}
        if table is None:
            table = self._sweep(tasks) if tasks else TaskTable([])
        self.table = table
        self.min_dwell_s = min_dwell_s
        self.redecide_every = redecide_every
        self.ema_alpha = ema_alpha
        self.explore_every = explore_every
        self.cap_limit = cap_limit
        self.history_limit = history_limit
        self.history: list[PhaseRecord] = []
        self.transitions = 0
        self.apply_failures = 0
        # aggregate modeled totals across ALL phase entries — unlike
        # ``history`` these are never trimmed, so long sessions (one
        # decode chunk per K served tokens) can report totals exactly
        self.modeled_energy_j = 0.0
        self.modeled_runtime_s = 0.0
        self._current_cap: float | None = None
        self._n_obs = 0
        self._visits: dict[str, int] = {}
        self._probe_idx: dict[str, int] = {}
        self.schedule = schedule if schedule is not None \
            else self._make_schedule()

    def _sweep(self, tasks: list[Task]) -> TaskTable:
        """Profile ``tasks`` across the cap sweep through the backend; an
        unmeasurable (write-only) backend yields an empty table — callers
        must then supply measurements via ``table=`` or ``observe()``."""
        if hasattr(self.backend, "sweep"):
            return self.backend.sweep(tasks)
        rows = []
        for t in tasks:
            for c in self.spec.cap_sweep():
                m = self.backend.measure(t, c)
                if m is None:
                    return TaskTable([])
                rows.append(m)
        return TaskTable(rows)

    # -- selection ---------------------------------------------------------
    def decide(self, table: TaskTable | None = None,
               goal: PowerGoal | None = None) -> list[CapDecision]:
        """Per-task cap decisions (the old controller's ``decide``)."""
        table = table if table is not None else self.table
        goal = goal if goal is not None else self.goal
        metric = get_metric(goal.metric)
        decisions = []
        for task in table.tasks():
            cap = self._pick(table, task, goal)
            base = table.baseline(task)
            row = table.at(task, cap)
            decisions.append(CapDecision(
                task=task, cap=cap, metric=metric.name,
                energy_reduction_pct=(base.energy - row.energy)
                / base.energy * 100 if base.energy else 0.0,
                runtime_increase_pct=(row.runtime - base.runtime)
                / base.runtime * 100 if base.runtime else 0.0,
            ))
        return decisions

    def _pick(self, table: TaskTable, task: str, goal: PowerGoal) -> float:
        if goal.max_runtime_increase_pct is None and \
           goal.min_energy_saving_pct is None:
            return optimal_cap(goal.metric, table, task)

        base = table.baseline(task)
        for cand in rank_caps(goal.metric, table, task):  # best-first
            row = table.at(task, cand)
            dt = (row.runtime - base.runtime) / base.runtime * 100 \
                if base.runtime else 0.0
            de = (base.energy - row.energy) / base.energy * 100 \
                if base.energy else 0.0
            if goal.max_runtime_increase_pct is not None and \
               dt > goal.max_runtime_increase_pct:
                continue
            if goal.min_energy_saving_pct is not None and \
               de < goal.min_energy_saving_pct:
                continue
            return cand
        return base.cap  # nothing satisfies the goal: stay uncapped

    def _make_schedule(self) -> CapSchedule:
        decisions = self.decide() if self.table.rows else []
        return CapSchedule(
            caps={d.task: d.cap for d in decisions},
            default_cap=self.spec.p_default,
            transition_seconds=self.backend.transition_seconds,
            transition_energy_j=self.backend.transition_energy_j)

    def redecide(self) -> CapSchedule:
        """Recompute the schedule from the (online-refined) table.  A
        table with no measurements keeps the current schedule."""
        if self.table.rows:
            self.schedule = self._make_schedule()
        return self.schedule

    # -- online session ----------------------------------------------------
    @property
    def virtual_now(self) -> float:
        """The session's modeled virtual clock: accounted phase runtime
        plus the transition time of every landed cap write — the
        timebase standalone-session trace spans are stamped with."""
        return (self.modeled_runtime_s
                + self.transitions * self.backend.transition_seconds)

    def cap_for(self, phase: str) -> float:
        return self.schedule.cap_for(phase)

    def set_grant(self, cap_w: float | None) -> None:
        """Install a fleet-granted ceiling: every applied cap is clamped to
        ``cap_w`` until the next grant (``None`` clears the limit).  This
        is how a fleet arbiter (the JAX package's ``repro.fleet``) reaches
        into a node's session — the schedule still names the *wanted*
        per-phase caps (the node's requests), the grant bounds what
        actually gets written."""
        self.cap_limit = cap_w

    def next_cap(self, phase: str) -> float:
        """Scheduled cap for ``phase`` — except every ``explore_every``-th
        visit, which probes the sweep round-robin to keep the table's
        off-schedule rows refreshable under drift.  Always clamped to the
        fleet grant (``cap_limit``) when one is installed."""
        cap = self.schedule.cap_for(phase)
        if self.explore_every:
            n = self._visits[phase] = self._visits.get(phase, 0) + 1
            if not n % self.explore_every:
                sweep = ([r.cap for r in self.table.for_task(phase)]
                         or list(self.spec.cap_sweep()))
                i = self._probe_idx[phase] = \
                    (self._probe_idx.get(phase, -1) + 1) % len(sweep)
                cap = sweep[i]
        if self.cap_limit is not None:
            cap = min(cap, self.cap_limit)
        return cap

    def apply_cap(self, cap: float) -> bool:
        """Write ``cap`` through the backend unless it is already set
        (coalescing — a no-op write costs nothing).

        Failure-tolerant: a backend that raises ``OSError``/``RuntimeError``
        or a retrying decorator that exhausts its budget (visible as
        ``current_cap`` diverging from the requested cap) does not kill the
        phase — ``apply_failures`` is incremented, ``_current_cap`` is left
        unchanged so the next phase entry retries, and the caller learns
        via the False return that the node still runs at its old cap."""
        if self._current_cap is not None and \
           caps_equal(cap, self._current_cap):
            return False
        try:
            self.backend.apply(cap)
        except (OSError, RuntimeError):
            self.apply_failures += 1
            return False
        cur = getattr(self.backend, "current_cap", None)
        if cur is not None and not caps_equal(cur, cap):
            self.apply_failures += 1  # swallowed downstream: write lost
            return False
        self.transitions += 1
        self._current_cap = cap
        return True

    @contextlib.contextmanager
    def phase(self, name: str,
              calls: int | None = None) -> Iterator[PhaseRecord]:
        """Run a named phase under its (possibly probed) cap:

            with pm.phase("attention"):
                ...  # the capped region

        Applies the cap on entry; on exit, records wall time and — when the
        backend can measure the registered Task — feeds the measurement to
        ``observe()``, driving the adaptive loop.

        ``calls`` overrides the registered task's per-phase call count for
        this entry: a serving runtime that enters ``phase("decode",
        calls=K)`` once per K-token chunk amortizes the cap write, the
        wall-clock reads and the EWMA/observe bookkeeping over K tokens
        while the modeled measurement (``rec.modeled``) still accounts all
        K calls.  The table observation is re-normalized to the registered
        task's canonical call count so chunk-scale samples never blend
        into rows measured at a different scale."""
        cap = self.next_cap(name)
        tr = self.tracer if self.tracer.enabled else None
        t_entry = self.virtual_now
        if self.apply_cap(cap) and tr is not None:
            tr.instant("cap_write", t_entry, self.trace_track, cat="power",
                       args={"cap_w": cap,
                             "energy_j": self.backend.transition_energy_j,
                             "seconds": self.backend.transition_seconds})
        rec = PhaseRecord(name=name, cap=cap)
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec.wall_s = time.perf_counter() - t0
            task = self.tasks.get(name)
            m = None
            if task is not None:
                eff = task if calls is None \
                    else dataclasses.replace(task, calls=calls)
                try:
                    m = self.backend.measure(eff, cap)
                except (OSError, RuntimeError):
                    m = None  # transient telemetry failure: skip observe

            if m is not None:
                rec.modeled = m
                if tr is not None:
                    t0v = self.virtual_now
                    tr.span(name, t0v, t0v + m.runtime, self.trace_track,
                            cat="phase",
                            args={"energy_j": m.energy, "cap_w": cap})
                self.modeled_energy_j += m.energy
                self.modeled_runtime_s += m.runtime
                scale = 1.0 if calls in (None, 0) else task.calls / calls
                self.observe(name, m.runtime * scale, m.energy * scale,
                             cap=cap, clock_fraction=m.clock_fraction)
            self.history.append(rec)
            # long-lived sessions (one decode phase per served token):
            # keep the tail only; aggregates live in self.transitions etc.
            if len(self.history) > self.history_limit:
                del self.history[:len(self.history) - self.history_limit]

    def observe(self, task: str, runtime: float, energy: float,
                cap: float | None = None,
                clock_fraction: float = 1.0) -> None:
        """Feed one (task, cap) measurement from live telemetry.  Refines
        the table (EWMA) and, every ``redecide_every`` observations,
        re-decides the cap schedule — the paper's adaptive loop."""
        if cap is None:
            cap = self._current_cap if self._current_cap is not None \
                else self.schedule.cap_for(task)
        self.table.observe(
            TaskMeasurement(task=task, cap=cap, runtime=runtime,
                            energy=energy, clock_fraction=clock_fraction),
            alpha=self.ema_alpha)
        self._n_obs += 1
        if self.redecide_every and self._n_obs % self.redecide_every == 0:
            self.redecide()

    def overhead_totals(self) -> tuple[float, float]:
        """(seconds, joules) spent on cap transitions so far this session."""
        return (self.transitions * self.backend.transition_seconds,
                self.transitions * self.backend.transition_energy_j)

    # -- modeled per-step accounting (the energy-ledger duties) ------------
    def _measure(self, task: Task, cap: float) -> TaskMeasurement:
        try:
            m = self.backend.measure(task, cap)
        except (OSError, RuntimeError):
            m = None
        if m is None:  # write-only backend: fall back to the table
            try:
                m = self.table.at(task.name, cap)
            except KeyError:
                raise RuntimeError(
                    f"backend {type(self.backend).__name__} cannot measure "
                    f"and the table has no row for ({task.name!r}, {cap}); "
                    "supply table= measurements or feed observe()"
                ) from None
        return m

    def applied_caps(self,
                     tasks: list[Task] | None = None) -> list[tuple[str, float]]:
        """Per-phase caps after the dwell filter: phases shorter than
        ``min_dwell_s`` (at default power) inherit the previous cap instead
        of paying a power-API write."""
        tasks = tasks if tasks is not None else list(self.tasks.values())
        out = []
        prev = self.schedule.default_cap
        for task in tasks:
            base = self._measure(task, self.spec.p_default)
            cap = (self.schedule.cap_for(task.name)
                   if base.runtime >= self.min_dwell_s else prev)
            out.append((task.name, cap))
            prev = cap
        return out

    def account_step(self, tasks: list[Task] | None = None) -> dict:
        """Modeled energy/runtime for one pass over ``tasks`` under the
        current schedule, vs uncapped, including transition overhead."""
        tasks = tasks if tasks is not None else list(self.tasks.values())
        e_capped = t_capped = e_open = t_open = 0.0
        caps = self.applied_caps(tasks)
        transitions = 0
        prev = None
        for task, (_, cap) in zip(tasks, caps):
            if prev is not None and not caps_equal(cap, prev):
                transitions += 1
            prev = cap
            m = self._measure(task, cap)
            b = self._measure(task, self.spec.p_default)
            e_capped += m.energy
            t_capped += m.runtime
            e_open += b.energy
            t_open += b.runtime
        e_capped += transitions * self.backend.transition_energy_j
        t_capped += transitions * self.backend.transition_seconds
        return {
            "energy_j": e_capped, "runtime_s": t_capped,
            "energy_uncapped_j": e_open, "runtime_uncapped_s": t_open,
            "transitions": transitions,
            "energy_saving_pct": (e_open - e_capped) / e_open * 100
            if e_open else 0.0,
            "runtime_increase_pct": (t_capped - t_open) / t_open * 100
            if t_open else 0.0,
        }
