"""A simulated multi-node cluster under one facility power budget.

Each ``FleetNode`` owns a REAL ``repro_torch.power`` session — a
``SimulatedBackend`` (the analytic DVFS/steering model standing in for
hardware telemetry) and a ``PowerManager`` swept over its assigned job's
phase tasks — so per-phase cap selection, write coalescing, EWMA
``observe()`` refinement and transition pricing are the production code
paths, not a parallel implementation.  The fleet grant arrives through
``PowerManager.set_grant``: the node's schedule still *requests* its
per-phase caps, the grant ceilings what gets applied.

Time is virtual: a shared ``VirtualClock`` advances in control quanta;
within a quantum every busy node executes whole job steps whose duration
is the MODELED phase runtime (plus cap-transition overhead).  No wall
clock and no randomness enters the simulation, so two runs over the same
job queue and budget trace produce bit-identical fleet counters — the
seed-stability contract ``tests/test_fleet.py`` asserts.

An idle node is power-gated (grant 0, no draw): preempting a job under a
shrinking facility envelope genuinely returns its floor watts.

A copy of ``repro/fleet/cluster.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.fleet.controller import FleetPowerController
from repro_torch.fleet.pareto import CurveBank
from repro_torch.fleet.scheduler import FleetScheduler, Job
from repro_torch.fleet.telemetry import FleetTelemetry, NodeSample
from repro_torch.hw.tpu import DEFAULT_SUPERCHIP, SuperchipSpec
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.power.backends import SimulatedBackend
from repro_torch.power.manager import PowerManager

#: Watts above the physical floor a node must be grantable before the
#: scheduler will place work on it (a floor-pinned node does no useful
#: work, it just idles hot).
USEFUL_MARGIN_W = 30.0


@dataclasses.dataclass
class VirtualClock:
    """The cluster's shared notion of time (seconds, virtual)."""

    now: float = 0.0

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.now += dt
        return self.now


@dataclasses.dataclass(frozen=True)
class BudgetTrace:
    """Facility budget over virtual time: step function through sorted
    ``(t_start, watts)`` breakpoints (the shrinking-cap scenarios)."""

    points: tuple

    @classmethod
    def of(cls, spec) -> "BudgetTrace":
        """Coerce a constant, a list of breakpoints, or a trace."""
        if isinstance(spec, BudgetTrace):
            return spec
        if isinstance(spec, (int, float)):
            return cls(points=((0.0, float(spec)),))
        pts = tuple(sorted((float(t), float(w)) for t, w in spec))
        if not pts:
            raise ValueError("empty budget trace")
        return cls(points=pts)

    def at(self, t: float) -> float:
        w = self.points[0][1]
        for t0, w0 in self.points:
            if t0 > t:
                break
            w = w0
        return w


class FleetNode:
    """One superchip node: a power session plus (at most) one job."""

    def __init__(self, name: str, cabinet: str,
                 spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                 metric: str = "sed"):
        self.name = name
        self.cabinet = cabinet
        self.spec = spec
        self.metric = metric
        self.backend = SimulatedBackend(spec)
        self.tracer = NULL_TRACER      # cluster wires a live Tracer in
        self.pm: PowerManager | None = None
        self.job: Job | None = None
        self.grant_w = 0.0
        self.local_t = 0.0
        self.assigned_at = 0.0
        self._tasks: dict[str, object] = {}
        # -- power-gating state (workload autoscaling) ---------------------
        self.asleep = False      # deep power-gate: draws nothing, not
                                 # assignable until woken
        self.wake_at = 0.0       # virtual time the last wake completes
        # -- fault state (repro_torch.fleet.faults drives these) --------------
        self.crashed = False     # killed by fault injection; silent until
                                 # repaired (its job does NOT come back)
        self.repair_at = 0.0     # virtual time the node may be repaired
        self.stall_until = 0.0   # sleep/wake hang: alive but doing nothing
        self.slow_factor = 1.0   # straggler: steps take this times longer
        self.last_beat = 0.0     # heartbeat the fleet watchdog reads

    # -- capacity constants -------------------------------------------------
    @property
    def floor_w(self) -> float:
        return self.spec.p_floor

    @property
    def ceil_w(self) -> float:
        return self.spec.p_max

    @property
    def busy(self) -> bool:
        return self.job is not None

    # -- sleep / wake (workload autoscaling power-gates idle nodes) ---------
    def sleep(self) -> None:
        """Deep power-gate: the node draws NOTHING (not even idle
        watts) and is unassignable until ``wake`` completes.  Only an
        idle node may sleep — parking a job first is the scheduler's
        business."""
        if self.busy:
            raise RuntimeError(f"{self.name} is busy, cannot sleep")
        self.asleep = True

    def wake(self, now: float, latency_s: float) -> None:
        """Begin powering the node back up; it becomes assignable (and
        starts drawing idle watts) once ``latency_s`` virtual seconds
        elapse — the cold-start cost eager autoscaling pays."""
        self.asleep = False
        self.wake_at = max(self.wake_at, now + latency_s)

    def assignable(self, now: float) -> bool:
        """Free, awake, fully powered and healthy — the only nodes the
        scheduler may place work on."""
        return (not self.busy and not self.asleep and self.wake_at <= now
                and not self.crashed and self.stall_until <= now)

    # -- job lifecycle ------------------------------------------------------
    def assign(self, job: Job, t: float) -> None:
        if self.job is not None:
            raise RuntimeError(f"{self.name} already runs {self.job.name}")
        if self.asleep:
            raise RuntimeError(f"{self.name} is asleep, wake it first")
        self.job = job
        tasks = job.phase_tasks()
        self._tasks = {task.name: task for task in tasks}
        # a real session per assignment: the backend sweeps the job's
        # tasks and the metric decides the per-phase cap requests
        self.pm = PowerManager(tasks=tasks, metric=self.metric,
                               backend=self.backend, spec=self.spec)
        self.local_t = t
        self.assigned_at = t
        self.last_beat = t

    def release(self) -> Job:
        if self.job is None:
            raise RuntimeError(f"{self.name} is idle")
        job, self.job = self.job, None
        self.pm = None
        self._tasks = {}
        self.grant_w = 0.0
        return job

    def refit(self) -> None:
        """Rebuild the power session after the job's phase tasks changed
        (a proportional preemption shed or regrew slots): the backend
        re-sweeps the new task profile and the schedule re-decides its
        per-phase caps under the standing grant.  The EWMA-refined table
        restarts — the modeled cost of changing the machine under a live
        session."""
        if self.job is None:
            return
        tasks = self.job.phase_tasks()
        self._tasks = {task.name: task for task in tasks}
        self.pm = PowerManager(tasks=tasks, metric=self.metric,
                               backend=self.backend, spec=self.spec)
        self.pm.set_grant(self.grant_w)

    def set_grant(self, watts: float) -> None:
        self.grant_w = watts
        if self.pm is not None:
            self.pm.set_grant(watts)

    # -- what the controller asks ------------------------------------------
    def request_w(self) -> float:
        """The node's useful ceiling: the largest per-phase cap its
        schedule wants — watts above this buy nothing."""
        if self.pm is None or self.job is None:
            return self.floor_w
        caps = [self.pm.cap_for(name)
                for name, _ in self.job.step_phases()]
        return max(max(caps), self.floor_w) if caps else self.floor_w

    def step_cost(self, grant_w: float) -> tuple[float, float]:
        """Modeled (seconds, joules) of ONE job step under ``grant_w``
        (schedule caps clamped to the grant; no session side effects)."""
        if self.pm is None or self.job is None:
            return 0.0, 0.0
        t = e = 0.0
        for name, weight in self.job.step_phases():
            cap = min(self.pm.cap_for(name), grant_w)
            m = self.backend.measure(self._tasks[name], cap)
            t += m.runtime * weight
            e += m.energy * weight
        return t, e

    def throughput_at(self, grant_w: float) -> float:
        """Modeled tokens/s of this node's job under ``grant_w``."""
        if self.job is None:
            return 0.0
        s, _ = self.step_cost(grant_w)
        return self.job.tokens_per_step() / s if s > 0 else 0.0

    @property
    def job_value(self) -> float:
        """Worth of one of this node's tokens in the fleet objective
        (``value`` is a formal Job-protocol field)."""
        return float(self.job.value) if self.job is not None else 0.0

    def weighted_throughput_at(self, grant_w: float) -> float:
        """Value-weighted modeled tokens/s — the unit the controller's
        transfer objective maximizes, so a watt buys weighted tokens and
        a high-value serve token outranks a background train token."""
        return self.job_value * self.throughput_at(grant_w)

    def sensitivity(self, delta_w: float = 8.0) -> float:
        """Marginal weighted-perf-per-watt at the current grant: the
        finite difference of the value-weighted modeled throughput
        curve.  This is what the node 'reports' to the fleet
        controller."""
        if self.job is None:
            return 0.0
        hi = min(self.grant_w + delta_w, self.ceil_w)
        lo = max(self.grant_w - delta_w, self.floor_w)
        if hi <= lo:
            return 0.0
        return max(0.0, (self.weighted_throughput_at(hi)
                         - self.weighted_throughput_at(lo)) / (hi - lo))

    # -- execution ----------------------------------------------------------
    def run_quantum(self, until: float) -> NodeSample | None:
        """Execute whole job steps until the node's local clock reaches
        ``until``; returns the quantum's telemetry sample (None if the
        node did nothing).  Runs through the real session: ``next_cap``
        (grant-clamped), coalesced ``apply_cap`` writes with the
        backend's transition price, and ``observe()`` feedback.

        Fault semantics: a CRASHED node is silent — no steps, and no
        heartbeat, so the watchdog's deadline eventually fires.  A
        STALLED node (sleep/wake hang) burns the stall window without
        beating either: from outside, a hang and a crash look identical
        until the stall clears.  A node whose local clock is already
        past ``until`` (occupied by a snapshot transfer) DOES beat —
        receiving a migration is liveness, not death."""
        if self.job is None or self.pm is None:
            return None
        if self.crashed:
            return None                    # silent: no work, no heartbeat
        if self.stall_until > self.local_t:
            self.local_t = min(until, self.stall_until)
            if self.local_t >= until:
                return None                # hung all quantum: no heartbeat
        if self.local_t >= until:
            self.last_beat = until         # transfer-occupied, but alive
            return None
        t0 = self.local_t
        tokens = steps = violations = 0
        energy = 0.0
        tr = self.tracer if self.tracer.enabled else None
        while not self.job.done and self.local_t < until:
            step_s = step_j = 0.0
            for name, weight in self.job.step_phases():
                fails0 = getattr(self.pm, "apply_failures", 0)
                cap = self.pm.next_cap(name)
                if self.pm.apply_cap(cap):   # a real write: pay for it
                    if tr is not None:
                        tr.instant(
                            "cap_write", self.local_t + step_s, self.name,
                            cat="power", args={
                                "cap_w": cap,
                                "energy_j": self.backend.transition_energy_j,
                                "seconds": self.backend.transition_seconds})
                    step_s += self.backend.transition_seconds
                    step_j += self.backend.transition_energy_j
                eff = cap
                if getattr(self.pm, "apply_failures", 0) > fails0:
                    # the write never landed: the chip still runs at the
                    # backend's last-known-good cap, not the one we asked
                    known = getattr(self.backend, "current_cap", None)
                    if known is not None:
                        eff = known
                m = self.backend.measure(self._tasks[name], eff)
                self.pm.observe(name, m.runtime, m.energy, cap=eff,
                                clock_fraction=m.clock_fraction)
                phase_s = m.runtime * weight * self.slow_factor
                phase_j = m.energy * weight * self.slow_factor
                if tr is not None:
                    t_phase = self.local_t + step_s
                    tr.span(name, t_phase, t_phase + phase_s, self.name,
                            cat="phase", args={
                                "energy_j": phase_j, "cap_w": eff,
                                "job": self.job.name})
                step_s += phase_s
                step_j += phase_j
                # physical over-budget: an unattainable cap pins the chip
                # at f_min and the draw exceeds what was granted (a stuck
                # cap above the grant lands here too)
                if m.avg_power > self.grant_w + 1.0:
                    violations += 1
            if tr is not None:
                tr.span("job.step", self.local_t, self.local_t + step_s,
                        self.name, cat="step", args={"job": self.job.name})
            tokens += self.job.advance(step_s, now=self.local_t + step_s)
            steps += 1
            energy += step_j
            self.local_t += step_s
        self.last_beat = self.local_t
        if steps == 0:
            return None
        if tr is not None:
            tr.span("node.grant", t0, self.local_t, self.name, cat="grant",
                    args={"grant_w": self.grant_w, "job": self.job.name,
                          "steps": steps, "tokens": tokens})
        return NodeSample(
            t=t0, node=self.name, cabinet=self.cabinet,
            job=self.job.name, kind=self.job.kind, grant_w=self.grant_w,
            tokens=tokens, energy_j=energy, busy_s=self.local_t - t0,
            steps=steps, violations=violations)


class SimulatedCluster:
    """N nodes, one facility budget, one virtual clock.

    ``run(jobs, budget, until_s)`` drives the whole control loop each
    quantum: release finished jobs, reconcile placement against the
    current envelope (``FleetScheduler.tick`` — admissions, preemptions,
    resumes — with cross-node snapshot migrations charged at
    ``snapshot_bytes / interconnect_bw`` on the receiving node's clock),
    re-decide grants (``FleetPowerController.redistribute``, conservation
    asserted per allocation), then let every busy node execute its steps
    on the shared clock.

    ``cabinet_ceil_w`` (scalar, or ``{cabinet: watts}``) gives cabinets
    real busbar/cooling ceilings enforced as a middle ``weighted_split``
    level in the controller — not just roll-up accounting.

    ``idle_w`` charges every AWAKE idle node that many watts per second
    (hosts idle hot even with the accelerator power-gated) — drawn out
    of the facility budget before the controller splits the remainder,
    and accrued into ``telemetry.idle_energy_j``.  The default 0.0
    preserves the legacy free-idle accounting every earlier benchmark
    was gated on.  A SLEEPING node (``sleep_node``, driven by the
    workload autoscaler) draws nothing but pays ``wake_latency_s`` of
    virtual unassignability to come back — the trade the autoscaler
    arbitrates.
    """

    def __init__(self, n_nodes: int, cabinet_size: int = 4,
                 spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                 metric: str = "sed", policy: str = "sensitivity",
                 quantum_s: float = 1.0,
                 useful_margin_w: float = USEFUL_MARGIN_W,
                 cabinet_ceil_w=None, interconnect_bw: float | None = None,
                 cross_cabinet_bw: float | None = None,
                 idle_w: float = 0.0, wake_latency_s: float = 2.0,
                 faults=None, watchdog_deadline_s: float | None = None,
                 shadow_ckpt_s: float | None = None, tracer=None,
                 explore_budget: float = 0.1):
        if n_nodes < 1:
            raise ValueError("need at least one node")
        self.spec = spec
        self.quantum_s = quantum_s
        self.useful_margin_w = useful_margin_w
        self.cabinet_ceil_w = cabinet_ceil_w
        self.idle_w = idle_w
        self.wake_latency_s = wake_latency_s
        # -- chaos / recovery knobs ----------------------------------------
        self.faults = faults                 # FaultInjector (None = calm)
        self.watchdog_deadline_s = watchdog_deadline_s
        self.shadow_ckpt_s = shadow_ckpt_s   # periodic slot-checkpoint cadence
        # snapshot-migration bandwidth: the chip's ICI link rate for
        # same-cabinet links unless the deployment says otherwise;
        # cross-cabinet hops leave the ICI domain (DCN-class) and default
        # to a quarter of it — the per-link cost model placement
        # affinity minimizes over
        self.interconnect_bw = (interconnect_bw if interconnect_bw
                                else spec.chip.ici_bandwidth)
        self.cross_cabinet_bw = (cross_cabinet_bw if cross_cabinet_bw
                                 else self.interconnect_bw / 4.0)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.nodes = [
            FleetNode(name=f"cab{i // cabinet_size}/n{i:02d}",
                      cabinet=f"cab{i // cabinet_size}", spec=spec,
                      metric=metric)
            for i in range(n_nodes)]
        for node in self.nodes:
            node.tracer = self.tracer
        self._cabinet_of = {n.name: n.cabinet for n in self.nodes}
        self.clock = VirtualClock()
        # pareto mode learns per-node power curves online and steers each
        # node to its fitted ED sweet spot; every other policy keeps the
        # curve bank off so the legacy paths stay bit-identical
        self.curves = CurveBank() if policy == "pareto" else None
        self.explore_budget = explore_budget
        self.controller = FleetPowerController(
            policy=policy, curves=self.curves,
            explore_budget=explore_budget if self.curves is not None
            else 0.0)
        self.controller.tracer = self.tracer
        self.telemetry = FleetTelemetry()
        self.scheduler: FleetScheduler | None = None
        self.allocations: list = []
        if self.faults is not None:
            self.faults.attach(self)

    # -- node views (deterministic order) -----------------------------------
    def free_nodes(self) -> list[FleetNode]:
        """Nodes the scheduler may place work on: idle, awake, and past
        any in-flight wake latency."""
        return [n for n in self.nodes if n.assignable(self.clock.now)]

    def busy_nodes(self) -> list[FleetNode]:
        return [n for n in self.nodes if n.busy]

    def idle_nodes(self) -> list[FleetNode]:
        """Idle but AWAKE nodes (including ones mid-wake): the set that
        draws ``idle_w`` each.  A crashed node draws nothing — it is
        off, not idling hot."""
        return [n for n in self.nodes
                if not n.busy and not n.asleep and not n.crashed]

    def sleeping_nodes(self) -> list[FleetNode]:
        return [n for n in self.nodes if n.asleep]

    def idle_draw_w(self) -> float:
        """Facility watts the awake-idle set burns doing nothing — what
        power-gating (``sleep_node``) returns to the budget pool."""
        return self.idle_w * len(self.idle_nodes())

    # -- power gating (the workload autoscaler drives these) ----------------
    def sleep_node(self, node: FleetNode) -> None:
        node.sleep()
        self.telemetry.record_sleep()

    def wake_node(self, node: FleetNode) -> None:
        if not node.asleep:
            return
        node.wake(self.clock.now, self.wake_latency_s)
        self.telemetry.record_wake()

    # -- fault injection (repro_torch.fleet.faults drives this) ---------------
    def crash_node(self, node: FleetNode, now: float,
                   repair_s: float) -> None:
        """Kill a node mid-quantum: it goes silent (no steps, no
        heartbeat) and refuses assignment until repaired.  Its job is
        NOT released here — from the fleet's view the node simply
        stopped answering; fencing it is the watchdog's job."""
        node.crashed = True
        node.repair_at = now + repair_s
        self.telemetry.record_crash()

    # -- migration cost model ------------------------------------------------
    def link_bw(self, src: str, dst: str) -> float:
        """Bandwidth of the interconnect link between two nodes: ICI rate
        within a cabinet, the (slower) cross-cabinet rate between
        cabinets, unbounded to oneself."""
        if src == dst:
            return float("inf")
        same_cab = self._cabinet_of.get(src) == self._cabinet_of.get(dst)
        return self.interconnect_bw if same_cab else self.cross_cabinet_bw

    def transfer_seconds(self, src: str, dst: str, nbytes: float) -> float:
        """Virtual seconds a snapshot transfer from ``src`` to ``dst``
        occupies the receiving node — the per-link cost placement
        affinity minimizes (0 on the origin node itself)."""
        if nbytes <= 0 or src == dst:
            return 0.0
        return float(nbytes) / self.link_bw(src, dst)

    def migration_seconds(self, nbytes: float) -> float:
        """Legacy link-agnostic transfer price: payload bytes over the
        intra-cabinet ICI rate.  Link-aware callers (the scheduler's
        placement affinity) use ``transfer_seconds`` instead."""
        return float(nbytes) / self.interconnect_bw if nbytes > 0 else 0.0

    def cabinet_ceils(self, nodes) -> dict[str, float] | None:
        """Busbar/cooling ceilings for the cabinets hosting ``nodes``
        (None = cabinets are roll-up accounting only)."""
        if self.cabinet_ceil_w is None:
            return None
        cabs = sorted({n.cabinet for n in nodes})
        if isinstance(self.cabinet_ceil_w, dict):
            return {c: float(self.cabinet_ceil_w[c]) for c in cabs
                    if c in self.cabinet_ceil_w}
        return {c: float(self.cabinet_ceil_w) for c in cabs}

    # -- the control loop ---------------------------------------------------
    def run(self, jobs: Iterable[Job], budget, until_s: float,
            workload=None) -> dict:
        """``workload`` optionally carries a
        ``repro_torch.workload.WorkloadDriver``: called once per quantum
        (before the scheduling tick) to deliver due arrivals, dispatch
        them across the open-loop serve jobs and run the autoscaler —
        which may park jobs / sleep nodes through this cluster's
        power-gating surface."""
        trace = BudgetTrace.of(budget)
        sched = FleetScheduler(
            list(jobs),
            min_node_w=self.nodes[0].floor_w + self.useful_margin_w,
            margin_w=self.useful_margin_w,
            watchdog_deadline_s=self.watchdog_deadline_s,
            slot_w_fn=(self.curves.slot_watt
                       if self.curves is not None else None))
        self.scheduler = sched
        tr = self.tracer if self.tracer.enabled else None
        while self.clock.now < until_s:
            now = self.clock.now
            budget_w = trace.at(now)
            if tr is not None:
                tr.span("fleet.quantum", now, now + self.quantum_s,
                        "fleet", cat="quantum", args={"budget_w": budget_w})

            # 0. fault injection delivers due events / repairs idle nodes
            if self.faults is not None:
                fired = self.faults.on_quantum(self, now)
                if tr is not None and fired:
                    for ev in fired:
                        tr.instant(
                            f"fault.{ev.kind}", now, ev.node, cat="fault",
                            args={"mode": ev.mode,
                                  "duration_s": ev.duration_s})

            # 1. harvest finished jobs -> free their nodes (and watts);
            #    a crashed node is unreachable — nothing to harvest from
            #    it until the watchdog fences it
            for node in self.busy_nodes():
                if not node.crashed and node.job.done:
                    self.telemetry.record_completion()
                    sched.complete(node.release())

            # 1b. the workload delivers arrivals / autoscales
            if workload is not None:
                workload.on_quantum(self, sched, now)

            # 2. reconcile placement against the current envelope; the
            #    awake-idle set's hotel load comes off the top first —
            #    power-gating idle nodes is what returns these watts
            events = sched.tick(now, self,
                                max(budget_w - self.idle_draw_w(), 0.0))
            for name in events["preempted"]:
                self.telemetry.record_preemption()
                if tr is not None:
                    tr.instant("preempt", now, "fleet", cat="sched",
                               args={"job": name})
            if events["dropped_tokens"]:
                self.telemetry.record_drop(events["dropped_tokens"])
            if events["kept_tokens"]:
                self.telemetry.record_kept(events["kept_tokens"])
            for m in events["migrations"]:
                self.telemetry.record_migration(m["bytes"], m["seconds"])
                if tr is not None:
                    tr.instant("migration", now, m["to"], cat="sched",
                               args={"from": m["from"], "bytes": m["bytes"],
                                     "seconds": m["seconds"],
                                     "job": m.get("job", "")})
            for p in events.get("partials", ()):
                self.telemetry.record_partial(p["slots"], p["tokens"])
                if tr is not None:
                    tr.instant("partial_drain", now, "fleet", cat="sched",
                               args={"job": p.get("job", ""),
                                     "slots": p["slots"],
                                     "tokens": p["tokens"]})
            for u in events.get("unparked", ()):
                self.telemetry.record_unpark(u["slots"])
                if tr is not None:
                    tr.instant("unpark", now, "fleet", cat="sched",
                               args={"job": u.get("job", ""),
                                     "slots": u["slots"]})
            for a in events.get("adoptions", ()):
                self.telemetry.record_adoption(a["slots"], a["tokens"],
                                               a["bytes"], a["seconds"])
                if tr is not None:
                    tr.instant("adoption", now, "fleet", cat="sched",
                               args={"slots": a["slots"],
                                     "tokens": a["tokens"],
                                     "bytes": a["bytes"]})
            for rec in events.get("dead", ()):
                self.telemetry.record_dead(rec["replayed"], rec["lost"])
                if tr is not None:
                    tr.instant("dead_declared", now, "fleet", cat="sched",
                               args={"node": rec.get("node", ""),
                                     "replayed": rec["replayed"],
                                     "lost": rec["lost"]})

            busy = self.busy_nodes()
            if (not busy and not sched.has_work
                    and (workload is None or workload.exhausted)):
                break

            # 3. re-decide grants (hierarchical, conservation asserted).
            #    Crashed nodes draw nothing and get nothing; telemetry
            #    faults put their nodes into degraded mode (stale -> hold
            #    last-known-good, corrupt -> conservative floor).  Grants
            #    are applied with ``.get`` because the node set can
            #    shrink between decide and apply (crash mid-quantum).
            alive = [n for n in busy if not n.crashed]
            if alive:
                health = None
                if self.faults is not None:
                    health = self.faults.telemetry_health(
                        now, [n.name for n in alive])
                    if health:
                        self.telemetry.record_degraded(len(health))
                alloc = self.controller.redistribute(
                    max(budget_w - self.idle_draw_w(), 0.0), alive, t=now,
                    cabinet_ceils=self.cabinet_ceils(alive), health=health)
                self.allocations.append(alloc)
                self.telemetry.record_grants(alloc.node_w)
                for node in alive:
                    node.set_grant(alloc.node_w.get(node.name,
                                                    node.grant_w))
            for node in self.free_nodes():
                node.set_grant(0.0)    # power-gated

            # 4. everyone executes on the shared clock; the awake-idle
            #    set accrues its hotel load for the quantum.  Samples
            #    route through the injector's telemetry filter: a stale
            #    window drops them, a corrupt window mangles them (the
            #    bus rejects and counts the mangled ones).
            for node in busy:
                sample = node.run_quantum(now + self.quantum_s)
                if sample is not None and self.faults is not None:
                    filtered = self.faults.filter_sample(sample, now)
                    if filtered is None:
                        self.telemetry.record_sample_dropped()
                        if tr is not None:
                            # the energy WAS burned; the ledger needs the
                            # original joules to balance the books
                            tr.instant("sample_lost", now, sample.node,
                                       cat="telemetry",
                                       args={"energy_j": sample.energy_j,
                                             "mode": "stale"})
                        continue
                    if filtered is not sample and tr is not None:
                        tr.instant("sample_lost", now, sample.node,
                                   cat="telemetry",
                                   args={"energy_j": sample.energy_j,
                                         "mode": "corrupt"})
                    sample = filtered
                if sample is not None:
                    self.telemetry.record(sample)
                    if self.curves is not None:
                        # feed the curve bank with what the bus accepted
                        # — the same filtered view the scoreboard sees,
                        # so a corrupt window poisons the fit exactly as
                        # far as it poisons the ledger (the exploration
                        # budget is what walks it back)
                        self.curves.observe(
                            sample,
                            slots=getattr(node.job, "active_cap", None)
                            if node.job is not None else None)
            if self.curves is not None:
                self.telemetry.record_curve_state(
                    self.curves.observations, self.curves.ready_count(),
                    self.curves.mean_confidence(),
                    self.controller.explore_probes)

            # 4b. periodic shadow checkpoints: each serve job's warm
            #     slots are captured and replicated off-node, so a crash
            #     loses at most one interval of decode.  The replication
            #     occupies the node's clock like any other transfer.
            if self.shadow_ckpt_s is not None:
                t_end = now + self.quantum_s
                for node in busy:
                    if node.crashed:
                        continue
                    job = node.job
                    ckpt = getattr(job, "shadow_checkpoint", None)
                    if ckpt is None:
                        continue
                    last = getattr(job, "shadow_t", None)
                    if last is not None and t_end - last < self.shadow_ckpt_s:
                        continue
                    nbytes = ckpt(t_end)
                    if nbytes > 0:
                        node.local_t += nbytes / self.interconnect_bw
                        self.telemetry.record_checkpoint(int(nbytes))
                        if tr is not None:
                            tr.instant("checkpoint", t_end, node.name,
                                       cat="ckpt", args={"bytes": int(nbytes)})
            if self.idle_w > 0:
                n_idle = len(self.idle_nodes())
                if n_idle:
                    self.telemetry.record_idle(
                        self.idle_w * n_idle * self.quantum_s)
            if tr is not None:
                tr.counter("fleet", now + self.quantum_s, {
                    "energy_j": self.telemetry.energy_j,
                    "tokens": self.telemetry.tokens,
                    "busy_nodes": len(busy),
                    "budget_w": budget_w,
                    "violations": self.telemetry.violations,
                    "preemptions": self.telemetry.preemptions,
                })
            self.clock.advance(self.quantum_s)
        # harvest jobs that finished during the final quantum — the loop
        # exit must not leave their completion unrecorded / node busy
        for node in self.busy_nodes():
            if not node.crashed and node.job.done:
                self.telemetry.record_completion()
                sched.complete(node.release())
        # harvest the retry backends' aggregate counters (the injector
        # wrapped every node in a RetryingBackend at attach time)
        if self.faults is not None:
            self.telemetry.record_cap_retries(
                sum(getattr(n.backend, "retries", 0) for n in self.nodes),
                sum(getattr(n.backend, "failed_applies", 0)
                    for n in self.nodes))
        return self.telemetry.counters(elapsed_s=self.clock.now)
