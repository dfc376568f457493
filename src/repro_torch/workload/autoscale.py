"""Admission control and SLO-aware, power-gated autoscaling.

The control loop that turns the fleet's lossless-preemption machinery
into ELASTICITY: a ``WorkloadDriver`` feeds the arrival trace into the
open-loop serve jobs each control quantum, an ``AdmissionController``
sheds load the SLO classes say may be shed (bounded batch queues keep
the interactive path clear), and an ``Autoscaler`` moves capacity to
follow the diurnal curve —

  * per-node SLOT scaling: each job's ``slot_target`` tracks its live
    load; shrinks apply immediately through the proportional-preemption
    path (``preempt(max_slots=...)``), grows are delegated to the
    scheduler's regrow step so they only happen into real watt headroom;
  * node PARKING: a job idle past ``park_after_s`` hibernates (lossless
    drain, no restart-budget charge) and its node power-gates to the
    cluster's sleep state — the idle watts return to the facility pool
    for ``FleetPowerController`` to re-grant to whoever has queue
    pressure;
  * node WAKING: queue pressure past ``wake_threshold`` wakes sleeping
    nodes (paying ``wake_latency_s`` on the virtual clock) and expedites
    hibernated jobs so the scheduler resumes them onto the woken
    capacity.

Everything is deterministic arithmetic over the driver/cluster state —
no randomness, no wall clock — so autoscaled runs replay bit-identically
(the benchmark's two-run gate).

A copy of ``repro/workload/autoscale.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.workload.arrivals import ArrivalEvent
from repro_torch.workload.slo import DEFAULT_CLASSES, SLOClass, SLOTracker

__all__ = ["AdmissionController", "Autoscaler", "WorkloadDriver"]


class AdmissionController:
    """Sheds load by SLO class: a request is rejected when its class's
    outstanding count (queued + in service, i.e. offered - rejected -
    completed) already sits at ``max_outstanding``.  Classes with
    ``max_outstanding=None`` (interactive by default) always admit —
    the whole point of bounding the batch tiers is to keep the
    interactive path unclogged."""

    def __init__(self, classes: tuple[SLOClass, ...] = DEFAULT_CLASSES):
        self._by_name = {c.name: c for c in classes}

    def admit(self, ev: ArrivalEvent, tracker: SLOTracker) -> bool:
        cls = self._by_name.get(ev.slo)
        if cls is None or cls.max_outstanding is None:
            return True
        # ``offer`` has already counted this event, so the bound is
        # checked inclusively of it
        return tracker.outstanding(ev.slo) <= cls.max_outstanding


@dataclasses.dataclass
class Autoscaler:
    """Queue-depth-driven elasticity over the open-loop serve jobs.

    Scale-up is eager (a queued request raises ``slot_target`` at once;
    pressure past ``wake_threshold`` wakes a sleeping node per quantum)
    and scale-down is lazy (slots shrink only when load sits below
    ``shrink_frac`` of the active cap; a node parks only after
    ``park_after_s`` of zero load with an empty backlog) — the
    hysteresis that keeps the fleet from thrashing around the diurnal
    trough."""

    min_slots: int = 1          # slots a running job never shrinks below
    shrink_frac: float = 0.5    # shrink only when load < frac * active_cap
    park_after_s: float = 3.0   # zero-load seconds before a job parks
    park_rest_s: float = 2.0    # parked job ineligible to resume this long
    min_running: int = 1        # serve nodes that never park
    wake_threshold: int = 8     # queued requests that trigger a node wake
    max_wakes_per_quantum: int = 1
    # Optional[repro_torch.obs.SLOBurnMonitor] (read-only): while any class
    # burns error budget faster than its target allows (burn > 1.0),
    # scale-down is vetoed and waking is forced even below the queue
    # threshold — burn leads queue depth when latency (not backlog) is
    # what is dying.  None preserves the legacy queue-only behavior.
    slo_monitor: object | None = None

    def __post_init__(self):
        self._idle_since: dict[str, float] = {}

    def control(self, driver: "WorkloadDriver", cluster, sched,
                now: float) -> None:
        nodes = WorkloadDriver.serve_nodes(cluster)
        burning = (self.slo_monitor.burning(now)
                   if self.slo_monitor is not None else [])

        # -- per-job slot targets ------------------------------------------
        for n in nodes:
            job = n.job
            load = job.active_streams + job.queue_depth
            if load > 0:
                self._idle_since.pop(job.name, None)
            else:
                self._idle_since.setdefault(job.name, now)
            target = max(self.min_slots, min(job.capacity, load))
            # grows go through the scheduler's regrow step (it owns the
            # watt headroom); shrinks release margin immediately — unless
            # error budget is burning, when shedding capacity is the one
            # move guaranteed to make the burn worse
            job.slot_target = target
            if (not burning and target < job.active_cap
                    and load <= int(self.shrink_frac * job.active_cap)):
                job.preempt(max_slots=target)
                if hasattr(n, "refit"):
                    n.refit()

        # -- park idle jobs, power-gate their nodes ------------------------
        running = list(nodes)
        if not driver.backlog and not burning:
            for n in nodes:
                if len(running) <= self.min_running:
                    break
                job_name = n.job.name
                t0 = self._idle_since.get(job_name)
                if t0 is not None and now - t0 >= self.park_after_s:
                    sched.park(n, now, rest_s=self.park_rest_s)
                    cluster.sleep_node(n)
                    running.remove(n)
                    self._idle_since.pop(job_name, None)

        # -- wake sleeping nodes under queue pressure (or budget burn) -----
        pressure = len(driver.backlog) \
            + sum(n.job.queue_depth for n in running)
        if pressure >= self.wake_threshold or burning:
            sched.expedite(now)      # hibernated jobs become eligible NOW
            woken = 0
            for node in cluster.sleeping_nodes():
                if woken >= self.max_wakes_per_quantum:
                    break
                cluster.wake_node(node)
                woken += 1


class WorkloadDriver:
    """Feeds a pre-generated arrival trace into the fleet, one control
    quantum at a time (``SimulatedCluster.run(..., workload=driver)``
    calls ``on_quantum`` before each scheduling tick).

    Per quantum: pop every arrival due by ``now``, run admission, then
    dispatch the backlog across the RUNNING open-loop serve jobs
    least-loaded-first (deterministic ties by node name).  Requests
    that find no running job — or only full queues — wait in the
    driver's backlog, accruing queue latency against their deadline;
    the autoscaler reads that pressure to wake capacity."""

    def __init__(self, events, tracker: SLOTracker,
                 admission: AdmissionController | None = None,
                 autoscaler: Autoscaler | None = None,
                 queue_cap_per_job: int | None = None):
        self._trace: deque[ArrivalEvent] = deque(events)
        self.tracker = tracker
        self.admission = admission
        self.autoscaler = autoscaler
        self.queue_cap_per_job = queue_cap_per_job
        self.backlog: deque[ArrivalEvent] = deque()
        self.offered = 0
        self.dispatched = 0

    @property
    def exhausted(self) -> bool:
        """No arrivals left to deliver (in-service work may remain)."""
        return not self._trace and not self.backlog

    @staticmethod
    def serve_nodes(cluster) -> list:
        """Busy nodes running an open-loop serve job, name-ordered."""
        return sorted(
            (n for n in cluster.busy_nodes()
             if getattr(n.job, "open_loop", False)),
            key=lambda n: n.name)

    def queue_depth(self, cluster) -> int:
        """Requests admitted but not yet in service, fleet-wide."""
        return len(self.backlog) + sum(
            n.job.queue_depth for n in self.serve_nodes(cluster))

    def on_quantum(self, cluster, sched, now: float) -> None:
        # 1. deliver due arrivals through admission
        while self._trace and self._trace[0].t <= now:
            ev = self._trace.popleft()
            self.offered += 1
            self.tracker.offer(ev.slo, now=now)
            if (self.admission is not None
                    and not self.admission.admit(ev, self.tracker)):
                self.tracker.reject(ev.slo, now=now)
                continue
            self.backlog.append(ev)

        # 2. dispatch least-loaded-first onto running serve jobs
        nodes = self.serve_nodes(cluster)
        while self.backlog and nodes:
            node = min(nodes, key=lambda n: (n.job.active_streams
                                             + n.job.queue_depth, n.name))
            job = node.job
            if (self.queue_cap_per_job is not None
                    and job.queue_depth >= self.queue_cap_per_job):
                break      # every job at cap: pressure stays visible
            job.offer([self.backlog.popleft()], now=now)
            self.dispatched += 1

        # 3. elasticity
        if self.autoscaler is not None:
            self.autoscaler.control(self, cluster, sched, now)

        telemetry = getattr(cluster, "telemetry", None)
        if telemetry is not None:
            telemetry.record_queue_depth(self.queue_depth(cluster))
            monitor = getattr(self.tracker, "monitor", None)
            if monitor is not None:
                telemetry.record_burn(monitor.snapshot(now))
