"""Deterministic fault injection for ``SimulatedCluster`` runs.

The fleet layers in ``cluster.py`` / ``controller.py`` / ``scheduler.py``
assume a polite world: every preemption is cooperative, every cap write
lands, every ``NodeSample`` is truthful.  This module breaks those
assumptions on purpose — and deterministically, so two same-seed chaos
runs stay bit-identical and CI can gate on the counters.

Fault kinds (``FaultEvent.kind``):

  crash       the node dies mid-quantum: its job loses all un-checkpointed
              in-flight work, the node refuses assignment until repaired
  hang        sleep/wake-style stall: the node is unresponsive for
              ``duration_s`` (misses quanta but keeps its job) — the
              watchdog cannot distinguish this from a crash, which is
              exactly the ambiguity a deadline-based monitor must handle
  cap         cap applies fail for ``duration_s``: ``mode="stuck"`` fails
              every attempt, ``mode="flaky"`` every other attempt (so a
              bounded retry loop succeeds)
  telemetry   samples from the node are dropped (``mode="stale"``) or
              corrupted (``mode="corrupt"``) for ``duration_s`` — the
              controller must fall back to degraded-mode allocations
  straggler   thermal throttle: the node runs at ``severity``x time and
              energy per step for ``duration_s``

``FaultInjector.attach`` additionally wraps every node's ``CapBackend``
as ``RetryingBackend(FlakyBackend(inner))`` so the cap-fault path runs
through the same retry/fallback machinery a real hwmon deployment would
use (see ``repro_torch.power.backends``).

``chaos_schedule`` builds a reproducible ``FaultEvent`` list from a seed
— the benchmark (``benchmarks/chaos.py``) and tests share it.

A copy of ``repro/fleet/faults.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
import random
import zlib
from dataclasses import dataclass, field

from repro_torch.power.backends import CapBackend, RetryingBackend

FAULT_KINDS = ("crash", "hang", "cap", "telemetry", "straggler")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled perturbation, delivered at virtual time ``t``."""

    t: float
    kind: str                 # one of FAULT_KINDS
    node: str                 # FleetNode.name
    duration_s: float = 0.0   # window length (crash: repair override)
    mode: str = ""            # cap: "stuck"|"flaky"; telemetry: "stale"|"corrupt"
    severity: float = 1.0     # straggler: time/energy multiplier


def _node_seed(seed: int, node: str) -> int:
    # Python's hash() is salted per process; crc32 is stable.
    return (seed * 1000003 + zlib.crc32(node.encode())) & 0x7FFFFFFF


@dataclass
class FlakyBackend:
    """CapBackend decorator that fails applies inside injected windows.

    Sits UNDER ``RetryingBackend`` so "flaky" windows exercise the retry
    loop (succeed on the second attempt) while "stuck" windows exhaust
    it and fall back to the last-known-good cap.
    """

    inner: CapBackend
    injector: "FaultInjector"
    node: str

    def apply(self, cap) -> None:
        if self.injector.cap_faulty(self.node):
            raise OSError(f"injected cap-apply failure on {self.node}")
        self.inner.apply(cap)

    def measure(self, task, cap):
        return self.inner.measure(task, cap)

    @property
    def transition_seconds(self) -> float:
        return self.inner.transition_seconds

    @property
    def transition_energy_j(self) -> float:
        return self.inner.transition_energy_j

    def __getattr__(self, name: str):
        if name in ("inner", "injector", "node"):
            raise AttributeError(name)
        return getattr(self.inner, name)


@dataclass
class FaultInjector:
    """Seed-driven fault delivery against a ``SimulatedCluster``.

    Construct with a sorted-or-not list of ``FaultEvent``s (they are
    re-sorted), call ``attach(cluster)`` once, then the cluster calls
    ``on_quantum`` at the top of every quantum and routes telemetry
    through ``filter_sample`` / ``telemetry_health``.
    """

    events: list                 # list[FaultEvent]
    repair_s: float = 20.0       # default crash repair time
    cap_retries: int = 3         # RetryingBackend budget per apply
    seed: int = 0                # jitter seed for the retry backoff
    delivered: list = field(default_factory=list)
    now: float = 0.0

    def __post_init__(self) -> None:
        self.events = sorted(self.events, key=lambda e: (e.t, e.kind, e.node))
        self._i = 0
        self._cap: dict = {}      # node -> list[(until, mode)]
        self._tel: dict = {}      # node -> list[(until, mode)]
        self._strag: dict = {}    # node -> list[(until, severity)]
        self._flaky_n: dict = {}  # node -> attempt counter for "flaky" windows

    # -- wiring -----------------------------------------------------------

    def attach(self, cluster) -> None:
        """Wrap every node's backend: injector faults under bounded retries."""
        tracer = getattr(cluster, "tracer", None)
        for node in cluster.nodes:
            flaky = FlakyBackend(inner=node.backend, injector=self,
                                 node=node.name)
            node.backend = RetryingBackend(
                inner=flaky, max_retries=self.cap_retries,
                seed=_node_seed(self.seed, node.name),
                tracer=tracer, trace_track=node.name,
                now_fn=lambda inj=self: inj.now)
            if node.pm is not None:   # mid-run attach: live session too
                node.pm.backend = node.backend

    # -- per-quantum delivery --------------------------------------------

    def on_quantum(self, cluster, now: float) -> list:
        """Deliver all events with ``t <= now``; update node fault state.

        Returns the events delivered this quantum (for logging).
        """
        self.now = now
        fired = []
        by_name = {n.name: n for n in cluster.nodes}
        while self._i < len(self.events) and self.events[self._i].t <= now:
            ev = self.events[self._i]
            self._i += 1
            node = by_name.get(ev.node)
            if node is None:
                continue
            if ev.kind == "crash":
                cluster.crash_node(node, now,
                                   repair_s=ev.duration_s or self.repair_s)
            elif ev.kind == "hang":
                node.stall_until = max(node.stall_until, ev.t + ev.duration_s)
            elif ev.kind == "cap":
                self._cap.setdefault(ev.node, []).append(
                    (ev.t + ev.duration_s, ev.mode or "stuck"))
            elif ev.kind == "telemetry":
                self._tel.setdefault(ev.node, []).append(
                    (ev.t + ev.duration_s, ev.mode or "stale"))
            elif ev.kind == "straggler":
                self._strag.setdefault(ev.node, []).append(
                    (ev.t + ev.duration_s, max(1.0, ev.severity)))
            fired.append(ev)
            self.delivered.append(ev)
        # Straggler windows set/clear the node's slowdown factor.
        for name, windows in self._strag.items():
            node = by_name.get(name)
            if node is None:
                continue
            active = [sev for until, sev in windows if until > now]
            node.slow_factor = max(active) if active else 1.0
        # Crashed nodes repair once idle past their repair time.  A node
        # still holding a job does NOT self-heal — the watchdog (or
        # nobody, in the no-recovery arm) must fence it first.
        for node in cluster.nodes:
            if node.crashed and not node.busy and now >= node.repair_at:
                node.crashed = False
        return fired

    # -- fault queries ----------------------------------------------------

    def cap_faulty(self, node: str) -> bool:
        """True when an injected cap window should fail THIS apply attempt."""
        active = [m for until, m in self._cap.get(node, []) if until > self.now]
        if not active:
            return False
        if "stuck" in active:
            return True
        # flaky: fail every other attempt so a single retry succeeds
        n = self._flaky_n.get(node, 0)
        self._flaky_n[node] = n + 1
        return n % 2 == 0

    def telemetry_health(self, now: float, nodes) -> dict:
        """Map of node name -> "stale"|"corrupt" for active windows."""
        out = {}
        for node in nodes:
            name = node if isinstance(node, str) else node.name
            active = [m for until, m in self._tel.get(name, []) if until > now]
            if not active:
                continue
            out[name] = "corrupt" if "corrupt" in active else "stale"
        return out

    def filter_sample(self, sample, now: float):
        """Apply telemetry faults to one NodeSample.

        stale   -> None (dropout: the sample never arrives)
        corrupt -> impossible negative counters, so the telemetry layer's
                   validation rejects it instead of poisoning the totals
        """
        health = self.telemetry_health(now, [sample.node])
        mode = health.get(sample.node)
        if mode is None:
            return sample
        if mode == "stale":
            return None
        return dataclasses.replace(
            sample,
            energy_j=-(abs(sample.energy_j) + 1.0),
            tokens=-(abs(sample.tokens) + 1))


def chaos_schedule(seed: int, nodes, until_s: float, *,
                   crashes: int = 2, hangs: int = 1, cap_faults: int = 2,
                   telemetry_faults: int = 2, stragglers: int = 1,
                   repair_s: float = 15.0, hang_s: float = 6.0,
                   window_s: float = 10.0,
                   slow_factor: float = 2.0) -> list:
    """Build a reproducible fault schedule over ``nodes`` and ``until_s``.

    Event times land in [0.05, 0.8] x until_s so every fault has room to
    bite AND recover before the run ends.  Crash targets are sampled
    without replacement (two crashes on one node would just extend the
    outage); all other kinds sample independently.
    """
    rng = random.Random(seed)
    nodes = list(nodes)
    events = []

    def t_in(lo: float = 0.05, hi: float = 0.8) -> float:
        return round(rng.uniform(lo * until_s, hi * until_s), 3)

    for node in rng.sample(nodes, min(crashes, len(nodes))):
        events.append(FaultEvent(t=t_in(), kind="crash", node=node,
                                 duration_s=repair_s))
    for _ in range(hangs):
        events.append(FaultEvent(t=t_in(), kind="hang",
                                 node=rng.choice(nodes), duration_s=hang_s))
    for i in range(cap_faults):
        events.append(FaultEvent(t=t_in(), kind="cap", node=rng.choice(nodes),
                                 duration_s=window_s,
                                 mode="flaky" if i % 2 else "stuck"))
    for i in range(telemetry_faults):
        events.append(FaultEvent(t=t_in(), kind="telemetry",
                                 node=rng.choice(nodes), duration_s=window_s,
                                 mode="corrupt" if i % 2 else "stale"))
    for _ in range(stragglers):
        events.append(FaultEvent(t=t_in(), kind="straggler",
                                 node=rng.choice(nodes), duration_s=window_s,
                                 severity=slow_factor))
    return sorted(events, key=lambda e: (e.t, e.kind, e.node))
