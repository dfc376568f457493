"""Per-request SLO classes and fleet-level attainment accounting.

An ``SLOClass`` prices a request's latency: the deadline is a flat
floor plus a per-output-token allowance (an interactive chat turn must
land in seconds; a batch summarization may take minutes), and the
class's ``value`` is the worth of one of its tokens in the fleet
objective — the same unit ``ServeJob.value`` feeds the preemption
order and the controller's weighted-throughput transfers, so "Eco-Mode"
style user tiers map straight onto watts.

``SLOTracker`` folds per-completion latencies into per-class
attainment and goodput.  All state is additive counters plus a latency
list reduced by sorting, so the summary is ORDER-INDEPENDENT: feeding
the same completions in any order yields the same numbers (asserted by
``tests/test_workload.py``).  When constructed with a ``sink``
(``repro_torch.fleet.telemetry.FleetTelemetry``), every offer / reject /
completion is mirrored into the fleet's per-class SLO counters so
``BENCH_traffic.json`` and the launcher scoreboard read one source.

A copy of ``repro/workload/slo.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["SLOClass", "SLOTracker", "INTERACTIVE", "STANDARD", "BATCH",
           "DEFAULT_CLASSES", "class_by_name"]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency/value tier.

    ``deadline_for(n)`` = ``deadline_s + per_token_s * n``: the flat
    part covers queueing + prefill, the per-token part scales with the
    output the user asked for.  ``max_outstanding`` bounds how many of
    this class's requests may be in the system at once (queued or in
    service) before admission control sheds load — None = unbounded."""

    name: str
    deadline_s: float           # flat latency floor (queue + prefill)
    per_token_s: float          # per-output-token allowance
    value: float                # worth of one token (fleet objective)
    max_outstanding: int | None = None

    def deadline_for(self, output_len: int) -> float:
        return self.deadline_s + self.per_token_s * output_len


INTERACTIVE = SLOClass("interactive", deadline_s=2.0, per_token_s=0.05,
                       value=4.0, max_outstanding=None)
STANDARD = SLOClass("standard", deadline_s=10.0, per_token_s=0.10,
                    value=2.0, max_outstanding=512)
BATCH = SLOClass("batch", deadline_s=60.0, per_token_s=0.25,
                 value=1.0, max_outstanding=256)

DEFAULT_CLASSES: tuple[SLOClass, ...] = (INTERACTIVE, STANDARD, BATCH)


def class_by_name(name: str,
                  classes: tuple[SLOClass, ...] = DEFAULT_CLASSES) -> SLOClass:
    for c in classes:
        if c.name == name:
            return c
    raise KeyError(f"unknown SLO class {name!r}")


class _ClassStats:
    __slots__ = ("offered", "rejected", "completed", "met",
                 "goodput_tokens", "tokens", "latencies")

    def __init__(self):
        self.offered = 0
        self.rejected = 0        # shed by admission control
        self.completed = 0
        self.met = 0             # completed within deadline
        self.goodput_tokens = 0  # tokens of deadline-met completions
        self.tokens = 0          # tokens of all completions
        self.latencies: list[float] = []


class SLOTracker:
    """Per-class SLO scoreboard: offers, rejects, completions, deadline
    attainment, goodput.  Purely additive — order-independent."""

    def __init__(self, sink=None, monitor=None):
        self._stats: dict[str, _ClassStats] = {}
        self.sink = sink          # Optional[FleetTelemetry]
        # Optional[repro_torch.obs.SLOBurnMonitor]: resolved requests carrying
        # a ``now=`` timestamp additionally feed the windowed burn-rate
        # monitor (run-lifetime counters here, trailing window there)
        self.monitor = monitor

    def _cls(self, name: str) -> _ClassStats:
        return self._stats.setdefault(name, _ClassStats())

    # -- feeds -------------------------------------------------------------
    def offer(self, name: str, now: float | None = None) -> None:
        self._cls(name).offered += 1
        if self.sink is not None:
            self.sink.record_slo_offer(name)

    def reject(self, name: str, now: float | None = None) -> None:
        self._cls(name).rejected += 1
        if self.sink is not None:
            self.sink.record_slo_reject(name)
        if self.monitor is not None and now is not None:
            self.monitor.resolve(name, met=False, t=now)

    def complete(self, name: str, latency_s: float, tokens: int,
                 deadline_s: float, now: float | None = None) -> None:
        s = self._cls(name)
        met = latency_s <= deadline_s + 1e-9
        s.completed += 1
        s.tokens += tokens
        s.latencies.append(latency_s)
        if met:
            s.met += 1
            s.goodput_tokens += tokens
        if self.sink is not None:
            self.sink.record_slo_completion(name, met=met, tokens=tokens)
        if self.monitor is not None and now is not None:
            self.monitor.resolve(name, met=met, t=now)

    # -- reductions --------------------------------------------------------
    def outstanding(self, name: str) -> int:
        """Requests of this class currently in the system (admitted —
        queued or in service — but not yet completed): the quantity
        admission control bounds."""
        s = self._stats.get(name)
        if s is None:
            return 0
        return s.offered - s.rejected - s.completed

    def attainment(self, name: str) -> float:
        """Fraction of this class's RESOLVED requests (completed or
        rejected) that met their deadline — a rejected request is a
        miss the admission controller chose, not a free pass."""
        s = self._stats.get(name)
        if s is None:
            return 1.0
        resolved = s.completed + s.rejected
        return s.met / resolved if resolved else 1.0

    def goodput_tokens(self) -> int:
        return sum(s.goodput_tokens for s in self._stats.values())

    @staticmethod
    def _pct(sorted_vals: list[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
        return sorted_vals[i]

    def summary(self) -> dict:
        """Per-class scoreboard (deterministic key order)."""
        out = {}
        for name in sorted(self._stats):
            s = self._stats[name]
            lat = sorted(s.latencies)
            out[name] = {
                "offered": s.offered,
                "rejected": s.rejected,
                "completed": s.completed,
                "met": s.met,
                "attainment": self.attainment(name),
                "tokens": s.tokens,
                "goodput_tokens": s.goodput_tokens,
                "p50_latency_s": self._pct(lat, 0.50),
                "p99_latency_s": self._pct(lat, 0.99),
            }
        return out
