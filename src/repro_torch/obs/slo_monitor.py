"""Windowed SLO attainment / error-budget burn-rate monitoring.

``SLOTracker`` keeps run-lifetime totals — the right thing for a
benchmark scoreboard, the wrong thing for a control signal: a morning
of perfect attainment hides an afternoon meltdown behind the average.
``SLOBurnMonitor`` keeps the TRAILING WINDOW instead and prices it as
error-budget burn, SRE-style:

    burn_rate = (1 - windowed_attainment) / (1 - target_attainment)

burn 1.0 means the class is consuming its error budget exactly as fast
as the target allows; above 1.0 the budget is burning down and the
autoscaler should move (wake nodes, veto shrinks) BEFORE the
run-lifetime attainment number degrades.

The monitor is fed through ``SLOTracker`` (construct it with
``monitor=``, pass ``now=`` on offers/rejects/completions) and is a
READ-ONLY signal: it never mutates workload or fleet state, so wiring
it in cannot perturb a bit-identical replay.  Everything is arithmetic
over explicit virtual timestamps — no wall clock, no randomness.

A copy of ``repro/obs/slo_monitor.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

from collections import deque

__all__ = ["SLOBurnMonitor", "DEFAULT_TARGET_ATTAINMENT"]

#: Default per-class attainment target: a 5% error budget.  Real
#: deployments set per-class targets (interactive tighter than batch).
DEFAULT_TARGET_ATTAINMENT = 0.95


class SLOBurnMonitor:
    """Trailing-window attainment and error-budget burn per SLO class.

    ``window_s`` is the trailing horizon (virtual seconds); ``targets``
    maps class name -> target attainment in (0, 1), defaulting every
    class to ``DEFAULT_TARGET_ATTAINMENT``.  A rejected request counts
    as a windowed miss, exactly as ``SLOTracker.attainment`` counts it
    — admission shedding spends error budget too.
    """

    def __init__(self, window_s: float = 30.0,
                 targets: dict[str, float] | None = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = window_s
        self.targets = dict(targets or {})
        # class -> deque[(t, met)], pruned to the trailing window
        self._events: dict[str, deque] = {}
        self._last_t = 0.0

    def target(self, name: str) -> float:
        return self.targets.get(name, DEFAULT_TARGET_ATTAINMENT)

    # -- feed --------------------------------------------------------------
    def resolve(self, name: str, met: bool, t: float) -> None:
        """One resolved request (completion or rejection) at virtual
        time ``t``."""
        q = self._events.setdefault(name, deque())
        q.append((t, bool(met)))
        self._last_t = max(self._last_t, t)

    def _window(self, name: str, now: float) -> deque:
        q = self._events.get(name)
        if q is None:
            return deque()
        while q and q[0][0] < now - self.window_s:
            q.popleft()
        return q

    # -- reductions --------------------------------------------------------
    def attainment(self, name: str, now: float | None = None) -> float:
        """Windowed fraction of resolved requests that met their
        deadline (1.0 when the window is empty — no evidence of
        trouble is not trouble)."""
        now = self._last_t if now is None else now
        q = self._window(name, now)
        if not q:
            return 1.0
        return sum(1 for _, met in q if met) / len(q)

    def burn_rate(self, name: str, now: float | None = None) -> float:
        """Error-budget burn multiple for ``name`` over the window."""
        target = self.target(name)
        budget = max(1.0 - target, 1e-9)
        return (1.0 - self.attainment(name, now)) / budget

    def burning(self, now: float | None = None) -> list[str]:
        """Classes currently burning budget faster than target allows
        (burn > 1.0), sorted worst-first then by name."""
        hot = [(self.burn_rate(c, now), c) for c in sorted(self._events)]
        return [c for rate, c in sorted(hot, key=lambda x: (-x[0], x[1]))
                if rate > 1.0]

    def snapshot(self, now: float | None = None) -> dict:
        """Per-class scoreboard row (deterministic key order): windowed
        attainment, burn rate, and how many resolutions the window
        holds — the read-only signal the autoscaler and the launcher
        scoreboard consume."""
        now = self._last_t if now is None else now
        out = {}
        for name in sorted(self._events):
            q = self._window(name, now)
            out[name] = {
                "attainment": self.attainment(name, now),
                "burn": self.burn_rate(name, now),
                "resolved": len(q),
                "target": self.target(name),
            }
        return out
