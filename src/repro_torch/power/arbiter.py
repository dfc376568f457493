"""Budget splitting: one shared power budget across many consumers.

A copy of ``repro/power/arbiter.py`` for the port.

System-scale power management (the ORNL study, arXiv 2408.01552) caps at
the cabinet/pod level; each superchip's PowerManager then *requests* a cap
per phase and an arbiter grants what the shared budget allows.

``weighted_split`` is the generic machinery: a water-filling proportional
splitter with per-consumer floors, ceilings and weights.  It is the single
allocation primitive under both

  * ``PodPowerArbiter`` — the historical pod-level splitter (equal-spec
    superchips, weights proportional to each request's headroom above the
    floor), and
  * the JAX package's ``repro.fleet.FleetPowerController`` — the
    hierarchical facility -> cabinet -> node arbiter, which passes
    performance-sensitivity weights so watts flow to the consumers that
    buy the most throughput.

Grants are conserved: the sum of grants never exceeds the budget whenever
the budget covers the floors (below that the floors win — deep-idle draw
cannot be capped away and the pool is physically over budget).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Protocol, runtime_checkable

from repro_torch.hw.tpu import DEFAULT_SUPERCHIP, SuperchipSpec


@runtime_checkable
class CapSource(Protocol):
    """Anything that can name a cap for a phase (``CapSchedule``,
    ``PowerManager``, ...)."""

    def cap_for(self, phase: str) -> float:
        ...


def _per_key(value, keys, name: str) -> dict[str, float]:
    """Broadcast a scalar (or pass through a mapping) to every key."""
    if isinstance(value, Mapping):
        missing = [k for k in keys if k not in value]
        if missing:
            raise KeyError(f"{name} missing entries for {missing}")
        return {k: float(value[k]) for k in keys}
    return {k: float(value) for k in keys}


def weighted_split(requests: Mapping[str, float], budget_w: float,
                   floor: "float | Mapping[str, float]" = 0.0,
                   ceil: "float | Mapping[str, float] | None" = None,
                   weights: "Mapping[str, float] | None" = None,
                   ) -> dict[str, float]:
    """Split ``budget_w`` across ``{consumer: requested_w}``.

    Requests are clamped to ``[floor, ceil]`` per consumer.  If the clamped
    sum fits the budget, everyone gets their request.  Otherwise each
    consumer keeps its floor and the remaining budget is distributed over
    the headroom (request - floor) proportionally to ``weights`` —
    water-filling, so a consumer whose share would exceed its own headroom
    is saturated at its request and the excess re-flows to the rest.

    ``weights`` defaults to each consumer's headroom, which reproduces the
    historical ``PodPowerArbiter`` proportional-above-floor behavior in a
    single pass.  Zero/negative weights never receive above-floor watts
    (unless every weight is zero, which falls back to headroom weights).

    Conservation: ``sum(grants) <= budget_w`` whenever
    ``budget_w >= sum(floors)``; below the floors, the floors win.
    """
    if not requests:
        return {}
    keys = list(requests)
    floors = _per_key(floor, keys, "floor")
    ceils = (_per_key(ceil, keys, "ceil") if ceil is not None
             else {k: float("inf") for k in keys})
    req = {k: min(max(float(requests[k]), floors[k]), ceils[k])
           for k in keys}
    if sum(req.values()) <= budget_w:
        return req

    avail = budget_w - sum(floors.values())
    grants = dict(floors)
    if avail <= 0:
        return grants
    headroom = {k: req[k] - floors[k] for k in keys}
    w = ({k: max(float(weights[k]), 0.0) for k in keys}
         if weights is not None else dict(headroom))
    if sum(w.values()) <= 0.0:
        w = dict(headroom)

    # water-fill: saturate consumers whose weighted share exceeds their own
    # headroom, re-flowing the excess; terminates in <= n rounds.
    active = [k for k in keys if headroom[k] > 0 and w[k] > 0]
    while active and avail > 0:
        total_w = sum(w[k] for k in active)
        if total_w <= 0:
            break
        saturated = [k for k in active
                     if avail * w[k] / total_w >= headroom[k]]
        if not saturated:
            for k in active:
                grants[k] = floors[k] + avail * w[k] / total_w
            break
        for k in saturated:
            grants[k] = req[k]
            avail -= headroom[k]
            active.remove(k)
    return grants


@dataclasses.dataclass(frozen=True)
class PodPowerArbiter:
    """Proportional-above-floor splitter for one pod budget (watts).

    Grants are proportional above a per-superchip floor (deep-idle draw
    can't be capped away), so the budget is conserved: the sum of grants
    equals the budget whenever requests exceed it, and equals the requests
    when they fit.  A thin equal-spec instance of ``weighted_split``.
    """

    budget_w: float
    spec: SuperchipSpec = dataclasses.field(
        default_factory=lambda: DEFAULT_SUPERCHIP)
    floor_w: float | None = None   # default: host idle + chip deep-idle

    @property
    def floor(self) -> float:
        return self.floor_w if self.floor_w is not None \
            else self.spec.p_floor

    def split(self, requests: Mapping[str, float]) -> dict[str, float]:
        """Grant caps for ``{superchip_id: requested_cap_w}``.

        Requests are clamped to [floor, spec.p_max].  If the clamped sum
        fits the budget, everyone gets their request; otherwise the excess
        above the floor is scaled down proportionally so the grants sum
        exactly to the budget (when the budget covers the floors — below
        that the floors win and the pod is physically over budget)."""
        return weighted_split(requests, self.budget_w,
                              floor=self.floor, ceil=self.spec.p_max)

    def split_phase(self, schedules: Mapping[str, CapSource],
                    phase: str) -> dict[str, float]:
        """Convenience: grants for one phase across per-chip CapSchedules
        (or anything with ``cap_for``)."""
        return self.split({k: s.cap_for(phase)
                           for k, s in schedules.items()})
