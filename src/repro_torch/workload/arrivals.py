"""Deterministic open-loop traffic generation for the fleet simulator.

A workload is a TRACE: a pre-generated, time-sorted list of
``ArrivalEvent``s drawn once from a single ``numpy.random.Generator``
seeded explicitly — no global RNG state, no wall clock — so the same
seed replays the identical trace bit-for-bit (the determinism contract
``tests/test_workload.py`` asserts and the traffic benchmark's two-run
gate depends on).

Shapes available:

  * ``DiurnalRate`` — a sinusoid-modulated base rate (the day/night
    cycle a million-user service sees: traffic peaks mid-"day",
    troughs mid-"night").
  * ``Burst`` overlays — additive rate spikes (a product launch, a
    retry storm) on top of the diurnal floor.
  * ``LengthSampler`` — bounded-Pareto (heavy-tailed) prompt/output
    lengths via inverse-CDF, so most requests are short but the tail
    is long, clipped to hard ``lo``/``hi`` bounds.

Arrivals are drawn by Lewis thinning: candidate points come from a
homogeneous Poisson process at the trace's PEAK rate and are accepted
with probability ``rate(t) / peak``.  Every candidate consumes a fixed
number of RNG draws in a fixed order, which is what makes the trace a
pure function of the seed.

A copy of ``repro/workload/arrivals.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.workload.slo import DEFAULT_CLASSES, SLOClass

__all__ = ["ArrivalEvent", "Burst", "ClassMix", "DiurnalRate",
           "LengthSampler", "TrafficGenerator"]


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One request hitting the front door at virtual time ``t``."""

    t: float            # arrival time on the fleet's VirtualClock
    uid: int            # unique, monotone per trace
    slo: str            # SLO class name ("interactive" | ...)
    prompt_len: int
    output_len: int
    value: float        # the class's token value (fleet objective units)
    deadline_s: float   # absolute latency budget for THIS request


@dataclasses.dataclass(frozen=True)
class DiurnalRate:
    """Sinusoidal day/night request rate (requests / virtual second):

        rate(t) = base_rps * (1 + amplitude * sin(2*pi*(t+phase)/period))

    ``amplitude`` in [0, 1] keeps the rate non-negative; ``phase``
    shifts where the peak lands (phase = period/4 puts the peak at
    t = 0)."""

    base_rps: float
    amplitude: float = 0.6
    period_s: float = 60.0
    phase_s: float = 0.0

    def __post_init__(self):
        if self.base_rps < 0:
            raise ValueError(f"base_rps must be >= 0, got {self.base_rps}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1], got {self.amplitude}")
        if self.period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")

    def at(self, t: float) -> float:
        return self.base_rps * (
            1.0 + self.amplitude
            * math.sin(2.0 * math.pi * (t + self.phase_s) / self.period_s))

    @property
    def peak(self) -> float:
        return self.base_rps * (1.0 + self.amplitude)


@dataclasses.dataclass(frozen=True)
class Burst:
    """An additive rate spike: ``rps`` extra requests/s over
    ``[t0, t0 + duration_s)``."""

    t0: float
    duration_s: float
    rps: float

    def at(self, t: float) -> float:
        return self.rps if self.t0 <= t < self.t0 + self.duration_s else 0.0


@dataclasses.dataclass(frozen=True)
class LengthSampler:
    """Bounded-Pareto token lengths: heavy-tailed between hard bounds.

    Inverse-CDF sampling of a Pareto(alpha) truncated to [lo, hi]:
    most draws sit near ``lo``, the tail stretches toward ``hi`` —
    smaller ``alpha`` = heavier tail.  Draws are integers and ALWAYS
    inside [lo, hi] (the property tests fuzz this)."""

    lo: int
    hi: int
    alpha: float = 1.5

    def __post_init__(self):
        if not 1 <= self.lo <= self.hi:
            raise ValueError(f"need 1 <= lo <= hi, got [{self.lo}, {self.hi}]")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")

    def sample(self, rng: np.random.Generator) -> int:
        u = rng.random()
        if self.lo == self.hi:
            return self.lo
        ratio = (self.lo / self.hi) ** self.alpha
        x = self.lo * (1.0 - u * (1.0 - ratio)) ** (-1.0 / self.alpha)
        return int(min(max(math.floor(x), self.lo), self.hi))


@dataclasses.dataclass(frozen=True)
class ClassMix:
    """One SLO class's share of the traffic and its length shapes."""

    slo: SLOClass
    weight: float
    prompt: LengthSampler
    output: LengthSampler


def _default_mix() -> tuple[ClassMix, ...]:
    inter, std, batch = DEFAULT_CLASSES
    return (
        ClassMix(inter, weight=0.5,
                 prompt=LengthSampler(16, 256, alpha=1.6),
                 output=LengthSampler(16, 128, alpha=1.8)),
        ClassMix(std, weight=0.35,
                 prompt=LengthSampler(32, 1024, alpha=1.4),
                 output=LengthSampler(32, 256, alpha=1.5)),
        ClassMix(batch, weight=0.15,
                 prompt=LengthSampler(64, 2048, alpha=1.2),
                 output=LengthSampler(64, 512, alpha=1.3)),
    )


class TrafficGenerator:
    """Seed -> trace.  ``events(until_s)`` returns the full arrival list
    for the horizon, time-sorted, generated in ONE pass from one
    explicitly seeded ``numpy.random.Generator``.

    Thinning draws, per candidate point, in FIXED order: the
    exponential gap, the accept uniform, and (accepted only) the class
    pick + two length draws — so the trace is a pure function of
    ``(seed, rate shape, mix, horizon)`` and replays bit-identically."""

    def __init__(self, seed: int, rate: DiurnalRate,
                 bursts: tuple[Burst, ...] = (),
                 mix: tuple[ClassMix, ...] | None = None):
        if mix is None:
            mix = _default_mix()
        if not mix:
            raise ValueError("need at least one traffic class")
        total_w = sum(m.weight for m in mix)
        if total_w <= 0:
            raise ValueError("class weights must sum to > 0")
        self.seed = seed
        self.rate = rate
        self.bursts = tuple(bursts)
        self.mix = tuple(mix)
        self._probs = np.asarray([m.weight / total_w for m in mix])

    def rate_at(self, t: float) -> float:
        return self.rate.at(t) + sum(b.at(t) for b in self.bursts)

    @property
    def peak_rate(self) -> float:
        """Upper bound on the instantaneous rate — the thinning
        envelope (diurnal peak plus every burst stacked; bursts may
        overlap, so the sum is the only safe bound)."""
        return self.rate.peak + sum(b.rps for b in self.bursts)

    def events(self, until_s: float) -> list[ArrivalEvent]:
        rng = np.random.default_rng(self.seed)
        peak = self.peak_rate
        out: list[ArrivalEvent] = []
        if peak <= 0 or until_s <= 0:
            return out
        t, uid = 0.0, 0
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= until_s:
                break
            accept = rng.random()
            if accept * peak > self.rate_at(t):
                continue
            ci = int(rng.choice(len(self.mix), p=self._probs))
            m = self.mix[ci]
            plen = m.prompt.sample(rng)
            olen = m.output.sample(rng)
            out.append(ArrivalEvent(
                t=t, uid=uid, slo=m.slo.name, prompt_len=plen,
                output_len=olen, value=m.slo.value,
                deadline_s=m.slo.deadline_for(olen)))
            uid += 1
        return out
