"""Pluggable decision metrics: protocol + registry.

A copy of ``repro/power/metrics.py`` for the port.

The paper evaluates two cap-selection metrics (SED and ED) and hints that
the right metric is workload- and site-specific.  This module makes the
metric a first-class plugin: anything exposing ``name`` /
``higher_is_better`` / ``score(table, task) -> {cap: score}`` participates
in cap selection, and ``@register_metric("...")`` makes it addressable by
string everywhere a metric name is accepted (CLI flags, configs,
``PowerManager(metric=...)``) — no controller changes needed.

Built-ins:

  sed   speedup-energy-delay (maximize)          — paper metric 1
  ed    normalized Euclidean distance (minimize) — paper metric 2
  edw   runtime-weighted ED (minimize)           — example user metric: like
        ED but penalizing runtime twice as hard, for latency-sensitive
        deployments (the kind of site-specific variant the registry exists
        for)
"""

from __future__ import annotations

import math
from typing import Callable, Protocol, runtime_checkable

from repro_torch.core import metrics as _paper
from repro_torch.core.tasks import TaskTable


# ---------------------------------------------------------------------------
# shared distance machinery (lifted out of single-node selection)
# ---------------------------------------------------------------------------
#
# The paper's Global Criterion method — Euclidean distance of min-max-
# normalized objectives, argmin is Pareto-optimal — used to live only in
# the per-task metric classes below.  The fleet-level Pareto controller
# (the JAX package's ``repro.fleet.pareto``) scores candidate GRANTS
# with the same math, so the normalization + distance code is shared here.  The formulas are kept
# verbatim from the historical implementations (``math.sqrt`` for the
# unweighted case, ``** 0.5`` for the weighted one) so registry scores and
# cap picks stay bit-identical — ``tests/test_paper_claims.py`` pins this.

def minmax_normalize(vals: "list[float]") -> list[float]:
    """Min-max normalize to [0, 1]; a degenerate axis (all values equal)
    collapses to 0.0 everywhere, exactly like the paper-layer helper."""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return [0.0 for _ in vals]
    return [(v - lo) / (hi - lo) for v in vals]


def euclidean_distance_scores(pairs: "list[tuple[float, float]]",
                              runtime_weight: float = 1.0) -> list[float]:
    """Distance of each min-max-normalized ``(energy-like, runtime-like)``
    pair from the utopia point (0, 0).  Lower is better; the argmin is
    Pareto-optimal (Global Criterion).  ``runtime_weight`` scales the
    second axis — >1 pulls the pick toward faster (higher-cap) settings,
    the ``edw`` family."""
    n_a = minmax_normalize([a for a, _ in pairs])
    n_b = minmax_normalize([b for _, b in pairs])
    if runtime_weight == 1.0:
        return [math.sqrt(a * a + b * b) for a, b in zip(n_a, n_b)]
    w = runtime_weight
    return [(a * a + w * w * b * b) ** 0.5 for a, b in zip(n_a, n_b)]


#: Absolute tie tolerance for minimize-style distance picks (mirrors the
#: historical ``ed_optimal_cap`` argmin exactly).
ED_TIE_ABS = 1e-12


def nearest_utopia_pick(keys: "list[float]",
                        pairs: "list[tuple[float, float]]",
                        runtime_weight: float = 1.0) -> float:
    """The key whose pair sits closest to the utopia point; distance ties
    resolve to the LOWER key (energy-prudent, like every cap pick)."""
    d = euclidean_distance_scores(pairs, runtime_weight)
    best = min(d)
    return min(k for k, v in zip(keys, d) if v <= best + ED_TIE_ABS)


@runtime_checkable
class Metric(Protocol):
    """A per-task cap-scoring rule over a (task x cap) table."""

    name: str
    higher_is_better: bool

    def score(self, table: TaskTable, task: str) -> dict[float, float]:
        """Score every swept cap for ``task``.  Interpreted through
        ``higher_is_better``; ties break toward the lower (energy-prudent)
        cap."""
        ...


_REGISTRY: dict[str, Metric] = {}

#: Relative tie tolerance on scores (matches the historical sed/ed argmin
#: behavior so registry lookups reproduce the old code paths bit-for-bit).
_TIE_REL = 1e-12


def register_metric(name: str) -> Callable:
    """Class/instance decorator: ``@register_metric("sed")``.  Classes are
    instantiated with no arguments; the instance is what gets registered."""
    def deco(obj):
        inst = obj() if isinstance(obj, type) else obj
        inst.name = name
        _REGISTRY[name] = inst
        return obj
    return deco


def get_metric(metric: "str | Metric") -> Metric:
    """Resolve a metric name (or pass a Metric instance through)."""
    if isinstance(metric, str):
        try:
            return _REGISTRY[metric]
        except KeyError:
            raise ValueError(
                f"unknown metric {metric!r}; registered: "
                f"{sorted(_REGISTRY)}") from None
    if isinstance(metric, Metric):
        return metric
    raise TypeError(f"metric must be a name or Metric, got {type(metric)}")


def available_metrics() -> list[str]:
    return sorted(_REGISTRY)


def rank_caps(metric: "str | Metric", table: TaskTable,
              task: str) -> list[float]:
    """Caps best-first under ``metric`` (score order, caps ascending within
    equal scores — the goal filter walks this list)."""
    m = get_metric(metric)
    score = m.score(table, task)
    sign = -1.0 if m.higher_is_better else 1.0
    return sorted(score, key=lambda c: (sign * score[c], c))


def optimal_cap(metric: "str | Metric", table: TaskTable,
                task: str) -> float:
    """Best cap under ``metric``; score ties resolve to the LOWER cap.

    The tie thresholds mirror the historical sed/ed argmin formulas
    exactly (including the infinite-SED corner from zero-product rows);
    the fallback covers metrics with negative scores, where the relative
    threshold can exclude everything."""
    m = get_metric(metric)
    score = m.score(table, task)
    if m.higher_is_better:
        best = max(score.values())
        cands = [c for c, v in score.items() if v >= best * (1 - _TIE_REL)]
    else:
        best = min(score.values())
        cands = [c for c, v in score.items() if v <= best + _TIE_REL]
    if not cands:
        cands = [c for c, v in score.items() if v == best]
    return min(cands)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

@register_metric("sed")
class SedMetric:
    """Paper metric 1: speedup-energy-delay against the default cap."""

    higher_is_better = True

    def score(self, table: TaskTable, task: str) -> dict[float, float]:
        return _paper.speedup_energy_delay(table, task)


@register_metric("ed")
class EdMetric:
    """Paper metric 2: Euclidean distance of min-max-normalized
    (energy, runtime); the argmin is Pareto-optimal.  Scores through the
    shared ``euclidean_distance_scores`` — the same code the fleet Pareto
    controller ranks candidate grants with."""

    higher_is_better = False

    def score(self, table: TaskTable, task: str) -> dict[float, float]:
        rows = table.for_task(task)
        d = euclidean_distance_scores([(r.energy, r.runtime) for r in rows])
        return {r.cap: v for r, v in zip(rows, d)}


@register_metric("edw")
class RuntimeWeightedEd:
    """ED with runtime weighted ``runtime_weight``x: pulls the pick toward
    higher caps for latency-sensitive sites.  Demonstrates a user-defined
    metric riding the registry."""

    higher_is_better = False

    def __init__(self, runtime_weight: float = 2.0):
        self.runtime_weight = runtime_weight

    def score(self, table: TaskTable, task: str) -> dict[float, float]:
        rows = table.for_task(task)
        d = euclidean_distance_scores([(r.energy, r.runtime) for r in rows],
                                      runtime_weight=self.runtime_weight)
        return {r.cap: v for r, v in zip(rows, d)}
