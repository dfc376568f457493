"""Learned power curves + fleet-level Pareto steering.

The source paper's Euclidean-distance multi-objective method (Global
Criterion: the cap whose min-max-normalized (energy, runtime) point sits
closest to the utopia point is Pareto-optimal) lives in single-node cap
selection as ``repro_torch.power.metrics``.  This module lifts it to the fleet:

  ``PowerCurveModel``   per-node analytic perf-vs-cap and watts-vs-cap
                        curves fit ONLINE from observed ``NodeSample``s —
                        EWMA-weighted least squares over the sweet-spot
                        model family (perf concave-saturating in the cap,
                        draw affine below the attainability knee, after
                        "Modeling and Chasing the Energy-Efficiency Sweet
                        Spots in Modern GPUs"), with confidence tracking
                        so a cold or thin fit never outranks the modeled
                        fallback.
  ``CurveBank``         the fleet-wide registry: one model per node, fed
                        each control quantum, plus a per-slot watt-cost
                        fit (draw regressed on active decode slots) that
                        makes ``FleetScheduler`` partial-drain shed
                        sizing exact instead of assuming the static
                        ``margin_w / capacity`` share.
  ``pareto_cap(...)``   the grant-space ED pick: candidate caps scored by
                        normalized (J/token, s/token) distance — s/token
                        is the inverse of latency-SLO headroom, weighted
                        by the job's token value exactly like the ``edw``
                        registry metric weights runtime for
                        latency-sensitive sites.

``FleetPowerController(policy="pareto")`` consumes all three: each node's
request becomes its Pareto-point cap (fitted curves when confident, the
modeled curve as cold-start fallback), water-filled under the ordinary
facility -> cabinet -> node hierarchy; a grant-level exploration budget
periodically probes off-curve caps (round-robin over the sweep, the same
pattern ``PowerManager.next_cap`` uses to recover from stale tables) so a
mis-modeled node is re-learned instead of starved forever.

Everything here is pure arithmetic over the samples it is fed — no wall
clock, no randomness — so two same-seed fleet runs stay bit-identical
(the contract ``tests/test_pareto.py`` asserts for the pareto mode too).

A copy of ``repro/fleet/pareto.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.power.metrics import nearest_utopia_pick

#: Default forgetting factor per observation — matches the spirit of
#: ``PowerManager``'s EWMA table refinement: recent samples dominate, a
#: drifted node is re-learned in O(1 / (1 - decay)) observations.
CURVE_DECAY = 0.9

#: Distinct cap bins (see ``_BIN_W``) a fit needs before its 3-parameter
#: perf curve is identifiable at all.
MIN_CAP_BINS = 3

#: Effective observation weight a fit needs before it is trusted.
MIN_FIT_WEIGHT = 4.0

#: Confidence at or above which the controller prefers the fitted curve
#: over the node's modeled one.
READY_CONFIDENCE = 0.6

#: Cap-bin width (watts) for the distinct-support confidence axis.
_BIN_W = 15.0

#: Tikhonov ridge keeping the tiny normal-equation solves well-posed.
_RIDGE = 1e-6


def _solve(a: list[list[float]], b: list[float]) -> "list[float] | None":
    """Gaussian elimination with partial pivoting for the n<=3 normal
    equations (pure Python keeps the fit dependency-free and bitwise
    deterministic across platforms)."""
    n = len(b)
    m = [row[:] + [b[i]] for i, row in enumerate(a)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(m[r][col]))
        if abs(m[piv][col]) < 1e-30:
            return None
        if piv != col:
            m[col], m[piv] = m[piv], m[col]
        inv = 1.0 / m[col][col]
        for r in range(n):
            if r == col:
                continue
            f = m[r][col] * inv
            if f != 0.0:
                for c in range(col, n + 1):
                    m[r][c] -= f * m[col][c]
    return [m[i][n] / m[i][i] for i in range(n)]


class PowerCurveModel:
    """One node's fitted perf-vs-cap and watts-vs-cap curves.

    Model family (the analytic sweet-spot shape):

      perf(p)  = a + b*p + c*sqrt(p)     concave-saturating: the sqrt term
                                         carries the memory-bound flattening
                                         past the knee, the linear term the
                                         compute-bound rise below it
      watts(p) = d + e*p                 attainable draw is affine in the
                                         cap until the workload's own peak

    Both are EWMA-weighted least squares, maintained recursively: every
    ``observe`` decays the accumulated normal equations by ``decay`` and
    adds the new sample's contribution, so the fit forgets a mis-modeled
    or drifted past at the same cadence ``PowerManager``'s EWMA table
    forgets a stale sweep.  ``confidence`` combines effective weight with
    distinct-cap support (a fit that has only ever seen one grant level
    cannot extrapolate and must not be trusted)."""

    def __init__(self, decay: float = CURVE_DECAY,
                 min_bins: int = MIN_CAP_BINS,
                 min_weight: float = MIN_FIT_WEIGHT):
        self.decay = decay
        self.min_bins = min_bins
        self.min_weight = min_weight
        # normal equations: perf basis [1, p, sqrt(p)]; watts basis [1, p]
        self._ap = [[0.0] * 3 for _ in range(3)]
        self._bp = [0.0] * 3
        self._aw = [[0.0] * 2 for _ in range(2)]
        self._bw = [0.0] * 2
        self._bins: dict[int, float] = {}   # cap bin -> decayed support
        self.weight = 0.0                   # decayed total sample weight
        self.observations = 0

    # -- feed ---------------------------------------------------------------
    def observe(self, grant_w: float, perf: float, watts: float,
                weight: float = 1.0) -> None:
        """Fold one observation (tokens/s and draw at ``grant_w``) into
        both fits; non-physical inputs are ignored, not poisonous."""
        if grant_w <= 0 or perf < 0 or watts < 0 or weight <= 0:
            return
        d = self.decay
        for r in range(3):
            self._bp[r] *= d
            for c in range(3):
                self._ap[r][c] *= d
        for r in range(2):
            self._bw[r] *= d
            for c in range(2):
                self._aw[r][c] *= d
        for k in self._bins:
            self._bins[k] *= d
        phi = (1.0, grant_w, math.sqrt(grant_w))
        for r in range(3):
            self._bp[r] += weight * phi[r] * perf
            for c in range(3):
                self._ap[r][c] += weight * phi[r] * phi[c]
        psi = (1.0, grant_w)
        for r in range(2):
            self._bw[r] += weight * psi[r] * watts
            for c in range(2):
                self._aw[r][c] += weight * psi[r] * psi[c]
        b = int(grant_w / _BIN_W)
        self._bins[b] = self._bins.get(b, 0.0) + weight
        self.weight = self.weight * d + weight
        self.observations += 1

    # -- confidence ---------------------------------------------------------
    @property
    def support(self) -> int:
        """Distinct cap bins with non-vanishing decayed weight."""
        return sum(1 for w in self._bins.values() if w > 0.05)

    @property
    def confidence(self) -> float:
        """[0, 1]: distinct-cap support x effective sample weight.  0
        until the fit is identifiable, ~1 once it has seen a spread of
        recent grants."""
        if self.observations == 0:
            return 0.0
        c_bins = min(1.0, self.support / float(self.min_bins))
        c_weight = min(1.0, self.weight / self.min_weight)
        return c_bins * c_weight

    @property
    def ready(self) -> bool:
        return self.confidence >= READY_CONFIDENCE

    # -- predictions --------------------------------------------------------
    def _theta_perf(self) -> "list[float] | None":
        a = [[self._ap[r][c] + (_RIDGE if r == c else 0.0)
              for c in range(3)] for r in range(3)]
        return _solve(a, self._bp)

    def _theta_watts(self) -> "list[float] | None":
        a = [[self._aw[r][c] + (_RIDGE if r == c else 0.0)
              for c in range(2)] for r in range(2)]
        return _solve(a, self._bw)

    def predict_perf(self, cap_w: float) -> "float | None":
        """Fitted tokens/s at ``cap_w`` (clamped to >= 0); None while the
        fit is unsolvable."""
        th = self._theta_perf()
        if th is None or cap_w <= 0:
            return None
        return max(0.0, th[0] + th[1] * cap_w + th[2] * math.sqrt(cap_w))

    def predict_watts(self, cap_w: float) -> "float | None":
        """Fitted draw at ``cap_w``, clamped into (0, cap]: the chip
        cannot draw more than its cap nor a negative amount."""
        th = self._theta_watts()
        if th is None or cap_w <= 0:
            return None
        return min(max(1e-9, th[0] + th[1] * cap_w), cap_w)


class CurveBank:
    """Fleet-wide curve registry: one ``PowerCurveModel`` per node plus a
    per-node (watts vs active decode slots) fit for exact shed sizing.

    ``observe(sample, slots=...)`` is called once per recorded
    ``NodeSample``; ``slot_watt(node)`` exposes the fitted per-slot watt
    cost (the regression slope) once it is confidently positive, and
    ``FleetScheduler`` consults it in place of the static
    ``margin_w / capacity`` heuristic when sizing partial drains."""

    def __init__(self, decay: float = CURVE_DECAY):
        self.decay = decay
        self._models: dict[str, PowerCurveModel] = {}
        # per-node decayed sums for the watts-vs-slots line fit
        self._slot: dict[str, list[float]] = {}   # [n, sx, sxx, sy, sxy]
        self._slot_support: dict[str, set] = {}
        self.observations = 0

    def for_node(self, name: str) -> PowerCurveModel:
        m = self._models.get(name)
        if m is None:
            m = self._models[name] = PowerCurveModel(decay=self.decay)
        return m

    def observe(self, sample, slots: "int | None" = None) -> None:
        """Fold one telemetry sample into the node's curve fits.  Samples
        with no busy time carry no rate information and are skipped."""
        busy = getattr(sample, "busy_s", 0.0)
        if busy <= 0:
            return
        perf = sample.tokens / busy
        watts = sample.energy_j / busy
        self.for_node(sample.node).observe(sample.grant_w, perf, watts)
        self.observations += 1
        if slots is not None and slots > 0:
            s = self._slot.setdefault(sample.node, [0.0] * 5)
            d = self.decay
            for i in range(5):
                s[i] *= d
            x = float(slots)
            s[0] += 1.0
            s[1] += x
            s[2] += x * x
            s[3] += watts
            s[4] += x * watts
            self._slot_support.setdefault(sample.node, set()).add(slots)

    # -- what the scheduler asks --------------------------------------------
    def slot_watt(self, node_name: str) -> "float | None":
        """Fitted watts one active decode slot costs on ``node_name`` —
        the slope of the (slots, draw) regression.  None until at least
        two distinct slot counts were observed or while the slope is not
        confidently positive (a flat or inverted fit must not shrink a
        shed below what physics demands)."""
        s = self._slot.get(node_name)
        if s is None or len(self._slot_support.get(node_name, ())) < 2:
            return None
        n, sx, sxx, sy, sxy = s
        den = n * sxx - sx * sx
        if den <= 1e-12:
            return None
        slope = (n * sxy - sx * sy) / den
        return slope if slope > 1e-9 else None

    # -- scoreboard ---------------------------------------------------------
    def ready_count(self) -> int:
        return sum(1 for m in self._models.values() if m.ready)

    def mean_confidence(self) -> float:
        if not self._models:
            return 0.0
        return (sum(m.confidence for m in self._models.values())
                / len(self._models))

    def confidences(self) -> dict[str, float]:
        return {k: self._models[k].confidence
                for k in sorted(self._models)}


# ---------------------------------------------------------------------------
# grant-space ED selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GrantPoint:
    """One candidate grant's objective point."""

    cap_w: float
    s_per_token: float     # inverse latency-SLO headroom (delay axis)
    j_per_token: float     # the paper's energy-efficiency axis


def _snap_degenerate(vals: "list[float]") -> list[float]:
    """Collapse a RELATIVELY flat axis to a constant before min-max
    normalization.  Fitted curves carry O(ridge) wiggle; on a genuinely
    flat axis (e.g. a perf curve that saturated everywhere on the sweep)
    min-max normalization would amplify that sub-1e-5-relative noise to
    full [0, 1] scale and let it outvote the real axis.  Real curve
    variation across a sweep is >= 1e-2 relative, so the 1e-4 cut only
    ever fires on fit noise.  The paper-layer normalizer collapses only
    an EXACTLY constant axis and must stay bit-identical, so the guard
    lives here in grant space."""
    lo, hi = min(vals), max(vals)
    scale = max(abs(lo), abs(hi))
    if scale > 0.0 and hi - lo <= 1e-4 * scale:
        return [0.0] * len(vals)
    return vals


def pareto_cap(points: "list[GrantPoint]",
               runtime_weight: float = 1.0) -> float:
    """The candidate cap whose normalized (J/token, s/token) point sits
    closest to the utopia point — the paper's ED selection lifted from
    (task x cap) tables to grant space.  ``runtime_weight`` > 1 penalizes
    delay harder (a latency-sensitive, high-value job), exactly like the
    ``edw`` registry metric; ties resolve to the lower cap."""
    caps = [p.cap_w for p in points]
    e_axis = _snap_degenerate([p.j_per_token for p in points])
    s_axis = _snap_degenerate([p.s_per_token for p in points])
    pairs = list(zip(e_axis, s_axis))
    return nearest_utopia_pick(caps, pairs, runtime_weight=runtime_weight)


def probe_grid(node) -> list[float]:
    """Deterministic candidate caps for a node: its hardware sweep
    clamped into [floor, ceil] when a spec is attached, else four evenly
    spaced points above the floor (controller-facing test doubles)."""
    lo, hi = node.floor_w, node.ceil_w
    spec = getattr(node, "spec", None)
    if spec is not None:
        caps = [float(c) for c in spec.cap_sweep() if lo <= c <= hi]
        if caps:
            return caps
    if hi <= lo:
        return [lo]
    return [lo + (hi - lo) * k / 4.0 for k in (1, 2, 3, 4)]


def modeled_cost_per_token(node, cap_w: float) -> "tuple[float, float] | None":
    """(s/token, J/token) of ``node`` at ``cap_w`` from its own model —
    the cold-start fallback while the fitted curve is not yet confident.
    Real ``FleetNode``s price a whole step through their live power
    session; controller-facing doubles may expose only a throughput
    curve (draw then assumed at the cap — conservative)."""
    job = getattr(node, "job", None)
    step_cost = getattr(node, "step_cost", None)
    if job is not None and step_cost is not None:
        s, e = step_cost(cap_w)
        tok = job.tokens_per_step()
        if s > 0 and tok > 0:
            return s / tok, e / tok
    thr = getattr(node, "throughput_at", None)
    if thr is not None:
        p = thr(cap_w)
        if p > 0:
            return 1.0 / p, cap_w / p
    return None


def fitted_cost_per_token(model: PowerCurveModel,
                          cap_w: float) -> "tuple[float, float] | None":
    """(s/token, J/token) at ``cap_w`` from a fitted curve pair; None when
    either prediction is unavailable or the fitted rate vanishes."""
    perf = model.predict_perf(cap_w)
    watts = model.predict_watts(cap_w)
    if perf is None or watts is None or perf <= 1e-9:
        return None
    return 1.0 / perf, watts / perf
