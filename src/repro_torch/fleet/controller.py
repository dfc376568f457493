"""Hierarchical fleet power arbitration: facility -> cabinet -> node -> phase.

The generalization (and runtime consumer) of ``PodPowerArbiter``: one
facility budget flows down a hierarchy

  facility          one envelope for the whole fleet (the ORNL-style
                    system cap, arXiv 2408.01552)
  cabinet           roll-up accounting + conservation boundary
  node (superchip)  a grant installed as ``PowerManager.set_grant`` —
                    the ceiling on every cap the node's session applies
  phase             the node's own CapSchedule picks per-phase caps
                    below the grant; host-vs-accelerator steering within
                    a phase happens in the power model (host draws first)

Allocation is the EcoShift-style performance-aware redistribution
(arXiv 2604.17635): every node reports its *sensitivity* — the marginal
tokens/s another watt buys, a finite difference over its modeled
throughput curve — and the controller water-fills the budget
(``repro_torch.power.weighted_split``), then refines with greedy
watt-transfers from the least-sensitive donor to the most-sensitive
recipient while a transfer still buys fleet throughput.  The starting
split dominates a static even split pointwise (equal-weight water-fill
grants every node at least ``min(budget/n, request)``), and transfers
only ever improve modeled fleet tokens/s, so sensitivity steering is
never worse than the even baseline it is benchmarked against.

Conservation is structural: each level's grants sum to at most its
parent's budget whenever the budget covers the floors (below the floors
the physics wins — idle draw can't be capped away); asserted per
allocation and property-tested in ``tests/test_fleet.py``.

A copy of ``repro/fleet/controller.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.fleet.pareto import (fitted_cost_per_token, GrantPoint,
                                modeled_cost_per_token, pareto_cap,
                                probe_grid)
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.power.arbiter import weighted_split

#: Watts moved per refinement transfer, and the cap on transfer rounds
#: (per node) — bounds controller work per re-decide.
TRANSFER_W = 8.0
TRANSFER_ROUNDS_PER_NODE = 8


@dataclasses.dataclass(frozen=True)
class FleetAllocation:
    """One re-decide's output: grants at every hierarchy level."""

    t: float
    facility_w: float
    cabinet_w: dict[str, float]
    node_w: dict[str, float]
    sensitivities: dict[str, float]
    cabinet_ceils: dict[str, float] = dataclasses.field(default_factory=dict)
    #: pareto mode only: each node's target cap (its ED Pareto point, or
    #: the probe cap on exploration quanta) before the budget water-fill
    pareto_w: dict[str, float] = dataclasses.field(default_factory=dict)

    def assert_conserved(self, floors: dict[str, float],
                         tol: float = 1e-6) -> None:
        """Sum(child grants) <= parent budget at every level — unless the
        budget is below the physical floors, where the floors win.  A
        cabinet with a busbar/cooling ceiling additionally holds its
        roll-up at or below that ceiling (again, floors excepted).

        The node set may SHRINK between decide and apply (a watchdog
        fences a dead node mid-quantum), so ``floors`` / ``cabinet_w``
        are consulted defensively: a grant for a node that vanished from
        the floors dict counts a zero floor, and a cabinet whose every
        node vanished is skipped rather than KeyError-ing the quantum."""
        flo = {k: floors.get(k, 0.0) for k in self.node_w}
        total = sum(self.node_w.values())
        if self.facility_w >= sum(flo.values()) - tol:
            assert total <= self.facility_w + tol, \
                (total, self.facility_w)
        roll, cab_floor = {}, {}
        for node, w in self.node_w.items():
            cab = node.split("/")[0]
            roll[cab] = roll.get(cab, 0.0) + w
            cab_floor[cab] = cab_floor.get(cab, 0.0) + flo[node]
        for cab, w in roll.items():
            if cab in self.cabinet_w:
                assert abs(self.cabinet_w[cab] - w) <= tol, (cab, w)
            if cab in self.cabinet_ceils:
                limit = max(self.cabinet_ceils[cab], cab_floor[cab])
                assert w <= limit + tol, (cab, w, limit)


class FleetPowerController:
    """Online re-decider for the fleet's budget split.

    ``policy``:
      * ``"even"``        static even split of the facility budget over
                          busy nodes (the naive baseline: no requests, no
                          sensitivities, headroom stranded on nodes that
                          can't use it)
      * ``"sensitivity"`` request-aware water-fill + marginal-perf-per-
                          watt transfer refinement (the scalar weighted-
                          throughput default)
      * ``"pareto"``      each node's request becomes its Euclidean-
                          distance Pareto-point cap over normalized
                          (J/token, s/token) — fitted curves from the
                          ``curves`` bank when confident, the modeled
                          curve as cold-start fallback — water-filled
                          under the same hierarchy; ``explore_budget``
                          grants per allocation are spent probing
                          off-curve caps so mis-modeled nodes recover
    """

    def __init__(self, policy: str = "sensitivity",
                 transfer_w: float = TRANSFER_W,
                 rounds_per_node: int = TRANSFER_ROUNDS_PER_NODE,
                 curves=None, explore_budget: float = 0.0):
        if policy not in ("even", "sensitivity", "pareto"):
            raise ValueError(f"unknown policy {policy!r}")
        self.policy = policy
        self.transfer_w = transfer_w
        self.rounds_per_node = rounds_per_node
        #: pareto mode: the fleet ``CurveBank`` (None = modeled curves only)
        self.curves = curves
        #: pareto mode: expected exploration probes per node per
        #: allocation (0.15 => each node probes every ~7th re-decide, the
        #: cadence ``PowerManager.explore_every`` uses on its own sweep)
        self.explore_budget = explore_budget
        self._explore_carry = 0.0
        self._probe_rr = 0                      # fleet round-robin cursor
        self._probe_idx: dict[str, int] = {}    # per-node sweep cursor
        self.explore_probes = 0
        self.tracer = NULL_TRACER    # the cluster wires a live Tracer in
        self.allocations = 0
        # degraded mode: last grant that was decided from TRUSTED telemetry,
        # per node — the hold value when a node's samples go stale
        self._last_good: dict[str, float] = {}
        self.degraded_allocations = 0

    # -- the re-decide entry point ----------------------------------------
    def redistribute(self, budget_w: float, nodes: list, t: float = 0.0,
                     cabinet_ceils: "dict[str, float] | None" = None,
                     health: "dict[str, str] | None" = None,
                     ) -> FleetAllocation:
        """Split ``budget_w`` across busy ``nodes`` (FleetNode-likes
        exposing name/cabinet/floor_w/ceil_w/request_w()/throughput_at(),
        optionally weighted_throughput_at() for token-value weighting).

        ``cabinet_ceils`` maps cabinets to busbar/cooling limits: when
        given, allocation runs through a middle ``weighted_split`` level
        (facility -> cabinet budgets -> node grants) and no cabinet's
        roll-up ever exceeds its ceiling — enforcement, not accounting.

        ``health`` marks nodes whose telemetry cannot be trusted this
        quantum (degraded mode): ``"stale"`` pins the node at its
        last-known-good grant (its requests/sensitivities are stale too),
        ``"corrupt"`` clamps it to its conservative floor — a node
        actively lying about its draw gets no discretionary watts.
        Pinned grants participate in the same water-fill with
        floor == ceil == pin, so conservation stays structural; when the
        budget cannot cover the pins plus everyone else's floors, the
        pins collapse to floors (physics wins, as everywhere)."""
        self.allocations += 1
        if not nodes:
            return FleetAllocation(t, budget_w, {}, {}, {})
        nodes = sorted(nodes, key=lambda n: n.name)
        floors = {n.name: n.floor_w for n in nodes}
        ceils = dict(cabinet_ceils) if cabinet_ceils else {}
        pinned: dict[str, float] = {}
        for n in nodes:
            mode = (health or {}).get(n.name)
            if mode is None:
                continue
            pin = self._last_good.get(n.name, n.floor_w) \
                if mode == "stale" else n.floor_w
            pinned[n.name] = min(max(pin, n.floor_w), n.ceil_w)
        if pinned:
            self.degraded_allocations += len(pinned)
            others = sum(w for k, w in floors.items() if k not in pinned)
            if sum(pinned.values()) + others > budget_w:
                pinned = {k: floors[k] for k in pinned}
        targets: dict[str, float] = {}
        if self.policy == "even":
            grants = self._even(budget_w, nodes, floors, ceils, pinned)
        elif self.policy == "pareto":
            grants, targets = self._pareto(budget_w, nodes, floors, ceils,
                                           pinned, t)
        else:
            grants = self._steer(budget_w, nodes, floors, ceils, pinned)
        cabinets: dict[str, float] = {}
        for n in nodes:
            cabinets[n.cabinet] = cabinets.get(n.cabinet, 0.0) \
                + grants[n.name]
        alloc = FleetAllocation(
            t=t, facility_w=budget_w, cabinet_w=cabinets, node_w=grants,
            sensitivities={n.name: n.sensitivity() for n in nodes}
            if self.policy == "sensitivity" else {},
            cabinet_ceils=ceils, pareto_w=targets)
        alloc.assert_conserved(floors)
        for k, g in grants.items():
            if k not in pinned:
                self._last_good[k] = g
        if self.tracer.enabled:
            self.tracer.instant(
                "redistribute", t, "fleet", cat="controller",
                args={"budget_w": budget_w, "nodes": len(nodes),
                      "degraded": len(pinned)})
            self.tracer.counter(
                "controller", t,
                dict(sorted(grants.items()), budget_w=budget_w))
        return alloc

    # -- the middle level: facility -> cabinet budgets ---------------------
    @staticmethod
    def _cabinet_budgets(budget_w: float, nodes: list,
                         floors: dict[str, float],
                         cab_ceils: dict[str, float],
                         node_req: dict[str, float],
                         ) -> tuple[dict[str, float], dict[str, list]]:
        """Water-fill the facility budget over cabinets: each cabinet
        requests the sum of its nodes' requests, floored at the sum of
        their physical floors and ceilinged at min(busbar/cooling limit,
        sum of hardware ceilings).  A ceiling below the floors cannot be
        met — the floors win, as everywhere else in the stack."""
        by_cab: dict[str, list] = {}
        for n in nodes:
            by_cab.setdefault(n.cabinet, []).append(n)
        cab_req = {c: sum(node_req[n.name] for n in ns)
                   for c, ns in by_cab.items()}
        cab_floor = {c: sum(floors[n.name] for n in ns)
                     for c, ns in by_cab.items()}
        cab_ceil = {c: min(cab_ceils.get(c, float("inf")),
                           sum(n.ceil_w for n in ns))
                    for c, ns in by_cab.items()}
        cab_ceil = {c: max(cab_ceil[c], cab_floor[c]) for c in cab_ceil}
        budgets = weighted_split(cab_req, budget_w, floor=cab_floor,
                                 ceil=cab_ceil,
                                 weights={c: 1.0 for c in cab_req})
        return budgets, by_cab

    # -- the even baseline -------------------------------------------------
    def _even(self, budget_w: float, nodes: list,
              floors: dict[str, float],
              cab_ceils: dict[str, float],
              pinned: "dict[str, float] | None" = None) -> dict[str, float]:
        """Static even split, blind to requests and sensitivities — but
        still conserving: an equal-weight water-fill against each node's
        HARDWARE ceiling only, so heterogeneous floors can't push the sum
        past the budget.  With cabinet ceilings the same split runs per
        cabinet inside the middle-level budgets.  Degraded-mode pins run
        through the same fill with floor == ceil == pin."""
        pinned = pinned or {}
        hw_ceil = {n.name: n.ceil_w for n in nodes}
        flo = dict(floors)
        for k, w in pinned.items():
            hw_ceil[k] = w
            flo[k] = w
        if not cab_ceils:
            return weighted_split(hw_ceil, budget_w, floor=flo,
                                  ceil=hw_ceil,
                                  weights={k: 1.0 for k in hw_ceil})
        budgets, by_cab = self._cabinet_budgets(budget_w, nodes, flo,
                                                cab_ceils, hw_ceil)
        grants: dict[str, float] = {}
        for cab in sorted(by_cab):
            ns = by_cab[cab]
            grants.update(weighted_split(
                {n.name: hw_ceil[n.name] for n in ns}, budgets[cab],
                floor={n.name: flo[n.name] for n in ns},
                ceil={n.name: hw_ceil[n.name] for n in ns},
                weights={n.name: 1.0 for n in ns}))
        return grants

    # -- sensitivity steering ---------------------------------------------
    def _steer(self, budget_w: float, nodes: list,
               floors: dict[str, float],
               cab_ceils: dict[str, float],
               pinned: "dict[str, float] | None" = None) -> dict[str, float]:
        pinned = pinned or {}
        by_name = {n.name: n for n in nodes}
        requests = {n.name: n.request_w() for n in nodes}
        ceils = {n.name: min(requests[n.name], n.ceil_w) for n in nodes}
        floors = dict(floors)
        for k, w in pinned.items():
            # untrusted telemetry: the pin replaces the node's (equally
            # untrusted) request, as an exact floor == ceil water-fill term
            requests[k] = w
            ceils[k] = w
            floors[k] = w
        if not cab_ceils:
            # equal-weight water-fill: every node gets at least
            # min(budget/n, request); slack from saturated (low-request)
            # nodes re-flows instead of stranding
            grants = weighted_split(requests, budget_w, floor=floors,
                                    ceil=ceils,
                                    weights={k: 1.0 for k in requests})
        else:
            # middle level first: cabinet budgets under their busbar
            # ceilings, then the same water-fill within each cabinet
            budgets, by_cab = self._cabinet_budgets(budget_w, nodes,
                                                    floors, cab_ceils,
                                                    requests)
            grants = {}
            for cab in sorted(by_cab):
                ns = by_cab[cab]
                grants.update(weighted_split(
                    {n.name: requests[n.name] for n in ns}, budgets[cab],
                    floor={n.name: floors[n.name] for n in ns},
                    ceil={n.name: ceils[n.name] for n in ns},
                    weights={n.name: 1.0 for n in ns}))

        # greedy marginal refinement: move transfer_w from the donor with
        # the smallest weighted-throughput loss to the recipient with the
        # largest gain while the move buys weighted fleet tokens/s (the
        # token-value objective: a serve token is worth its job's
        # ``value``, not 1).  Modeled throughput is monotone in the
        # grant, so every accepted move improves on the water-fill (and
        # hence on the even split).  With cabinet ceilings, a transfer
        # whose recipient cabinet is at its busbar limit is skipped —
        # watts only flow along links with headroom.
        dw = self.transfer_w
        cab_of = {n.name: n.cabinet for n in nodes}
        cab_total: dict[str, float] = {}
        for k, g in grants.items():
            cab_total[cab_of[k]] = cab_total.get(cab_of[k], 0.0) + g
        cab_floor: dict[str, float] = {}
        for k in grants:
            cab_floor[cab_of[k]] = cab_floor.get(cab_of[k], 0.0) + floors[k]

        def cab_headroom(cab: str) -> float:
            if cab not in cab_ceils:
                return float("inf")
            return max(cab_ceils[cab], cab_floor[cab]) - cab_total[cab]

        cache: dict[tuple[str, float], float] = {}

        def thr(name: str, g: float) -> float:
            key = (name, round(g, 6))
            if key not in cache:
                node = by_name[name]
                fn = getattr(node, "weighted_throughput_at", None)
                cache[key] = fn(g) if fn is not None \
                    else node.throughput_at(g)
            return cache[key]

        for _ in range(self.rounds_per_node * len(nodes)):
            best_gain, recipient = 0.0, None
            for k in sorted(grants):
                if k in pinned:
                    continue  # degraded: holds its pin, trades nothing
                g = grants[k]
                if g + dw <= ceils[k]:
                    gain = thr(k, g + dw) - thr(k, g)
                    if gain > best_gain + 1e-12:
                        best_gain, recipient = gain, k
            if recipient is None:
                break
            # a SAME-cabinet donor leaves the roll-up unchanged, so a
            # saturated busbar still allows rebalancing within the
            # cabinet; only a cross-cabinet move needs recipient-side
            # cabinet headroom
            rcab = cab_of[recipient]
            cross_ok = cab_headroom(rcab) >= dw
            best_loss, donor = float("inf"), None
            for k in sorted(grants):
                if k == recipient or k in pinned \
                        or grants[k] - dw < floors[k]:
                    continue
                if cab_of[k] != rcab and not cross_ok:
                    continue
                loss = thr(k, grants[k]) - thr(k, grants[k] - dw)
                if loss < best_loss - 1e-12:
                    best_loss, donor = loss, k
            if donor is None or best_gain <= best_loss + 1e-9:
                break
            grants[recipient] += dw
            grants[donor] -= dw
            cab_total[cab_of[recipient]] += dw
            cab_total[cab_of[donor]] -= dw
        return grants

    # -- Pareto steering (repro_torch.fleet.pareto) ---------------------------
    def _pareto_target(self, node) -> float:
        """The node's Euclidean-distance Pareto-point cap: candidate
        grants on its sweep scored by normalized (J/token, s/token)
        distance to the utopia point, the delay axis weighted by the
        job's token value (``edw``-style — a high-value latency-
        sensitive job penalizes delay harder and lands on a higher
        cap).  Fitted curves are used once the node's fit is confident;
        the modeled curve is the cold-start fallback."""
        lo = node.floor_w
        hi = min(node.request_w(), node.ceil_w) \
            if hasattr(node, "request_w") else node.ceil_w
        hi = max(hi, lo)
        model = None
        if self.curves is not None:
            m = self.curves.for_node(node.name)
            if m.ready:
                model = m
        value = float(getattr(node, "job_value", 1.0) or 0.0)
        weight = value if value > 0 else 1.0
        points = []
        for cap in probe_grid(node):
            cap = min(max(cap, lo), hi)
            cost = (fitted_cost_per_token(model, cap)
                    if model is not None else None)
            if cost is None:
                cost = modeled_cost_per_token(node, cap)
            if cost is None:
                continue
            points.append(GrantPoint(cap, cost[0], cost[1]))
        if not points:
            return hi
        # the grid may clamp duplicates onto hi/lo; dedupe keeping the
        # first occurrence so normalization sees each cap once
        seen, uniq = set(), []
        for p in points:
            if p.cap_w not in seen:
                seen.add(p.cap_w)
                uniq.append(p)
        if len(uniq) == 1:
            return uniq[0].cap_w
        return pareto_cap(uniq, runtime_weight=weight)

    def _explore(self, nodes: list, targets: dict[str, float],
                 pinned: dict) -> list[str]:
        """Spend the exploration budget: ``explore_budget * len(nodes)``
        accrues per allocation, and every whole probe earned retargets
        the next node (fleet round-robin) at the next cap on ITS sweep
        (per-node round-robin) instead of its Pareto point.  The probed
        grant produces an observation off the fitted curve, which is how
        a mis-modeled node gets corrected — the fleet-level analogue of
        ``PowerManager.next_cap``'s ``explore_every`` sweep."""
        if self.curves is None or self.explore_budget <= 0:
            return []
        explorable = [n for n in nodes if n.name not in pinned]
        if not explorable:
            return []
        self._explore_carry += self.explore_budget * len(explorable)
        probed = []
        while self._explore_carry >= 1.0 and len(probed) < len(explorable):
            self._explore_carry -= 1.0
            node = explorable[self._probe_rr % len(explorable)]
            self._probe_rr += 1
            if node.name in probed:
                continue
            grid = probe_grid(node)
            idx = self._probe_idx.get(node.name, 0)
            self._probe_idx[node.name] = idx + 1
            cap = grid[idx % len(grid)]
            targets[node.name] = min(max(cap, node.floor_w), node.ceil_w)
            probed.append(node.name)
            self.explore_probes += 1
        return probed

    def _pareto(self, budget_w: float, nodes: list,
                floors: dict[str, float],
                cab_ceils: dict[str, float],
                pinned: "dict[str, float] | None",
                t: float) -> tuple[dict[str, float], dict[str, float]]:
        """Pareto-point steering: each node's request AND ceiling is its
        target cap (nobody is granted watts past its own sweet spot —
        the budget saved is the policy's point), water-filled through
        the same facility -> cabinet -> node hierarchy as ``_steer``.
        Degraded-mode pins behave identically to the scalar modes:
        floor == ceil == pin."""
        pinned = pinned or {}
        floors = dict(floors)
        targets: dict[str, float] = {}
        for n in nodes:
            if n.name in pinned:
                continue
            targets[n.name] = self._pareto_target(n)
        probed = self._explore(nodes, targets, pinned)
        requests: dict[str, float] = {}
        ceils_n: dict[str, float] = {}
        for n in nodes:
            if n.name in pinned:
                w = pinned[n.name]
                requests[n.name] = ceils_n[n.name] = floors[n.name] = w
            else:
                w = min(max(targets[n.name], floors[n.name]), n.ceil_w)
                targets[n.name] = w
                requests[n.name] = ceils_n[n.name] = w
        if not cab_ceils:
            grants = weighted_split(requests, budget_w, floor=floors,
                                    ceil=ceils_n,
                                    weights={k: 1.0 for k in requests})
        else:
            budgets, by_cab = self._cabinet_budgets(budget_w, nodes,
                                                    floors, cab_ceils,
                                                    requests)
            grants = {}
            for cab in sorted(by_cab):
                ns = by_cab[cab]
                grants.update(weighted_split(
                    {n.name: requests[n.name] for n in ns}, budgets[cab],
                    floor={n.name: floors[n.name] for n in ns},
                    ceil={n.name: ceils_n[n.name] for n in ns},
                    weights={n.name: 1.0 for n in ns}))
        if self.tracer.enabled:
            conf = (self.curves.confidences()
                    if self.curves is not None else {})
            self.tracer.instant(
                "pareto_decide", t, "fleet", cat="controller",
                args={"nodes": len(nodes), "probes": len(probed),
                      "ready": (self.curves.ready_count()
                                if self.curves is not None else 0),
                      "targets": dict(sorted(targets.items()))})
            if conf:
                self.tracer.counter("curve_confidence", t, conf)
        return grants, targets
