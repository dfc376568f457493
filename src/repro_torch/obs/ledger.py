"""Energy-attribution ledger: joules and seconds joined onto the span tree.

The fleet's phase spans (``cat="phase"``, emitted by
``FleetNode.run_quantum`` or ``PowerManager.phase``) carry the modeled
energy each capped region burned; cap-write instants carry the
transition price; ``sample_lost`` instants carry the energy of node
samples the telemetry faults destroyed before ``FleetTelemetry`` could
count them.  ``EnergyLedger`` reduces those events into

  * a facility -> cabinet -> node -> phase rollup (cap transitions
    attributed under the ``_transitions`` pseudo-phase), and
  * a CONSERVATION check against the existing counters: every joule a
    phase span claims either landed in ``FleetTelemetry.energy_j`` or
    is explained by a ``sample_lost`` instant — attribution can never
    invent or vanish energy relative to the counters the benchmarks
    gate on.

``request_costs`` is the serving-side decomposition: from an engine
trace (submit instants, per-request prefill spans, per-chunk decode
spans with their rider uids, restore instants) it prices each request's
queue-wait / prefill / decode / migration-transfer in both seconds and
joules — the per-task breakdown an EcoShift-style performance-aware
capping decision wants as input.

A copy of ``repro/obs/ledger.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.tracer import Tracer

__all__ = ["EnergyLedger", "RequestCost", "request_costs"]

#: Pseudo-phase that absorbs cap-transition energy in the rollup.
TRANSITION_PHASE = "_transitions"


def _cabinet_of(track: str) -> str:
    """Node tracks are named ``cabinet/node`` by the cluster; anything
    without the separator rolls up under itself."""
    return track.split("/")[0] if "/" in track else track


class EnergyLedger:
    """Reduce a tracer's phase spans + power instants into an energy
    rollup with a conservation check."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        # facility -> cabinet -> node -> phase -> {energy_j, seconds}
        self.rollup: dict[str, dict[str, dict[str, dict[str, float]]]] = {}
        self.attributed_j = 0.0      # everything the span tree claims
        self.lost_j = 0.0            # destroyed before telemetry saw it
        self.transition_j = 0.0
        self._reduce()

    def _bucket(self, node: str, phase: str) -> dict[str, float]:
        cab = _cabinet_of(node)
        return (self.rollup.setdefault(cab, {})
                .setdefault(node, {})
                .setdefault(phase, {"energy_j": 0.0, "seconds": 0.0}))

    def _reduce(self) -> None:
        for s in self.tracer.spans:
            if s.cat != "phase":
                continue
            e = float(s.args.get("energy_j", 0.0))
            b = self._bucket(s.track, s.name)
            b["energy_j"] += e
            b["seconds"] += s.duration_s
            self.attributed_j += e
        for ev in self.tracer.instants:
            if ev.name == "cap_write":
                e = float(ev.args.get("energy_j", 0.0))
                b = self._bucket(ev.track, TRANSITION_PHASE)
                b["energy_j"] += e
                b["seconds"] += float(ev.args.get("seconds", 0.0))
                self.attributed_j += e
                self.transition_j += e
            elif ev.name == "sample_lost":
                self.lost_j += float(ev.args.get("energy_j", 0.0))

    # -- views -------------------------------------------------------------
    def node_j(self, node: str) -> float:
        cab = _cabinet_of(node)
        phases = self.rollup.get(cab, {}).get(node, {})
        return sum(b["energy_j"] for b in phases.values())

    def cabinet_j(self, cabinet: str) -> float:
        return sum(sum(b["energy_j"] for b in phases.values())
                   for phases in self.rollup.get(cabinet, {}).values())

    def phase_j(self) -> dict[str, float]:
        """Fleet-wide joules per phase name (deterministic key order)."""
        out: dict[str, float] = {}
        for nodes in self.rollup.values():
            for phases in nodes.values():
                for name, b in phases.items():
                    out[name] = out.get(name, 0.0) + b["energy_j"]
        return dict(sorted(out.items()))

    def summary(self) -> dict:
        return {
            "attributed_j": self.attributed_j,
            "lost_j": self.lost_j,
            "transition_j": self.transition_j,
            "by_phase": self.phase_j(),
            "by_cabinet": {c: self.cabinet_j(c)
                           for c in sorted(self.rollup)},
        }

    # -- the conservation check --------------------------------------------
    def conservation_error(self, telemetry_energy_j: float) -> float:
        """Signed joules by which span attribution disagrees with the
        counter it must explain: attributed energy minus what telemetry
        faults destroyed must equal ``FleetTelemetry.energy_j``."""
        return self.attributed_j - self.lost_j - telemetry_energy_j

    def assert_conserved(self, telemetry_energy_j: float,
                         tol: float = 1e-6) -> None:
        err = self.conservation_error(telemetry_energy_j)
        scale = max(1.0, abs(telemetry_energy_j))
        assert abs(err) <= tol * scale, (
            f"energy attribution broke conservation: spans claim "
            f"{self.attributed_j:.6f} J ({self.lost_j:.6f} J lost to "
            f"telemetry faults) vs counters {telemetry_energy_j:.6f} J "
            f"(error {err:.3e} J)")


@dataclasses.dataclass
class RequestCost:
    """One request's serving cost, decomposed along its lifecycle."""

    uid: int
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    prefill_j: float = 0.0
    decode_s: float = 0.0
    decode_j: float = 0.0
    migration_s: float = 0.0
    migration_bytes: int = 0

    @property
    def total_j(self) -> float:
        return self.prefill_j + self.decode_j

    @property
    def total_s(self) -> float:
        return (self.queue_wait_s + self.prefill_s + self.decode_s
                + self.migration_s)


def request_costs(tracer: Tracer) -> dict[int, RequestCost]:
    """Per-request cost decomposition from an engine trace.

    Decode chunks serve many streams at once, so a chunk span's energy
    and duration are split evenly across the ``uids`` riding it — the
    per-slot cache independence that makes continuous batching correct
    also makes this attribution exact in modeled terms.
    """
    costs: dict[int, RequestCost] = {}

    def cost(uid: int) -> RequestCost:
        return costs.setdefault(uid, RequestCost(uid=uid))

    submitted: dict[int, float] = {}
    for ev in tracer.instants:
        if ev.name == "submit" and "uid" in ev.args:
            submitted.setdefault(int(ev.args["uid"]), ev.t)
        elif ev.name == "restore" and "uid" in ev.args:
            c = cost(int(ev.args["uid"]))
            c.migration_s += float(ev.args.get("seconds", 0.0))
            c.migration_bytes += int(ev.args.get("bytes", 0))

    for s in tracer.spans:
        if s.cat != "phase":
            continue
        if s.name == "prefill" and "uid" in s.args:
            uid = int(s.args["uid"])
            c = cost(uid)
            c.prefill_s += s.duration_s
            c.prefill_j += float(s.args.get("energy_j", 0.0))
            if uid in submitted:
                c.queue_wait_s = max(s.t0 - submitted.pop(uid), 0.0)
        elif s.name == "decode" and s.args.get("uids"):
            uids = list(s.args["uids"])
            share_j = float(s.args.get("energy_j", 0.0)) / len(uids)
            share_s = s.duration_s / len(uids)
            for uid in uids:
                c = cost(int(uid))
                c.decode_s += share_s
                c.decode_j += share_j
    return dict(sorted(costs.items()))
