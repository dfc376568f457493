"""Fleet telemetry bus: per-node observations -> fleet-level counters.

Every ``FleetNode`` publishes one ``NodeSample`` per control quantum
(tokens emitted, modeled joules, busy seconds, cap-violation count) and
the controller publishes every grant allocation.  The bus keeps

  * a bounded tail of raw samples (debugging / tests), and
  * unbounded aggregate counters — the numbers ``BENCH_fleet.json``
    records and the controller's re-decide loop consumes.

Everything here is pure arithmetic on the samples it is fed: no wall
clock, no randomness — two identical cluster runs produce bit-identical
counters (asserted by ``tests/test_fleet.py``).

A copy of ``repro/fleet/telemetry.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NodeSample:
    """One node's activity over one control quantum (virtual time)."""

    t: float                 # quantum start, virtual seconds
    node: str
    cabinet: str
    job: str
    kind: str                # "train" | "serve"
    grant_w: float           # the cap ceiling the controller granted
    tokens: int              # tokens emitted this quantum
    energy_j: float          # modeled joules this quantum
    busy_s: float            # virtual seconds of job work this quantum
    steps: int               # job steps completed this quantum
    violations: int          # phases whose modeled draw exceeded the grant


class FleetTelemetry:
    """Aggregates ``NodeSample``s and controller grant events."""

    def __init__(self, history_limit: int = 4096):
        self.history_limit = history_limit
        self.samples: list[NodeSample] = []
        # -- unbounded aggregate counters ---------------------------------
        self.tokens = 0
        self.energy_j = 0.0
        self.busy_s = 0.0
        self.steps = 0
        self.violations = 0
        self.cap_grants = 0          # grant (re-)allocations issued
        self.preemptions = 0
        self.completions = 0
        # -- preemption economics: destroyed vs preserved work -------------
        self.dropped_tokens = 0      # in-flight work destroyed (redone)
        self.migrations = 0          # snapshot moved to a different node
        self.migrated_tokens = 0     # in-flight work preserved by drains
        self.migration_bytes = 0     # snapshot payload moved cross-node
        self.migration_s = 0.0       # virtual seconds spent transferring
        # -- proportional preemption: shed slot-by-slot, not job-by-job ----
        self.partial_drains = 0      # shed events (job kept its node)
        self.shed_slots = 0          # slots parked across all sheds
        self.parked_tokens = 0       # in-flight tokens parked at shed time
        self.unparked_slots = 0      # slots re-admitted as budget recovered
        # -- cross-job adoption: parked streams resumed under ANOTHER job --
        self.adoptions = 0           # adoption events
        self.adopted_slots = 0       # streams moved between jobs
        self.adopted_tokens = 0      # in-flight tokens those streams held
        self.adoption_bytes = 0      # snapshot payload moved for adoptions
        self.adoption_s = 0.0        # virtual transfer seconds charged
        # -- workload / power-gating (repro_torch.workload drives these) ------
        self.idle_energy_j = 0.0     # awake-idle hotel load accrued
        self.sleeps = 0              # nodes power-gated to deep sleep
        self.wakes = 0               # sleeping nodes powered back up
        self.queue_depth_peak = 0    # max fleet-wide queued requests seen
        self.queue_depth_last = 0    # queued requests at last sample
        # -- fault / recovery (repro_torch.fleet.faults drives these) ---------
        self.crashes = 0             # nodes killed by fault injection
        self.dead_declared = 0       # watchdog verdicts (deadline missed)
        self.checkpoints = 0         # shadow checkpoints taken
        self.checkpoint_bytes = 0    # shadow snapshot payload captured
        self.replayed_tokens = 0     # in-flight tokens restored from shadows
        self.lost_tokens = 0         # in-flight tokens a crash destroyed
        self.cap_retries = 0         # RetryingBackend retry attempts
        self.failed_cap_applies = 0  # applies that exhausted the budget
        self.degraded_quanta = 0     # node-quanta allocated in degraded mode
        self.corrupt_samples = 0     # NodeSamples rejected by validation
        self.dropped_samples = 0     # NodeSamples lost to telemetry dropout
        # -- learned power curves (repro_torch.fleet.pareto drives these) -----
        self.curve_samples = 0       # NodeSamples folded into curve fits
        self.curve_ready_nodes = 0   # nodes whose fit is confident (gauge)
        self.curve_confidence = 0.0  # mean fit confidence (gauge)
        self.explore_probes = 0      # off-curve exploration grants issued
        # per-SLO-class request counters (offered / rejected / completed /
        # met / goodput tokens), keyed by class name
        self.slo: dict[str, dict[str, int]] = {}
        # latest windowed burn-rate snapshot (repro_torch.obs.SLOBurnMonitor
        # rows mirrored by the workload driver each quantum)
        self.slo_burn: dict[str, dict[str, float]] = {}
        self.by_kind: dict[str, dict[str, float]] = {}

    # -- feeds -------------------------------------------------------------
    def record(self, s: NodeSample) -> None:
        # Corrupt telemetry must not poison the aggregates: a sample whose
        # counters are physically impossible is rejected (and counted) —
        # the degraded-mode controller handles the node it came from.
        if s.tokens < 0 or s.energy_j < 0 or s.busy_s < 0 or s.steps < 0:
            self.corrupt_samples += 1
            return
        self.samples.append(s)
        if len(self.samples) > self.history_limit:
            del self.samples[:len(self.samples) - self.history_limit]
        self.tokens += s.tokens
        self.energy_j += s.energy_j
        self.busy_s += s.busy_s
        self.steps += s.steps
        self.violations += s.violations
        k = self.by_kind.setdefault(
            s.kind, {"tokens": 0, "energy_j": 0.0, "busy_s": 0.0})
        k["tokens"] += s.tokens
        k["energy_j"] += s.energy_j
        k["busy_s"] += s.busy_s

    def record_grants(self, grants: dict[str, float]) -> None:
        self.cap_grants += len(grants)

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_drop(self, tokens: int) -> None:
        """In-flight work destroyed by a preemption (it will be redone
        and re-counted — the double-pay the migration path avoids)."""
        self.dropped_tokens += tokens

    def record_kept(self, tokens: int) -> None:
        """In-flight work preserved across a preemption by a portable
        snapshot (drained, not discarded)."""
        self.migrated_tokens += tokens

    def record_migration(self, nbytes: int, seconds: float) -> None:
        """A preserved snapshot resumed on a DIFFERENT node: ``nbytes``
        moved over the interconnect, ``seconds`` of virtual transfer
        time charged to the receiving node."""
        self.migrations += 1
        self.migration_bytes += nbytes
        self.migration_s += seconds

    def record_partial(self, slots: int, tokens: int) -> None:
        """A proportional preemption: ``slots`` lanes drained and parked
        locally (their ``tokens`` in-flight work preserved) while the
        job's survivors kept serving on the same node."""
        self.partial_drains += 1
        self.shed_slots += slots
        self.parked_tokens += tokens

    def record_unpark(self, slots: int) -> None:
        """Recovered headroom re-admitted ``slots`` parked lanes."""
        self.unparked_slots += slots

    def record_adoption(self, slots: int, tokens: int, nbytes: int,
                        seconds: float) -> None:
        """Parked in-flight streams resumed under a DIFFERENT serve job
        (cross-job adoption): ``slots`` streams carrying ``tokens``
        in-flight tokens moved ``nbytes`` over the interconnect."""
        self.adoptions += 1
        self.adopted_slots += slots
        self.adopted_tokens += tokens
        self.adoption_bytes += nbytes
        self.adoption_s += seconds

    def record_completion(self) -> None:
        self.completions += 1

    # -- workload / power-gating feeds -------------------------------------
    def record_idle(self, joules: float) -> None:
        """Hotel load the awake-idle node set burned this quantum."""
        self.idle_energy_j += joules

    def record_sleep(self) -> None:
        self.sleeps += 1

    def record_wake(self) -> None:
        self.wakes += 1

    def record_queue_depth(self, depth: int) -> None:
        """Fleet-wide queued (admitted, not-in-service) requests."""
        self.queue_depth_last = depth
        if depth > self.queue_depth_peak:
            self.queue_depth_peak = depth

    # -- fault / recovery feeds --------------------------------------------
    def record_crash(self) -> None:
        """Fault injection killed a node mid-quantum."""
        self.crashes += 1

    def record_dead(self, replayed: int, lost: int) -> None:
        """The watchdog declared a node dead and re-queued its job:
        ``replayed`` in-flight tokens came back from shadow checkpoints,
        ``lost`` (decoded after the last checkpoint) must be redone."""
        self.dead_declared += 1
        self.replayed_tokens += replayed
        self.lost_tokens += lost

    def record_checkpoint(self, nbytes: int) -> None:
        """One periodic shadow checkpoint of a job's warm slots."""
        self.checkpoints += 1
        self.checkpoint_bytes += nbytes

    def record_cap_retries(self, retries: int, failures: int) -> None:
        """Aggregate RetryingBackend counters harvested at run end."""
        self.cap_retries += retries
        self.failed_cap_applies += failures

    def record_degraded(self, nodes: int) -> None:
        """``nodes`` allocations pinned by degraded mode this quantum."""
        self.degraded_quanta += nodes

    def record_sample_dropped(self) -> None:
        """A NodeSample never arrived (telemetry dropout window)."""
        self.dropped_samples += 1

    def record_curve_state(self, samples: int, ready_nodes: int,
                           mean_confidence: float, probes: int) -> None:
        """Mirror the ``CurveBank``'s fit scoreboard (cumulative samples
        folded in, confident-node count, mean confidence) and the
        controller's cumulative exploration-probe count — gauges, set
        each quantum by the cluster in pareto mode."""
        self.curve_samples = samples
        self.curve_ready_nodes = ready_nodes
        self.curve_confidence = mean_confidence
        self.explore_probes = probes

    def _slo_cls(self, name: str) -> dict[str, int]:
        return self.slo.setdefault(name, {
            "offered": 0, "rejected": 0, "completed": 0, "met": 0,
            "goodput_tokens": 0})

    def record_slo_offer(self, name: str) -> None:
        self._slo_cls(name)["offered"] += 1

    def record_slo_reject(self, name: str) -> None:
        self._slo_cls(name)["rejected"] += 1

    def record_slo_completion(self, name: str, met: bool,
                              tokens: int) -> None:
        c = self._slo_cls(name)
        c["completed"] += 1
        if met:
            c["met"] += 1
            c["goodput_tokens"] += tokens

    def record_burn(self, snapshot: dict) -> None:
        """Mirror the burn monitor's latest windowed scoreboard (read-only
        observability — these rows never feed back into control here)."""
        self.slo_burn = {k: dict(v) for k, v in sorted(snapshot.items())}

    # -- fleet-level view --------------------------------------------------
    def counters(self, elapsed_s: float | None = None) -> dict:
        """The fleet scoreboard.  ``elapsed_s`` (virtual) turns totals into
        rates; joules-per-token is the paper's energy-efficiency axis
        lifted to the fleet."""
        out = {
            "tokens": self.tokens,
            "energy_j": self.energy_j,
            "busy_s": self.busy_s,
            "steps": self.steps,
            "violations": self.violations,
            "cap_grants": self.cap_grants,
            "preemptions": self.preemptions,
            "completions": self.completions,
            "dropped_tokens": self.dropped_tokens,
            "migrations": self.migrations,
            "migrated_tokens": self.migrated_tokens,
            "migration_bytes": self.migration_bytes,
            "migration_s": self.migration_s,
            "partial_drains": self.partial_drains,
            "shed_slots": self.shed_slots,
            "parked_tokens": self.parked_tokens,
            "unparked_slots": self.unparked_slots,
            "adoptions": self.adoptions,
            "adopted_slots": self.adopted_slots,
            "adopted_tokens": self.adopted_tokens,
            "adoption_bytes": self.adoption_bytes,
            "adoption_s": self.adoption_s,
            "idle_energy_j": self.idle_energy_j,
            "sleeps": self.sleeps,
            "wakes": self.wakes,
            "queue_depth_peak": self.queue_depth_peak,
            "queue_depth_last": self.queue_depth_last,
            "crashes": self.crashes,
            "dead_declared": self.dead_declared,
            "checkpoints": self.checkpoints,
            "checkpoint_bytes": self.checkpoint_bytes,
            "replayed_tokens": self.replayed_tokens,
            "lost_tokens": self.lost_tokens,
            "cap_retries": self.cap_retries,
            "failed_cap_applies": self.failed_cap_applies,
            "degraded_quanta": self.degraded_quanta,
            "corrupt_samples": self.corrupt_samples,
            "dropped_samples": self.dropped_samples,
            "curve_samples": self.curve_samples,
            "curve_ready_nodes": self.curve_ready_nodes,
            "curve_confidence": self.curve_confidence,
            "explore_probes": self.explore_probes,
            "j_per_token": (self.energy_j / self.tokens
                            if self.tokens else 0.0),
            "slo": {k: dict(v) for k, v in sorted(self.slo.items())},
            "slo_burn": {k: dict(v)
                         for k, v in sorted(self.slo_burn.items())},
            "by_kind": {k: dict(v) for k, v in sorted(self.by_kind.items())},
        }
        if elapsed_s is not None:
            out["virtual_s"] = elapsed_s
            out["tokens_per_s"] = (self.tokens / elapsed_s
                                   if elapsed_s > 0 else 0.0)
        return out
