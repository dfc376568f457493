"""``repro_torch.fleet`` — fleet-scale power orchestration.

The layer above ``repro_torch.power``: where a ``PowerManager`` steers one
superchip's per-phase caps, the fleet steers one FACILITY budget across a
simulated multi-node, multi-job cluster —

  cluster.py     SimulatedCluster / FleetNode / VirtualClock / BudgetTrace:
                 N nodes, each owning a real PowerManager + SimulatedBackend,
                 stepped on a shared virtual clock (deterministic)
  controller.py  FleetPowerController: hierarchical facility -> cabinet ->
                 node -> phase budget arbitration, redistributing watts by
                 each node's reported marginal-perf-per-watt sensitivity
                 (built on repro_torch.power.weighted_split)
  scheduler.py   Job protocol + TrainJob / ServeJob + FleetScheduler:
                 power-aware placement, value-ordered preemption (cheapest
                 token shed first), backoff-gated resume via
                 StepwiseSupervisor, and lossless serve migration — a
                 preempted ServeJob drains its engine into portable
                 SlotSnapshots and restores them on whichever node it
                 resumes on (cross-node transfers charged on the clock)
  pareto.py      PowerCurveModel / CurveBank + pareto_cap: per-node
                 perf-vs-cap and watts-vs-cap curves fitted online from
                 NodeSamples (EWMA least squares over the sweet-spot
                 family, confidence-gated), steering each node to its
                 normalized ED Pareto point under the same budget
                 hierarchy (``policy="pareto"``), with a grant-level
                 exploration budget probing off-curve caps so
                 mis-modeled nodes recover
  telemetry.py   FleetTelemetry: per-node samples -> fleet counters
                 (tokens, joules, grants, violations, migrated vs dropped
                 tokens, SLO / queue / power-gating / fault-recovery
                 counters) for the re-decide loop and BENCH_fleet.json
  faults.py      FaultInjector / FaultEvent / chaos_schedule: seed-driven
                 deterministic fault injection (crashes, hangs, stuck or
                 flaky cap writes, telemetry dropout/corruption,
                 stragglers) plus the recovery machinery the cluster
                 wires up — watchdog fencing, periodic shadow slot
                 checkpoints, retrying cap backends, degraded-mode
                 grants (``docs/faults.md``)

One layer further up, ``repro_torch.workload`` drives this cluster open-loop:
``SimulatedCluster.run(..., workload=driver)`` feeds a seed-driven
arrival trace into ``ServeJob(open_loop=True)`` services and an
SLO-aware autoscaler parks idle jobs (``ServeJob.hibernate``), sleeps
their nodes (``FleetNode.sleep``/``wake``, ``idle_w`` hotel load) and
wakes them back under queue pressure; parked in-flight streams can be
adopted by another same-config serve job (scheduler tick step 2c).

Quick start::

    from repro_torch.fleet import SimulatedCluster, TrainJob, ServeJob
    cluster = SimulatedCluster(n_nodes=6, policy="sensitivity")
    counters = cluster.run(
        jobs=[TrainJob("t0", cfg, batch=8, seq=512, total_steps=10_000),
              ServeJob("s0", cfg, batch=64, prompt=2048, new_tokens=256,
                       total_requests=100_000)],
        budget=[(0.0, 1980.0), (30.0, 1100.0)],   # shrinking facility cap
        until_s=60.0)
    print(counters["tokens_per_s"], counters["j_per_token"])

``benchmarks/fleet_power.py`` runs the headline scenario (sensitivity
steering vs static even split at equal budget); ``docs/fleet.md`` has the
hierarchy diagram and design notes.

A copy of ``repro/fleet/__init__.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from repro_torch.fleet.cluster import (BudgetTrace, FleetNode,
                                       SimulatedCluster, VirtualClock)
from repro_torch.fleet.controller import (FleetAllocation,
                                          FleetPowerController)
from repro_torch.fleet.faults import (FAULT_KINDS, FaultEvent, FaultInjector,
                                chaos_schedule)
from repro_torch.fleet.pareto import (CurveBank, GrantPoint, PowerCurveModel,
                                pareto_cap, probe_grid)
from repro_torch.fleet.scheduler import (FleetScheduler, Job, ServeJob,
                                         TrainJob)
from repro_torch.fleet.telemetry import FleetTelemetry, NodeSample

__all__ = [
    "BudgetTrace", "FleetNode", "SimulatedCluster", "VirtualClock",
    "FleetAllocation", "FleetPowerController",
    "FAULT_KINDS", "FaultEvent", "FaultInjector", "chaos_schedule",
    "CurveBank", "GrantPoint", "PowerCurveModel", "pareto_cap",
    "probe_grid",
    "FleetScheduler", "Job", "ServeJob", "TrainJob",
    "FleetTelemetry", "NodeSample",
]
