"""``repro_torch.workload`` — million-user traffic simulation for the fleet.

The scenario engine the fleet benchmarks run against: deterministic,
seed-driven open-loop traffic (diurnal Poisson + bursts + heavy-tailed
lengths), per-request SLO classes with deadline/value tiers, and the
admission + autoscaling control loop that moves fleet capacity (slot
limits, node sleep/wake) to follow the load curve —

  arrivals.py   ArrivalEvent / DiurnalRate / Burst / LengthSampler /
                TrafficGenerator: seed -> bit-identical arrival trace
                (Lewis thinning from one numpy Generator)
  slo.py        SLOClass (interactive / standard / batch: deadline,
                per-token allowance, token value) + SLOTracker
                (order-independent per-class attainment and goodput)
  autoscale.py  AdmissionController (per-class outstanding bounds),
                Autoscaler (slot targets, park/hibernate idle jobs,
                wake sleeping nodes under pressure), WorkloadDriver
                (the per-quantum feed SimulatedCluster.run hooks)

Quick start::

    from repro_torch.fleet import ServeJob, SimulatedCluster
    from repro_torch.workload import (Autoscaler, AdmissionController,
                                SLOTracker, WorkloadDriver,
                                diurnal_trace)
    cluster = SimulatedCluster(n_nodes=4, idle_w=50.0)
    tracker = SLOTracker(sink=cluster.telemetry)
    driver = WorkloadDriver(diurnal_trace(seed=0, until_s=120.0,
                                          base_rps=6.0),
                            tracker, admission=AdmissionController(),
                            autoscaler=Autoscaler())
    jobs = [ServeJob(f"s{i}", cfg, batch=16, prompt=256, new_tokens=128,
                     total_requests=0, open_loop=True, partial=True,
                     slo=tracker)
            for i in range(4)]
    cluster.run(jobs=jobs, budget=900.0, until_s=120.0, workload=driver)
    print(tracker.summary())

``benchmarks/traffic_slo.py`` runs the headline scenario (autoscaled vs
static fleet under the same trace); ``docs/workload.md`` documents the
generators, SLO classes and autoscaler knobs.

A copy of ``repro/workload/__init__.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from repro_torch.workload.arrivals import (ArrivalEvent, Burst, ClassMix,
                                     DiurnalRate, LengthSampler,
                                     TrafficGenerator)
from repro_torch.workload.autoscale import (AdmissionController, Autoscaler,
                                      WorkloadDriver)
from repro_torch.workload.slo import (BATCH, DEFAULT_CLASSES, INTERACTIVE,
                                SLOClass, SLOTracker, STANDARD,
                                class_by_name)

__all__ = [
    "ArrivalEvent", "Burst", "ClassMix", "DiurnalRate", "LengthSampler",
    "TrafficGenerator",
    "AdmissionController", "Autoscaler", "WorkloadDriver",
    "BATCH", "DEFAULT_CLASSES", "INTERACTIVE", "STANDARD",
    "SLOClass", "SLOTracker", "class_by_name",
    "diurnal_trace",
]


def diurnal_trace(seed: int, until_s: float, base_rps: float = 6.0,
                  amplitude: float = 0.6, period_s: float = 60.0,
                  bursts: tuple = ()) -> list:
    """The canonical diurnal+burst scenario: one full day/night cycle
    per ``period_s`` with a default mid-trace burst when none are
    given.  Shared by the launcher and ``benchmarks/traffic_slo.py`` so
    'the' trace means the same arrivals everywhere."""
    if not bursts:
        bursts = (Burst(t0=until_s * 0.55, duration_s=until_s * 0.1,
                        rps=base_rps * 1.5),)
    gen = TrafficGenerator(
        seed=seed,
        rate=DiurnalRate(base_rps=base_rps, amplitude=amplitude,
                         period_s=period_s, phase_s=period_s / 4.0),
        bursts=bursts)
    return gen.events(until_s)
