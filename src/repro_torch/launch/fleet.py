"""Fleet launcher: a simulated multi-node cluster under one facility cap.

  PYTHONPATH=src python -m repro_torch.launch.fleet --nodes 6 \
      --policy sensitivity --budget-frac 0.85,0.60,0.45 --duration 60

Builds a mixed train+serve job queue (the same phase segmentations
``launch/train.py`` and ``launch/serve.py`` cap), places it with the
power-aware ``FleetScheduler``, and steers the facility budget with the
hierarchical ``FleetPowerController``.  Prints the fleet scoreboard and
the final grant allocation.

``--workload diurnal`` switches the fleet to open-loop serving: every
node runs an open-loop ``ServeJob`` fed by the seed-driven diurnal
arrival trace from ``repro_torch.workload`` (``--workload-seed`` replays
bit-identically), with per-class SLO accounting; add ``--autoscale``
for admission control plus the power-gating autoscaler (slot targets,
node park/sleep/wake; ``--idle-w``/``--wake-s`` set the hotel load and
wake latency).  Prints the per-class SLO scoreboard after the run.

``--chaos-seed N`` injects a deterministic fault schedule (crashes,
hangs, stuck/flaky cap writes, telemetry dropout/corruption, a
straggler — ``docs/faults.md``); pair it with ``--watchdog-s`` to
fence dead nodes and ``--ckpt-s`` for periodic shadow slot
checkpoints that bound crash loss to one interval.

``--trace-out PATH`` records the whole run on the ``repro_torch.obs`` span
ledger and writes a Perfetto/Chrome trace_event JSON (open it at
ui.perfetto.dev); ``--metrics-out PATH`` streams the per-quantum
counter snapshots as JSONL.  Same seed, same flags -> byte-identical
files (``docs/observability.md``).  Under ``--workload diurnal`` the
SLO scoreboard adds a per-class burn-rate column (error rate over the
trailing window relative to the class error budget; >1 means the
budget is burning) from the ``SLOBurnMonitor`` the autoscaler also
reads.

A copy of ``repro/launch/fleet.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import argparse

from repro_torch.configs.registry import ARCH_IDS, get_model_config
from repro_torch.fleet import ServeJob, SimulatedCluster, TrainJob
from repro_torch.hw.tpu import DEFAULT_SUPERCHIP
from repro_torch.power import available_metrics


def default_jobs(arch: str, n: int, serve_value: float = 1.0,
                 migrate: bool = True, partial: bool = False,
                 snapshot_int8: bool = False) -> list:
    """A heterogeneous queue: compute-bound training, decode-heavy
    serving (memory-bound) and prefill-heavy serving, round-robin."""
    cfg = get_model_config(arch)
    jobs = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            jobs.append(TrainJob(f"train-{i}", cfg, batch=8, seq=512,
                                 total_steps=10**9))
        elif kind == 1:
            jobs.append(ServeJob(f"serve-decode-{i}", cfg, batch=64,
                                 prompt=2048, new_tokens=512,
                                 total_requests=10**9, decode_chunk=32,
                                 value=serve_value, migrate=migrate,
                                 partial=partial,
                                 snapshot_int8=snapshot_int8))
        else:
            jobs.append(ServeJob(f"serve-prefill-{i}", cfg, batch=16,
                                 prompt=8192, new_tokens=32,
                                 total_requests=10**9, decode_chunk=32,
                                 value=serve_value, migrate=migrate,
                                 partial=partial,
                                 snapshot_int8=snapshot_int8))
    return jobs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--nodes", type=int, default=6)
    ap.add_argument("--cabinet-size", type=int, default=3)
    ap.add_argument("--jobs", type=int, default=None,
                    help="queue length (default: one per node)")
    ap.add_argument("--policy", default="sensitivity",
                    choices=("even", "sensitivity", "pareto"))
    ap.add_argument("--pareto", action="store_true",
                    help="shorthand for --policy pareto: steer each node "
                         "to its learned-curve ED Pareto point")
    ap.add_argument("--explore-budget", type=float, default=0.1,
                    help="pareto exploration rate: expected off-curve "
                         "probe grants per node per quantum (0 disables "
                         "probing; only used by --policy pareto)")
    ap.add_argument("--power-metric", default="sed",
                    choices=available_metrics())
    ap.add_argument("--budget-frac", default="0.85,0.60,0.45",
                    help="facility budget as fractions of N x p_max, one "
                         "leg per equal share of --duration (shrinking cap)")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="virtual seconds to simulate")
    ap.add_argument("--quantum", type=float, default=1.0,
                    help="control quantum (virtual s) between re-decides")
    ap.add_argument("--serve-value", type=float, default=1.0,
                    help="token value of serve jobs in the fleet objective "
                         "and preemption order (train jobs stay at 1.0)")
    ap.add_argument("--no-migrate", action="store_true",
                    help="drop-and-restart preempted serve jobs instead of "
                         "draining/restoring their slot snapshots")
    ap.add_argument("--partial", action="store_true",
                    help="proportional preemption: serve jobs shed only "
                         "the slots a shrinking envelope strands (parked "
                         "locally, re-admitted as the budget recovers) "
                         "instead of suspending whole")
    ap.add_argument("--snapshot-int8", action="store_true",
                    help="int8-compress snapshot payloads at rest "
                         "(roughly halves migration bytes/seconds at a "
                         "bounded parity cost)")
    ap.add_argument("--cabinet-ceil", type=float, default=None,
                    help="busbar/cooling ceiling per cabinet (watts), "
                         "enforced as a middle weighted_split level")
    ap.add_argument("--cross-cabinet-bw", type=float, default=None,
                    help="cross-cabinet link bandwidth (B/s) for snapshot "
                         "transfers (default: ICI/4); placement affinity "
                         "prefers origin, then the cheapest link")
    ap.add_argument("--workload", default=None, choices=("diurnal",),
                    help="drive open-loop serve jobs from a seed-driven "
                         "arrival trace with SLO accounting instead of the "
                         "closed-loop default queue")
    ap.add_argument("--workload-seed", type=int, default=0,
                    help="trace seed (same seed -> bit-identical replay)")
    ap.add_argument("--base-rps", type=float, default=5.0,
                    help="diurnal base arrival rate (requests/s)")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable admission control + the power-gating "
                         "autoscaler (slot targets, node park/sleep/wake)")
    ap.add_argument("--idle-w", type=float, default=None,
                    help="awake-idle hotel load per node in watts "
                         "(default: superchip power floor under --workload, "
                         "0 otherwise)")
    ap.add_argument("--wake-s", type=float, default=2.0,
                    help="virtual seconds a slept node needs to wake")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject a seed-driven fault schedule (crashes, "
                         "hangs, cap faults, telemetry faults, a "
                         "straggler); same seed -> bit-identical replay")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="heartbeat deadline (virtual s) after which a "
                         "silent busy node is declared dead and its job "
                         "re-queued")
    ap.add_argument("--ckpt-s", type=float, default=None,
                    help="shadow slot-checkpoint cadence (virtual s): a "
                         "crash loses at most this much decode")
    ap.add_argument("--repair-s", type=float, default=15.0,
                    help="virtual seconds a crashed node takes to repair "
                         "once fenced")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto/Chrome trace_event JSON of the "
                         "run to this path (ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None,
                    help="write per-quantum counter snapshots to this "
                         "path as JSONL")
    args = ap.parse_args()
    if args.pareto:
        args.policy = "pareto"

    p_max = args.nodes * DEFAULT_SUPERCHIP.p_max
    fracs = [float(x) for x in args.budget_frac.split(",")]
    leg = args.duration / len(fracs)
    trace = [(i * leg, f * p_max) for i, f in enumerate(fracs)]

    idle_w = args.idle_w
    if idle_w is None:
        idle_w = DEFAULT_SUPERCHIP.p_floor if args.workload else 0.0
    injector = None
    if args.chaos_seed is not None:
        from repro_torch.fleet import FaultInjector, chaos_schedule
        names = [f"cab{i // args.cabinet_size}/n{i:02d}"
                 for i in range(args.nodes)]
        schedule = chaos_schedule(args.chaos_seed, names, args.duration,
                                  repair_s=args.repair_s)
        injector = FaultInjector(schedule, repair_s=args.repair_s,
                                 seed=args.chaos_seed)
    tracer = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    cluster = SimulatedCluster(
        n_nodes=args.nodes, cabinet_size=args.cabinet_size,
        metric=args.power_metric, policy=args.policy,
        quantum_s=args.quantum, cabinet_ceil_w=args.cabinet_ceil,
        cross_cabinet_bw=args.cross_cabinet_bw,
        idle_w=idle_w, wake_latency_s=args.wake_s,
        faults=injector, watchdog_deadline_s=args.watchdog_s,
        shadow_ckpt_s=args.ckpt_s, tracer=tracer,
        explore_budget=args.explore_budget)

    workload = None
    tracker = None
    monitor = None
    if args.workload == "diurnal":
        from repro_torch.obs import SLOBurnMonitor
        from repro_torch.workload import (AdmissionController, Autoscaler,
                                    SLOTracker, WorkloadDriver,
                                    diurnal_trace)
        cfg = get_model_config(args.arch)
        monitor = SLOBurnMonitor()
        tracker = SLOTracker(sink=cluster.telemetry, monitor=monitor)
        events = diurnal_trace(seed=args.workload_seed,
                               until_s=args.duration,
                               base_rps=args.base_rps)
        workload = WorkloadDriver(
            events, tracker,
            admission=AdmissionController() if args.autoscale else None,
            autoscaler=Autoscaler(slo_monitor=monitor)
            if args.autoscale else None)
        jobs = [ServeJob(f"svc-{i}", cfg, batch=8, prompt=256,
                         new_tokens=64, total_requests=0, decode_chunk=8,
                         open_loop=True, partial=True,
                         migrate=not args.no_migrate,
                         value=args.serve_value, slo=tracker,
                         snapshot_int8=args.snapshot_int8)
                for i in range(args.jobs
                               if args.jobs is not None else args.nodes)]
    else:
        jobs = default_jobs(args.arch, args.jobs
                            if args.jobs is not None else args.nodes,
                            serve_value=args.serve_value,
                            migrate=not args.no_migrate,
                            partial=args.partial,
                            snapshot_int8=args.snapshot_int8)
    print(f"[fleet] {args.nodes} nodes / {args.policy} steering; budget "
          f"{' -> '.join(f'{w:.0f}W' for _, w in trace)} over "
          f"{args.duration:.0f}s")
    if workload is not None:
        print(f"[workload] diurnal trace: {len(events)} arrivals, "
              f"seed {args.workload_seed}, base {args.base_rps:.1f} rps, "
              f"autoscale={'on' if args.autoscale else 'off'}, "
              f"idle {idle_w:.0f}W/node")
    counters = cluster.run(jobs=jobs, budget=trace, until_s=args.duration,
                           workload=workload)

    print(f"[fleet] {counters['tokens']} tokens in "
          f"{counters['virtual_s']:.0f}s virtual "
          f"({counters['tokens_per_s']:.0f} tok/s, "
          f"{counters['j_per_token'] * 1e3:.2f} mJ/token)")
    print(f"[fleet] {counters['cap_grants']} grants, "
          f"{counters['preemptions']} preemptions, "
          f"{counters['violations']} cap violations")
    if counters["preemptions"]:
        print(f"[preempt] {counters['migrated_tokens']} tokens migrated / "
              f"{counters['dropped_tokens']} dropped; "
              f"{counters['migrations']} cross-node transfers "
              f"({counters['migration_bytes'] / 1e6:.1f} MB, "
              f"{counters['migration_s'] * 1e3:.1f} ms on the wire)")
    if counters["partial_drains"]:
        print(f"[partial] {counters['partial_drains']} proportional sheds: "
              f"{counters['shed_slots']} slots parked "
              f"({counters['parked_tokens']} in-flight tokens preserved), "
              f"{counters['unparked_slots']} re-admitted on recovery")
    if injector is not None:
        print(f"[chaos] seed {args.chaos_seed}: "
              f"{len(injector.delivered)} faults delivered — "
              f"{counters['crashes']} crashes "
              f"({counters['dead_declared']} fenced by the watchdog), "
              f"{counters['cap_retries']} cap retries / "
              f"{counters['failed_cap_applies']} gave up, "
              f"{counters['degraded_quanta']} degraded node-quanta, "
              f"{counters['dropped_samples']} stale / "
              f"{counters['corrupt_samples']} corrupt samples")
        if counters["checkpoints"]:
            print(f"[chaos] {counters['checkpoints']} shadow checkpoints "
                  f"({counters['checkpoint_bytes'] / 1e6:.1f} MB): "
                  f"{counters['replayed_tokens']} tokens replayed, "
                  f"{counters['lost_tokens']} lost to crashes")
    if cluster.curves is not None:
        print(f"[pareto] {counters['curve_samples']} curve samples, "
              f"{counters['curve_ready_nodes']}/{args.nodes} nodes "
              f"curve-ready (mean confidence "
              f"{counters['curve_confidence']:.2f}), "
              f"{counters['explore_probes']} exploration probes "
              f"(budget {args.explore_budget:.2f}/node/quantum)")
        conf = cluster.curves.confidences()
        if conf:
            print("[curves] " + ", ".join(
                f"{name}={c:.2f}" for name, c in sorted(conf.items())))
    if counters["adoptions"]:
        print(f"[adopt] {counters['adoptions']} cross-job adoptions: "
              f"{counters['adopted_slots']} streams "
              f"({counters['adopted_tokens']} in-flight tokens) moved "
              f"{counters['adoption_bytes'] / 1e6:.1f} MB")
    if tracker is not None:
        print(f"[workload] goodput {tracker.goodput_tokens()} tokens; "
              f"idle {counters['idle_energy_j']:.0f} J, "
              f"{counters['sleeps']} sleeps / {counters['wakes']} wakes, "
              f"queue peak {counters['queue_depth_peak']}")
        burn = monitor.snapshot() if monitor is not None else {}
        for name, s in sorted(tracker.summary().items()):
            b = burn.get(name)
            burn_col = (f", burn {b['burn']:.2f}x"
                        f"{' BURNING' if b['burn'] > 1.0 else ''}"
                        if b is not None else "")
            print(f"[slo:{name}] attainment {s['attainment']:.3f} "
                  f"({s['met']}/{s['completed']} met, "
                  f"{s['rejected']} rejected), "
                  f"p50 {s['p50_latency_s']:.2f}s / "
                  f"p99 {s['p99_latency_s']:.2f}s, "
                  f"goodput {s['goodput_tokens']} tokens{burn_col}")
    if cluster.allocations:
        last = cluster.allocations[-1]
        print("[grants] " + ", ".join(
            f"{k}={v:.0f}W" for k, v in sorted(last.node_w.items())))
        print("[cabinets] " + ", ".join(
            f"{k}={v:.0f}W" for k, v in sorted(last.cabinet_w.items())))
    if tracer is not None:
        from repro_torch.obs import (EnergyLedger, dump_chrome_trace,
                               dump_metrics_jsonl)
        ledger = EnergyLedger(tracer)
        ledger.assert_conserved(counters["energy_j"])
        if args.trace_out:
            dump_chrome_trace(tracer, args.trace_out,
                              process_name="repro-fleet")
            print(f"[obs] trace: {len(tracer.spans)} spans / "
                  f"{len(tracer.instants)} instants -> {args.trace_out}")
        if args.metrics_out:
            dump_metrics_jsonl(tracer, args.metrics_out)
            print(f"[obs] metrics: {len(tracer.counters)} snapshots -> "
                  f"{args.metrics_out}")
        s = ledger.summary()
        n_nodes = sum(len(nodes) for nodes in ledger.rollup.values())
        err = abs(ledger.conservation_error(counters["energy_j"]))
        print(f"[obs] energy attribution: {s['attributed_j']:.0f} J over "
              f"{n_nodes} tracks (transitions {s['transition_j']:.1f} J, "
              f"lost samples {s['lost_j']:.1f} J) — conserved vs "
              f"telemetry to {err:.2e} J")


if __name__ == "__main__":
    main()
