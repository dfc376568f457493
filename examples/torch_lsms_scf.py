"""The paper's LSMS study on the PyTorch port: the counterpart of
``examples/lsms_scf.py``.

  PYTHONPATH=src python examples/torch_lsms_scf.py              # the card
  PYTHONPATH=src python examples/torch_lsms_scf.py --device cpu --atoms 4

On the CPU (``--device cpu``) it does what the JAX example does: the real
(miniature) KKR/SCF math, then Table 1, Table 2, the aggregates, the
weighted impact and the PowerManager session line of the paper-calibrated
task mix on the modelled TPU superchip, the same lines as the JAX
example's.

On the card it runs ``LSMS_CARD`` (128 atoms, a LIZ of 113, lmax 3: a
1808 x 1808 complex64 matrix factored per atom and energy point) and
measures the paper's experiment there:

1. the SCF loop, with wall seconds and joules per iteration from NVML's
   energy counter;
2. Table 1 measured: each task timed alone at one energy point's shapes,
   repeated to fill windows of at least 2 s on the counter (it moves
   every ~100 ms), at the power limit in force; where the card grants
   limit writes, at every cap of the sweep, through the same code;
3. Table 2, Fig. 2 (SED) and Fig. 3 (ED) as text, from the modelled H100
   envelope (``hw/h100.py``) swept over the measured task mix
   (``measured_lsms_tasks``), and from the measured table where every
   cap was measured.

The power figures come from the card alone.  An H100 is not a GH200:
NVML caps the card, and the host shares no budget with it (it draws
nothing in ``H100_SUPERCHIP``), so the paper's CPU-GPU power steering has
no counterpart here.  There is no ``--plots``: the card's host has no
matplotlib.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from repro_torch.core import (TaskTable, aggregate_table2,
                              euclidean_distance, speedup_energy_delay,
                              table2, weighted_application_impact)
from repro_torch.models.lsms import (LSMS_CARD, LsmsConfig, make_positions,
                                     measure_table1, metered_scf,
                                     paper_calibrated_tasks, run_scf,
                                     task_calls)
from repro_torch.models.params import resolve_device
from repro_torch.power import PowerManager


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--atoms", type=int, default=None,
                    help="atoms (default 8 on the CPU, LSMS_CARD's 128 on "
                         "the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        card(args, device)
    else:
        modelled(args)


def modelled(args) -> None:
    """The JAX example's output: the miniature on the CPU, then the
    paper-calibrated mix on the modelled TPU superchip."""
    atoms = 8 if args.atoms is None else args.atoms
    t0 = time.perf_counter()
    density = run_scf(LsmsConfig(n_atoms=atoms),
                      torch.Generator().manual_seed(0), device="cpu")
    print(f"[scf] {atoms} atoms, 2 iterations, "
          f"{time.perf_counter()-t0:.1f}s, density[0:4]={density[:4]}")

    pm = PowerManager(tasks=paper_calibrated_tasks(), metric="sed")
    table = pm.table
    print("\n== Table 1: per-task profile at default power (no capping) ==")
    print(f"{'task':18s} {'time(s)':>8s} {'energy(J)':>10s} {'power(W)':>9s}")
    for r in table.table1():
        print(f"{r['task']:18s} {r['total_time_s']:8.2f} "
              f"{r['total_energy_j']:10.1f} {r['avg_power_w']:9.1f}")
    print_table2(table, "optimal caps per metric vs default")
    e = pm.account_step()
    print(f"\nPowerManager session (SED schedule, dwell-filtered): "
          f"{e['energy_j']:.0f}J per pass "
          f"(-{e['energy_saving_pct']:.1f}% vs uncapped, "
          f"{e['transitions']} cap writes)")


def print_table2(table: TaskTable, title: str) -> None:
    """Table 2, the aggregates and the weighted impact, as the JAX example
    prints them."""
    print(f"\n== Table 2: {title} ==")
    print(f"{'task':18s} {'SED(W)':>7s} {'ED(W)':>7s} "
          f"{'SED dE%':>8s} {'ED dE%':>8s} {'SED dt%':>8s} {'ED dt%':>8s}")
    rows = table2(table)
    for r in rows:
        print(f"{r.task:18s} {r.sed_cap:7.0f} {r.ed_cap:7.0f} "
              f"{r.sed_energy_reduction_pct:8.2f} "
              f"{r.ed_energy_reduction_pct:8.2f} "
              f"{r.sed_runtime_increase_pct:8.2f} "
              f"{r.ed_runtime_increase_pct:8.2f}")
    agg = aggregate_table2(rows)
    print(f"\naggregated (paper's 'ideal scenario' sums): "
          f"SED {agg['sed_energy_savings_pct_sum']:.0f}% energy / "
          f"{agg['sed_runtime_increase_pct_sum']:.0f}% runtime; "
          f"ED {agg['ed_energy_savings_pct_sum']:.0f}% / "
          f"{agg['ed_runtime_increase_pct_sum']:.0f}%")
    w = weighted_application_impact(table)
    print(f"weighted whole-app: SED -{w['sed_app_energy_reduction_pct']:.1f}% "
          f"energy @ +{w['sed_app_runtime_increase_pct']:.1f}% runtime; "
          f"ED -{w['ed_app_energy_reduction_pct']:.1f}% @ "
          f"+{w['ed_app_runtime_increase_pct']:.1f}%")


def print_curves(table: TaskTable) -> None:
    """Fig. 2 (SED per cap, higher is better) and Fig. 3 (ED, lower is
    better) as text: one row per task."""
    caps = table.caps()
    for fig, fn in (("Fig. 2: SED per cap (higher is better)",
                     speedup_energy_delay),
                    ("Fig. 3: ED per cap (lower is better)",
                     euclidean_distance)):
        print(f"\n== {fig} ==")
        print(f"{'task':18s} " + " ".join(f"{c:>7.0f}" for c in caps))
        for t in table.tasks():
            curve = fn(table, t)
            print(f"{t:18s} " + " ".join(f"{curve[c]:7.3f}" for c in caps))


def card(args, device) -> None:
    """``LSMS_CARD`` on the card, measured (see the module's docstring),
    through the same functions as ``chip_smoke.py``'s ``[lsms:*]``
    phases (``metered_scf``, ``measure_table1``)."""
    from repro_torch.power.metered import WINDOW_S
    from repro_torch.power.nvml import open_card
    cfg = LSMS_CARD if args.atoms is None else dataclasses.replace(
        LSMS_CARD, n_atoms=args.atoms, liz=min(LSMS_CARD.liz, args.atoms))
    with contextlib.ExitStack() as stack:
        power = open_card(stack, device.index or 0)
        spec, limit = power.spec, power.limit_w
        name = torch.cuda.get_device_name(device)
        print(f"[device] {name}, limit {limit:.2f} W (range "
              f"{spec.limit_min:.0f}-{spec.limit_max:.0f} W); limit writes "
              + ("granted: every cap of the sweep is measured"
                 if power.writable else
                 f"refused ({power.probe.code}): measured at the "
                 f"{limit:.2f} W limit in force only"))
        gen = torch.Generator(device=device).manual_seed(0)
        positions = make_positions(cfg, gen, device)
        # one untimed call of each task: the libraries' first-call costs
        # (MAGMA's and cuBLAS's set-up) stay out of the first iteration
        for fn in task_calls(cfg, positions).values():
            fn()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

        density, iters = metered_scf(power.nvml, cfg, positions)
        for i, it in enumerate(iters):
            print(f"[scf] iteration {i}: {it['seconds']:.3f} s, "
                  f"{it['joules']:.1f} J "
                  f"({it['joules'] / it['seconds']:.1f} W)")
        print(f"[scf] {cfg.n_atoms} atoms, LIZ {cfg.liz}, nb {cfg.nb}, "
              f"{cfg.e_points} energy points, {cfg.scf_iters} iterations; "
              f"peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
              f"GiB; density sum {float(density.sum()):.6f}, "
              f"density[0:4]={density[:4].tolist()}")

        measured = measure_table1(power, cfg, positions)
        print(f"\n== Table 1, measured on {name} at {limit:.2f} W: per "
              f"task, one energy point's call timed alone over >= "
              f"{WINDOW_S:.0f} s windows ==")
        print(f"{'task':18s} {'ms/call':>9s} {'bound ms':>9s} {'calls':>6s} "
              f"{'time(s)':>8s} {'energy(J)':>10s} {'power(W)':>9s}")
        for task, r in measured["rows"].items():
            print(f"{task:18s} {r['s_per_call'] * 1e3:9.3f} "
                  f"{r['bound_s'] * 1e3:9.3f} {r['calls']:6d} "
                  f"{r['run_s']:8.3f} {r['run_j']:10.2f} "
                  f"{r['mean_w']:9.1f}")

        pm = PowerManager(tasks=measured["tasks"], metric="sed", spec=spec)
        model = pm.table
        print_table2(model, "modelled H100 envelope, measured task mix")
        print_curves(model)
        if power.writable:
            table = TaskTable(measured["measurements"])
            print_table2(table, "measured at every cap of the sweep")
            print_curves(table)
        e = pm.account_step()
        print(f"\nPowerManager session on the model (SED schedule, "
              f"dwell-filtered): {e['energy_j']:.0f}J per run "
              f"(-{e['energy_saving_pct']:.1f}% vs uncapped, "
              f"{e['transitions']} cap writes)")

if __name__ == "__main__":
    main()
