"""The paper's decision metrics (section 3.2) over (task x cap) tables.

A copy of ``repro/core/metrics.py`` for the port.

  * speedup-energy-delay (SED)  — maximize; NVIDIA blog / EDP variant
        SED_n = (runtime_1 * energy_1) / (runtime_n * energy_n)
  * Euclidean distance of min-max-normalized (energy, runtime) (ED) — minimize;
    Global Criterion multi-objective method => argmin is Pareto-optimal.
  * GPS-UP (Greenup/Powerup/Speedup, ref [1]) — extension beyond the two paper
    metrics: categorizes each cap setting's effect.

All functions are pure over TaskTable so they apply equally to the modeled
LSMS-analogue sweep, to dry-run-derived model phases, or (on real hardware) to
measured tables loaded from JSON.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.tasks import TaskTable


# --------------------------------------------------------------------------
# speedup-energy-delay
# --------------------------------------------------------------------------

def speedup_energy_delay(table: TaskTable, task: str) -> dict[float, float]:
    """SED per cap, against the default-cap (highest) baseline. Higher=better."""
    rows = table.for_task(task)
    base = rows[-1]  # default = max cap (paper: 1000 W, no capping)
    out: dict[float, float] = {}
    for r in rows:
        denom = r.runtime * r.energy
        out[r.cap] = (base.runtime * base.energy) / denom if denom > 0 else math.inf
    return out


def sed_optimal_cap(table: TaskTable, task: str) -> float:
    """Cap maximizing SED; ties resolved toward the LOWER cap (energy-prudent)."""
    sed = speedup_energy_delay(table, task)
    best = max(sed.values())
    return min(c for c, v in sed.items() if v >= best * (1 - 1e-12))


# --------------------------------------------------------------------------
# Euclidean distance of normalized energy/runtime
# --------------------------------------------------------------------------

def _minmax(vals: list[float]) -> list[float]:
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return [0.0 for _ in vals]
    return [(v - lo) / (hi - lo) for v in vals]


def euclidean_distance(table: TaskTable, task: str) -> dict[float, float]:
    """ED per cap (paper section 3.2, second metric). Lower=better."""
    rows = table.for_task(task)
    n_e = _minmax([r.energy for r in rows])
    n_t = _minmax([r.runtime for r in rows])
    return {r.cap: math.sqrt(ne * ne + nt * nt)
            for r, ne, nt in zip(rows, n_e, n_t)}


def ed_optimal_cap(table: TaskTable, task: str) -> float:
    """Cap minimizing ED; ties toward the lower cap."""
    ed = euclidean_distance(table, task)
    best = min(ed.values())
    return min(c for c, v in ed.items() if v <= best + 1e-12)


def ed_argmin_is_pareto(table: TaskTable, task: str) -> bool:
    """Property from the Global Criterion method: the ED argmin is
    Pareto-optimal — no other cap strictly dominates it in (energy, runtime)."""
    pick = table.at(task, ed_optimal_cap(table, task))
    for r in table.for_task(task):
        if (r.energy < pick.energy - 1e-12 and r.runtime < pick.runtime - 1e-12):
            return False
    return True


# --------------------------------------------------------------------------
# GPS-UP (extension; Abdulsalam et al., paper ref [1])
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GpsUp:
    speedup: float   # t1/tn
    greenup: float   # E1/En
    powerup: float   # Pn/P1

    @property
    def category(self) -> str:
        """Coarse GPS-UP region: is the setting green and/or fast?"""
        fast = self.speedup >= 1.0
        green = self.greenup >= 1.0
        if fast and green:
            return "win-win"
        if green:
            return "green-but-slower"
        if fast:
            return "fast-but-hungrier"
        return "lose-lose"


def gps_up(table: TaskTable, task: str) -> dict[float, GpsUp]:
    rows = table.for_task(task)
    base = rows[-1]
    out: dict[float, GpsUp] = {}
    for r in rows:
        out[r.cap] = GpsUp(
            speedup=base.runtime / r.runtime if r.runtime > 0 else math.inf,
            greenup=base.energy / r.energy if r.energy > 0 else math.inf,
            powerup=(r.avg_power / base.avg_power) if base.avg_power > 0 else 0.0,
        )
    return out


# --------------------------------------------------------------------------
# Paper Table 2: per-task optimal caps + deltas vs default
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Table2Row:
    task: str
    sed_cap: float
    ed_cap: float
    sed_energy_reduction_pct: float
    ed_energy_reduction_pct: float
    sed_runtime_increase_pct: float
    ed_runtime_increase_pct: float


def table2(table: TaskTable) -> list[Table2Row]:
    rows = []
    for task in table.tasks():
        base = table.baseline(task)
        sc, ec = sed_optimal_cap(table, task), ed_optimal_cap(table, task)
        s, e = table.at(task, sc), table.at(task, ec)

        def dpct(new: float, old: float) -> float:
            return (new - old) / old * 100.0 if old > 0 else 0.0

        rows.append(Table2Row(
            task=task, sed_cap=sc, ed_cap=ec,
            sed_energy_reduction_pct=-dpct(s.energy, base.energy),
            ed_energy_reduction_pct=-dpct(e.energy, base.energy),
            sed_runtime_increase_pct=dpct(s.runtime, base.runtime),
            ed_runtime_increase_pct=dpct(e.runtime, base.runtime),
        ))
    return rows


def aggregate_table2(rows: list[Table2Row]) -> dict[str, float]:
    """The paper's simple per-task percentage sums ('ideal scenario'):
    ~151 % energy / ~90 % runtime for SED vs ~200 %/~203 % for ED on LSMS."""
    return {
        "sed_energy_savings_pct_sum": sum(r.sed_energy_reduction_pct for r in rows),
        "sed_runtime_increase_pct_sum": sum(r.sed_runtime_increase_pct for r in rows),
        "ed_energy_savings_pct_sum": sum(r.ed_energy_reduction_pct for r in rows),
        "ed_runtime_increase_pct_sum": sum(r.ed_runtime_increase_pct for r in rows),
    }


def weighted_application_impact(table: TaskTable) -> dict[str, float]:
    """Beyond-paper: time/energy-weighted whole-application deltas (the paper
    notes its sums are 'simple aggregations ... ideal scenarios'; this is the
    physically meaningful weighted version)."""
    out = {}
    for metric, pick in (("sed", sed_optimal_cap), ("ed", ed_optimal_cap)):
        base_e = base_t = new_e = new_t = 0.0
        for task in table.tasks():
            b = table.baseline(task)
            n = table.at(task, pick(table, task))
            base_e += b.energy
            base_t += b.runtime
            new_e += n.energy
            new_t += n.runtime
        out[f"{metric}_app_energy_reduction_pct"] = (base_e - new_e) / base_e * 100
        out[f"{metric}_app_runtime_increase_pct"] = (new_t - base_t) / base_t * 100
    return out
