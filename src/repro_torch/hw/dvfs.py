"""DVFS model: power cap -> sustainable clock fraction, per workload profile.

A copy of ``repro/hw/dvfs.py`` for the port.

The chip enforces a cap by reducing core clocks (paper section 2: "When GPU
power usage nears a power limit, the system reduces GPU clock speeds").  The
achievable clock depends on the *workload*: a compute-bound task pushes the
MXU duty cycle to 1 so its power at a given f is higher than a memory-bound
task's, hence it throttles earlier.  We model that self-consistently:

  given f:
    t_compute(f) = t_c1 / f               (MXU work scales with clock)
    bw(f)        = min(1, f / mem_f_knee) (HBM clocks down only under deep caps)
    t_mem(f)     = t_m1 / bw(f)
    t(f)         = max(t_compute(f), t_mem(f), t_coll)   (overlap model)
    mxu_duty(f)  = t_compute(f) / t(f)
    hbm_duty(f)  = t_mem(f) / t(f)
    P(f)         = p_static + p_compute_max * f^3 * mxu_duty(f)
                            + p_mem_max * bw(f) * hbm_duty(f)

  cap -> f: the largest f in [f_min, f_max] with P(f) <= cap (bisection; P is
  monotone increasing in f for any fixed task profile).  If even P(f_min)
  exceeds the cap the chip pins at f_min and the cap is simply not attained
  (firmware floor) — this is what produces the paper's pathological lowest-cap
  corner where both runtime AND energy get worse.
"""

from __future__ import annotations

import dataclasses

from repro_torch.hw.tpu import ChipSpec


@dataclasses.dataclass(frozen=True)
class WorkProfile:
    """Per-task ideal phase times at f=1 (seconds)."""

    t_compute: float      # FLOPs / peak_flops
    t_mem: float          # HBM bytes / hbm_bw
    t_coll: float = 0.0   # collective bytes / ici_bw
    mem_f_knee: float = 0.55

    def bw_factor(self, f: float) -> float:
        if self.mem_f_knee <= 0:
            return 1.0
        return min(1.0, f / self.mem_f_knee)

    def duration(self, f: float) -> float:
        comp = self.t_compute / f if self.t_compute > 0 else 0.0
        mem = self.t_mem / self.bw_factor(f) if self.t_mem > 0 else 0.0
        return max(comp, mem, self.t_coll, 1e-300)

    def mxu_duty(self, f: float) -> float:
        return (self.t_compute / f) / self.duration(f) if self.t_compute else 0.0

    def hbm_duty(self, f: float) -> float:
        if not self.t_mem:
            return 0.0
        return (self.t_mem / self.bw_factor(f)) / self.duration(f)

    @property
    def boundedness(self) -> str:
        """Dominant roofline term at f=1."""
        if self.t_compute == 0 and self.t_mem == 0 and self.t_coll == 0:
            return "idle"
        terms = {"compute": self.t_compute, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)  # type: ignore[arg-type]


def chip_power(chip: ChipSpec, work: WorkProfile, f: float) -> float:
    """Average chip power while executing ``work`` at clock fraction ``f``.

    The compute block draws full dynamic power during MXU-busy cycles and a
    ``compute_idle_waste`` fraction during the rest (imperfect clock gating
    while stalled on memory/ICI) — the physical reason power caps save energy
    on memory-bound kernels at no runtime cost.
    """
    duty = work.mxu_duty(f)
    gated = duty + chip.compute_idle_waste * (1.0 - duty)
    return (chip.p_static
            + chip.p_compute_max * f**3 * gated
            + chip.p_mem_max * work.bw_factor(f) * work.hbm_duty(f))


def clock_for_cap(chip: ChipSpec, work: WorkProfile, cap: float,
                  tol: float = 1e-6) -> float:
    """Max sustainable clock fraction under ``cap`` watts (bisection)."""
    lo, hi = chip.f_min, chip.f_max
    if chip_power(chip, work, hi) <= cap:
        return hi
    if chip_power(chip, work, lo) >= cap:
        return lo  # firmware floor: cap unattainable
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if chip_power(chip, work, mid) <= cap:
            lo = mid
        else:
            hi = mid
    return lo


def idle_power(chip: ChipSpec, budget: float) -> float:
    """Chip power while compute-idle, given its steered budget.

    A permissive budget lets the idle chip park at higher clocks (paper: the
    'gpu compute idle' phase consumed MORE energy at higher caps, 274.8 W avg
    at the 1000 W default); a tight budget lets it gate down to the deep-idle
    floor.
    """
    floor = chip.p_idle_floor
    park = chip.idle_budget_fraction * max(budget - floor, 0.0)
    return min(floor + park, max(budget, floor))
