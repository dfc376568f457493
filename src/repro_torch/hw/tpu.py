"""Hardware model of the target chip: TPU v5e-class accelerator + host.

A copy of ``repro/hw/tpu.py`` for the port.

All power numbers are a MODELED envelope (the reference has no TPU and no
power telemetry); the roofline throughput numbers are the assignment's
constants.  Everything is a dataclass so experiments can re-parameterize.

The power decomposition follows the classic DVFS model the paper's observed
behavior implies (GH200 power steering + DVFS enforcement, paper section 2):

  P(f) = P_static + P_compute_max * f^3 * mxu_duty + P_mem_max * hbm_duty

  - compute throughput scales linearly with core clock fraction ``f``
  - HBM bandwidth is held constant under core DVFS (memory clocks separate)
  - dynamic power ~ C * V^2 * f with V ~ f  =>  f^3
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator chip (TPU v5e-class)."""

    name: str = "tpu-v5e-modeled"
    # --- roofline constants (assignment-provided) ---
    peak_flops_bf16: float = 197e12       # FLOP/s
    hbm_bandwidth: float = 819e9          # B/s
    ici_bandwidth: float = 50e9           # B/s per link
    hbm_capacity: float = 16e9            # bytes
    vmem_capacity: float = 128 * 1024**2  # bytes (~128 MiB VMEM)
    # --- modeled power envelope ---
    p_static: float = 60.0        # W, leakage + uncore, always drawn
    p_compute_max: float = 140.0  # W, MXU/VPU dynamic power at f=1, 100% duty
    p_mem_max: float = 50.0       # W, HBM interface at 100% bandwidth duty
    # --- DVFS ---
    f_min: float = 0.40           # lowest sustainable core-clock fraction
    f_max: float = 1.00
    # below this core-clock fraction the memory subsystem clocks down too
    # (aggressive caps degrade HBM bandwidth linearly under the knee)
    mem_f_knee: float = 0.55
    p_idle_floor: float = 30.0    # W, deep-idle (compute-idle clock gating)
    # idle behavior: at higher available budget the idle chip parks at a
    # higher clock => draws more (paper: idle energy grows with the cap).
    idle_budget_fraction: float = 0.25
    # fraction of compute-block dynamic power still drawn during non-MXU
    # cycles (clocks race while waiting on memory — imperfect clock gating).
    # This is WHY capping saves energy on memory-bound kernels (paper:
    # buildKKRMatrix -22.9 % energy at a 300 W cap).
    compute_idle_waste: float = 0.35

    @property
    def p_peak(self) -> float:
        return self.p_static + self.p_compute_max + self.p_mem_max


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """Host CPU sharing the superchip power budget (Grace-analogue)."""

    name: str = "host-modeled"
    peak_flops: float = 3.5e12    # FLOP/s, 72-core-class
    p_idle: float = 20.0          # W
    p_max: float = 80.0           # W at f=1 full load
    f_min: float = 0.40
    f_max: float = 1.00


@dataclasses.dataclass(frozen=True)
class SuperchipSpec:
    """Integrated host+accelerator package with one shared power budget.

    Mirrors GH200 automatic power steering semantics: the host draws first,
    unused headroom is steered to the accelerator (paper section 2).
    """

    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    host: HostSpec = dataclasses.field(default_factory=HostSpec)

    @property
    def p_max(self) -> float:
        return self.chip.p_peak + self.host.p_max  # 330 W modeled

    @property
    def p_default(self) -> float:
        """Default = no capping (paper: 1000 W default on GH200)."""
        return self.p_max

    @property
    def p_floor(self) -> float:
        """Physical floor: host idle + chip deep-idle — draw that cannot
        be capped away.  The per-consumer floor every budget arbiter
        (PodPowerArbiter, the JAX package's repro.fleet) enforces."""
        return self.host.p_idle + self.chip.p_idle_floor

    def cap_sweep(self) -> tuple[float, ...]:
        """Nine cap settings, the analogue of the paper's 200..1000 W sweep.

        The lowest setting is intentionally below the attainable floor for
        busy tasks (as the paper's 200 W was): the chip then runs pinned at
        f_min with the cap unattainable, which reproduces the paper's
        'slowest AND most energy-hungry' low-cap corner.
        """
        return (90.0, 120.0, 150.0, 180.0, 210.0, 240.0, 270.0, 300.0, 330.0)


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """A pod of chips for roofline accounting."""

    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    chips: int = 256
    ici_links_per_chip: int = 4   # 2D torus

    def peak_pod_flops(self) -> float:
        return self.chip.peak_flops_bf16 * self.chips


DEFAULT_CHIP = ChipSpec()
DEFAULT_HOST = HostSpec()
DEFAULT_SUPERCHIP = SuperchipSpec()
