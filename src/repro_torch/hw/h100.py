"""The H100's spec for the power model: roofline, power envelope, caps.

The card's counterpart of ``hw/tpu.py``'s TPU model, and the default
spec of the port's card paths (the launchers and ``chip_smoke.py``).

* Roofline, from NVIDIA's H100 SXM data sheet (dense rates at the 700 W
  limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB, NVLink 4 at 450 GB/s
  a direction.
* Power envelope, from the card: ``p_static`` (and the deep-idle floor)
  is the idle draw; ``p_compute_max`` and ``p_mem_max`` are fitted
  (``fit_envelope``) from the mean draw of a compute-bound window (a
  bf16 8192^3 ``torch.matmul`` loop) and a memory-bound one (a 1 GiB
  device-to-device copy loop) at the default limit, read from NVML's
  energy counter by ``chip_smoke.py``'s ``[power:calibrate]``.  A window
  the limit throttles reads as the limit, so the fit is the envelope the
  card shows at its default limit.
* ``f_min``, ``mem_f_knee``, ``compute_idle_waste`` and
  ``idle_budget_fraction`` keep the reference's values: dimensionless
  modelling fractions the card does not report (modelled, not measured).
* Host: an H100 box is no integrated CPU-GPU package.  NVML's limit caps
  the card alone, so the host shares no budget and draws nothing in the
  model (``p_idle = p_max = 0``; ``peak_flops`` kept for host phases).
* Caps: ``p_default`` is the card's default limit and ``cap_sweep()``
  nine whole-watt settings from its minimum to its maximum limit, as
  ``nvmlDeviceGetPowerManagementLimitConstraints`` reports them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.hw.dvfs import WorkProfile
from repro_torch.hw.tpu import ChipSpec, HostSpec, SuperchipSpec

#: the card every constant below was read on, as ``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader`` prints it
MEASURED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"

# --- measured by chip_smoke.py's [power:nvml] and [power:calibrate] ---
#: mean draw of a 2 s idle window taken seconds after the card worked (a
#: card idle since it was set up drew ~76 W): the draw between phases
IDLE_W = 123.5             # NVIDIA H100 80GB HBM3, 700.00 W
#: fitted; a bf16 matmul window drew 697.3 W
P_COMPUTE_MAX_W = 565.2    # NVIDIA H100 80GB HBM3, 700.00 W
#: fitted; a 1 GiB copy window drew 401.4 W
P_MEM_MAX_W = 80.1         # NVIDIA H100 80GB HBM3, 700.00 W
#: NVML's limit constraints and default limit
LIMIT_MIN_W = 200.0        # NVIDIA H100 80GB HBM3, 700.00 W
LIMIT_MAX_W = 700.0        # NVIDIA H100 80GB HBM3, 700.00 W
LIMIT_DEFAULT_W = 700.0    # NVIDIA H100 80GB HBM3, 700.00 W
#: one nvmlDeviceSetPowerManagementLimit call, s: the card refused it
#: (NVML_ERROR_NO_PERMISSION) in 0.106 ms; a write that lands is not
#: measured yet
NVML_SET_LIMIT_S = 1.06e-4  # NVIDIA H100 80GB HBM3, 700.00 W

#: float32 outside the tensor cores (the same data sheet): the rate of the
#: complex64 work of ``models/lsms.py`` (TF32 off)
PEAK_FLOPS_F32 = 67e12

#: the calibration windows' work per call: a bf16 n^3 matmul (A, B read,
#: C written) and a copy of COPY_BYTES (read and written)
MATMUL_N = 8192
COPY_BYTES = 2 ** 30

H100_CHIP = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12, hbm_bandwidth=3.35e12, ici_bandwidth=450e9,
    hbm_capacity=80e9,
    vmem_capacity=50 * 1024**2,     # the L2 cache
    p_static=IDLE_W, p_compute_max=P_COMPUTE_MAX_W, p_mem_max=P_MEM_MAX_W,
    p_idle_floor=IDLE_W)

H100_HOST = HostSpec(name="host-outside-the-cap", p_idle=0.0, p_max=0.0)


@dataclasses.dataclass(frozen=True)
class H100Spec(SuperchipSpec):
    """One H100 under its NVML limit: the card is the whole budget."""

    chip: ChipSpec = dataclasses.field(default_factory=lambda: H100_CHIP)
    host: HostSpec = dataclasses.field(default_factory=lambda: H100_HOST)
    limit_min: float = LIMIT_MIN_W
    limit_max: float = LIMIT_MAX_W
    limit_default: float = LIMIT_DEFAULT_W

    @property
    def p_max(self) -> float:
        return self.limit_max

    @property
    def p_default(self) -> float:
        return self.limit_default

    def cap_sweep(self) -> tuple[float, ...]:
        step = (self.limit_max - self.limit_min) / 8
        return tuple(float(round(self.limit_min + i * step))
                     for i in range(9))


H100_SUPERCHIP = H100Spec()


def calibration_profiles(chip: ChipSpec = H100_CHIP
                         ) -> tuple[WorkProfile, WorkProfile]:
    """Roofline profiles of one call of the compute-bound (matmul) and
    the memory-bound (copy) calibration windows."""
    n = float(MATMUL_N)
    mm = WorkProfile(t_compute=2 * n**3 / chip.peak_flops_bf16,
                     t_mem=3 * n * n * 2 / chip.hbm_bandwidth,
                     mem_f_knee=chip.mem_f_knee)
    cp = WorkProfile(t_compute=0.0,
                     t_mem=2.0 * COPY_BYTES / chip.hbm_bandwidth,
                     mem_f_knee=chip.mem_f_knee)
    return mm, cp


def fit_envelope(idle_w: float, compute_w: float, memory_w: float,
                 chip: ChipSpec = H100_CHIP) -> dict[str, float]:
    """``p_static``, ``p_compute_max`` and ``p_mem_max`` such that
    ``hw.dvfs.chip_power`` at f = 1 gives the measured mean draws of the
    idle, compute-bound and memory-bound windows (two linear equations
    in the two maxima, from the windows' duties)."""
    mm, cp = calibration_profiles(chip)
    w = chip.compute_idle_waste
    # P - p_static = p_compute_max * gated(duty) + p_mem_max * hbm_duty
    a1 = mm.mxu_duty(1.0) + w * (1.0 - mm.mxu_duty(1.0))
    b1 = mm.hbm_duty(1.0)
    a2 = cp.mxu_duty(1.0) + w * (1.0 - cp.mxu_duty(1.0))
    b2 = cp.hbm_duty(1.0)
    y1, y2 = compute_w - idle_w, memory_w - idle_w
    det = a1 * b2 - a2 * b1
    return {"p_static": idle_w,
            "p_compute_max": (y1 * b2 - y2 * b1) / det,
            "p_mem_max": (a1 * y2 - a2 * y1) / det}
