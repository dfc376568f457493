"""Hardware models of the port: a copy of ``repro/hw`` (the TPU chip
model, DVFS, analytic flops) and the H100's own spec (``hw/h100.py``)."""

from repro_torch.hw.tpu import (ChipSpec, HostSpec, SuperchipSpec, PodSpec,
                                DEFAULT_CHIP, DEFAULT_HOST, DEFAULT_SUPERCHIP)
from repro_torch.hw.dvfs import (WorkProfile, chip_power, clock_for_cap,
                                 idle_power)
from repro_torch.hw.h100 import H100_CHIP, H100_HOST, H100_SUPERCHIP, H100Spec

__all__ = [
    "ChipSpec", "HostSpec", "SuperchipSpec", "PodSpec",
    "DEFAULT_CHIP", "DEFAULT_HOST", "DEFAULT_SUPERCHIP",
    "WorkProfile", "chip_power", "clock_for_cap", "idle_power",
    "H100Spec", "H100_CHIP", "H100_HOST", "H100_SUPERCHIP",
]
