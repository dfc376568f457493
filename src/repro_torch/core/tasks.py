"""Task model: the paper's unit of power-capping analysis.

A copy of ``repro/core/tasks.py`` for the port.

A *task* is a recurring computational region (the paper's GPU kernels and the
'gpu compute idle' phase).  In this framework tasks come from two sources:

  1. model phases segmented out of a training/serving step (attention, MoE
     dispatch, expert GEMM, SSD scan, optimizer update, host/input idle), with
     roofline terms derived from the compiled dry-run, and
  2. the LSMS-analogue SCF workload (examples/lsms_scf.py) whose task names
     mirror the paper's Table 1 rows.

``TaskMeasurement`` is one (task x cap) observation; ``TaskTable`` is the
paper's Table-1-style collection at a fixed cap.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from repro_torch.hw.dvfs import WorkProfile
from repro_torch.hw.tpu import ChipSpec, DEFAULT_CHIP

#: Cap values within this many watts are the same setting.  Real power-API
#: writes quantize to whole watts (hwmon takes microwatts but firmware
#: granularity is ~1 W); float noise from arithmetic on caps must not
#: create phantom "different" settings.
CAP_TOLERANCE_W = 1e-6


def caps_equal(a: float, b: float, tol: float = CAP_TOLERANCE_W) -> bool:
    """Whether two cap values denote the same power-limit setting."""
    return abs(a - b) <= tol


@dataclasses.dataclass(frozen=True)
class Task:
    """A recurring computational region with per-call roofline terms."""

    name: str
    flops: float                 # per call, on the accelerator
    hbm_bytes: float             # per call
    calls: int = 1
    coll_bytes: float = 0.0      # per call, over ICI
    host_flops: float = 0.0      # host-side work during this task (idle phases)
    host_seconds: float = 0.0    # explicit host-time alternative to host_flops

    def work_profile(self, chip: ChipSpec = DEFAULT_CHIP) -> WorkProfile:
        return WorkProfile(
            t_compute=self.flops / chip.peak_flops_bf16,
            t_mem=self.hbm_bytes / chip.hbm_bandwidth,
            t_coll=self.coll_bytes / chip.ici_bandwidth,
            mem_f_knee=chip.mem_f_knee,
        )

    @property
    def is_idle(self) -> bool:
        return self.flops == 0 and self.hbm_bytes == 0 and self.coll_bytes == 0

    def boundedness(self, chip: ChipSpec = DEFAULT_CHIP) -> str:
        return "idle" if self.is_idle else self.work_profile(chip).boundedness


@dataclasses.dataclass(frozen=True)
class TaskMeasurement:
    """One (task, cap) observation: the paper's primitive data point."""

    task: str
    cap: float          # superchip cap, W
    runtime: float      # total seconds across all calls
    energy: float       # total joules across all calls
    clock_fraction: float = 1.0

    @property
    def avg_power(self) -> float:
        return self.energy / self.runtime if self.runtime > 0 else 0.0


class TaskTable:
    """Measurements for many tasks across the cap sweep."""

    def __init__(self, measurements: Iterable[TaskMeasurement]):
        self.rows: list[TaskMeasurement] = list(measurements)
        self._reindex()

    def _reindex(self) -> None:
        # task -> {cap: row position}; exact-key hit first, tolerance scan
        # over the (few) caps of one task as the fallback.
        self._index: dict[str, dict[float, int]] = {}
        for i, r in enumerate(self.rows):
            self._index.setdefault(r.task, {})[r.cap] = i

    def _row_pos(self, task: str, cap: float) -> int:
        by_cap = self._index.get(task)
        if by_cap is None:
            raise KeyError((task, cap))
        pos = by_cap.get(cap)
        if pos is not None:
            return pos
        for c, i in by_cap.items():
            if caps_equal(c, cap):
                return i
        raise KeyError((task, cap))

    # -- access ----------------------------------------------------------
    def tasks(self) -> list[str]:
        return list(self._index)

    def caps(self) -> list[float]:
        return sorted({r.cap for r in self.rows})

    def at(self, task: str, cap: float) -> TaskMeasurement:
        return self.rows[self._row_pos(task, cap)]

    def for_task(self, task: str) -> list[TaskMeasurement]:
        pos = self._index.get(task, {})
        return sorted((self.rows[i] for i in pos.values()),
                      key=lambda r: r.cap)

    # -- online refinement -------------------------------------------------
    def observe(self, m: TaskMeasurement,
                alpha: float = 0.5) -> TaskMeasurement:
        """Blend one online observation into the table (EWMA with weight
        ``alpha`` on the new sample).  A (task, cap) pair never seen before
        is inserted as-is.  Returns the stored row."""
        try:
            pos = self._row_pos(m.task, m.cap)
        except KeyError:
            self.rows.append(m)
            self._index.setdefault(m.task, {})[m.cap] = len(self.rows) - 1
            return m
        old = self.rows[pos]
        blended = dataclasses.replace(
            old,
            runtime=(1 - alpha) * old.runtime + alpha * m.runtime,
            energy=(1 - alpha) * old.energy + alpha * m.energy,
            clock_fraction=(1 - alpha) * old.clock_fraction
            + alpha * m.clock_fraction)
        self.rows[pos] = blended
        return blended

    def baseline(self, task: str) -> TaskMeasurement:
        """The default (highest) cap row — the paper's 1000 W baseline."""
        return self.for_task(task)[-1]

    # -- io ----------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(r) for r in self.rows], indent=1)

    @classmethod
    def from_json(cls, text: str) -> "TaskTable":
        return cls(TaskMeasurement(**d) for d in json.loads(text))

    def table1(self, cap: float | None = None) -> list[dict]:
        """Paper Table-1 analogue at the default (or given) cap, sorted by
        total energy descending."""
        cap = cap if cap is not None else max(self.caps())
        rows = [r for r in self.rows if r.cap == cap]
        rows.sort(key=lambda r: -r.energy)
        return [{"task": r.task, "total_time_s": r.runtime,
                 "total_energy_j": r.energy, "avg_power_w": r.avg_power}
                for r in rows]
