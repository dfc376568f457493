"""The paper's primary contribution: task-granular power-capping evaluation.

A copy of ``repro/core/__init__.py`` for the port.

  tasks.py        Task / TaskMeasurement / TaskTable (paper Table 1
                  analogue; tolerance-indexed cap lookup + online
                  ``observe`` refinement)
  power_model.py  (task, cap) -> (runtime, energy) via DVFS + power steering
  metrics.py      speedup-energy-delay, Euclidean-distance, GPS-UP (pure
                  functions; the pluggable Metric registry lives in
                  ``repro_torch.power.metrics``)
  trace.py        5 ms synthetic power trace (paper Fig. 1)

The cap-selection/session stack lives in ``repro_torch.power``
(PowerManager, CapBackend, weighted_split/PodPowerArbiter); the old
``core.steering`` shim is retired and not copied — its names from here
raise with a pointer to ``repro_torch.power``.
"""

from repro_torch.core.tasks import (Task, TaskMeasurement, TaskTable,
                                    CAP_TOLERANCE_W, caps_equal)
from repro_torch.core.power_model import (NoiseModel, measure_sweep,
                                          simulate_task)
from repro_torch.core.metrics import (speedup_energy_delay, sed_optimal_cap,
                                      euclidean_distance, ed_optimal_cap,
                                      ed_argmin_is_pareto, gps_up, GpsUp,
                                      table2, aggregate_table2, Table2Row,
                                      weighted_application_impact)
from repro_torch.core.trace import generate_trace, PowerTrace, TracePoint

__all__ = [
    "Task", "TaskMeasurement", "TaskTable", "CAP_TOLERANCE_W", "caps_equal",
    "NoiseModel", "measure_sweep", "simulate_task",
    "speedup_energy_delay", "sed_optimal_cap",
    "euclidean_distance", "ed_optimal_cap", "ed_argmin_is_pareto",
    "gps_up", "GpsUp", "table2", "aggregate_table2", "Table2Row",
    "weighted_application_impact",
    "generate_trace", "PowerTrace", "TracePoint",
]

# The retired steering names get a pointer, not a silent AttributeError.
_MOVED = ("PowerSteeringController", "SteeringGoal", "CapSchedule",
          "CapDecision")


def __getattr__(name):
    if name in _MOVED:
        raise AttributeError(
            f"repro_torch.core.{name} was removed: the steering stack lives "
            f"in repro_torch.power — use repro_torch.power.PowerManager / "
            f"PowerGoal / CapSchedule / CapDecision")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
