"""``repro_torch.power`` — the port's power API, a copy of ``repro.power``
with the same exports.

Layers (paper section 2-4, plus its section-5 future work as a runtime):

  metrics.py   Metric protocol + registry (sed / ed / user-defined)
  backends.py  CapBackend HAL: simulated, logging, hwmon-stub writes
  manager.py   PowerManager session: decide -> phase() -> observe() ->
               re-decide, plus CapSchedule and modeled step accounting
  arbiter.py   weighted_split + PodPowerArbiter: one budget, N consumers

and the card's own, imported from their modules:

  nvml.py      NvmlBackend: NVML limit writes and the energy counter
  metered.py   MeteredPowerManager: measured seconds and joules per phase

Quick start::

    from repro_torch.power import PowerManager
    pm = PowerManager(tasks=training_phase_tasks(cfg, batch, seq))
    with pm.phase("attention"):
        ...                      # runs under the attention cap
    stats = pm.account_step()    # modeled energy vs uncapped
"""

from repro_torch.power.metrics import (Metric, available_metrics,
                                       euclidean_distance_scores, get_metric,
                                       minmax_normalize, nearest_utopia_pick,
                                       optimal_cap, rank_caps,
                                       register_metric)
from repro_torch.power.backends import (CapBackend, HwmonBackend,
                                        LoggingBackend, SimulatedBackend)
from repro_torch.power.manager import (CapDecision, CapSchedule, PhaseRecord,
                                       PowerGoal, PowerManager, SteeringGoal)
from repro_torch.power.arbiter import (CapSource, PodPowerArbiter,
                                       weighted_split)

__all__ = [
    "Metric", "register_metric", "get_metric", "available_metrics",
    "optimal_cap", "rank_caps", "minmax_normalize",
    "euclidean_distance_scores", "nearest_utopia_pick",
    "CapBackend", "SimulatedBackend", "LoggingBackend", "HwmonBackend",
    "PowerGoal", "SteeringGoal", "CapDecision", "CapSchedule",
    "PhaseRecord", "PowerManager",
    "CapSource", "PodPowerArbiter", "weighted_split",
]
