"""Phase segmentation of a training/serving step for the capping controller.

A copy of ``repro/train/phases.py`` for the port.

This is the integration point of the paper's technique into the framework:
a step is decomposed into recurring phases (the paper's 'GPU tasks'), each
with analytic roofline terms, so the controller can pick a per-phase cap and
the loop can account modeled energy per step.

On real hardware the per-phase terms would come from the profiler; here they
are derived from the same analytic accounting the roofline uses (hw/flops),
scaled per chip.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tasks import Task
from repro_torch.hw.tpu import ChipSpec, DEFAULT_CHIP, DEFAULT_SUPERCHIP
from repro_torch.models import lm
from repro_torch.power import CapSchedule, PowerManager


def training_phase_tasks(cfg: ModelConfig, batch: int, seq: int,
                         chip: ChipSpec = DEFAULT_CHIP,
                         chips: int = 1) -> list[Task]:
    """Per-step phases with per-chip roofline terms."""
    from repro_torch.hw import flops as F

    tokens = float(batch) * seq
    L = max(cfg.n_layers, 1)
    d = cfg.d_model

    def t(name, fl, by, coll=0.0, host_s=0.0, calls=1):
        return Task(name, flops=max(fl, 0.0) / chips,
                    hbm_bytes=max(by, 0.0) / chips,
                    coll_bytes=coll / chips, host_seconds=host_s,
                    calls=calls)

    phases = []
    # embedding lookup (memory-bound gather)
    phases.append(t("embed", 0.0, tokens * d * 2 * 2, calls=1))
    # attention / ssd phases (per step, summed over layers)
    attn_fl = 3.0 * F._attention_flops_fwd(cfg, batch, seq, seq)
    ssd_fl = 3.0 * F._ssd_flops_fwd(cfg, batch, seq)
    proj_fl = 6.0 * F.active_param_count(cfg) * tokens
    ffn_share = (3.0 * d * cfg.d_ff / max(
        3.0 * d * cfg.d_ff + 4.0 * d * cfg.n_heads * cfg.head_dim, 1.0)
        if cfg.d_ff else 0.0)
    resid_by = 2.0 * tokens * d * 2 * L
    if attn_fl + ssd_fl > 0:
        phases.append(t("attention" if cfg.family != "ssm" else "ssd_scan",
                        attn_fl + ssd_fl + proj_fl * (1 - ffn_share),
                        resid_by * 0.5))
    if cfg.d_ff:
        coll = 0.0
        if cfg.n_experts:  # MoE dispatch all-to-all (bf16, both directions)
            coll = 2.0 * tokens * d * 2 * cfg.top_k * cfg.capacity_factor * L
        phases.append(t("moe_ffn" if cfg.n_experts else "ffn",
                        proj_fl * ffn_share, resid_by * 0.5, coll=coll))
    # logits + loss (big vocab matmul)
    phases.append(t("logits_loss", 3.0 * F._logits_flops_fwd(cfg, tokens),
                    tokens * cfg.vocab * 0.02 * 4))
    # optimizer update (pure memory: 16 B/param traffic)
    n_tot = F.total_param_count(cfg)
    phases.append(t("optimizer", n_tot * 2.0, 16.0 * n_tot,
                    coll=2.0 * n_tot * 4.0))  # grad all-reduce
    # host input pipeline (the 'gpu compute idle' analogue)
    phases.append(Task("host_input", flops=0.0, hbm_bytes=0.0,
                       host_seconds=max(tokens / chips, 1.0) * 2e-9))
    return phases


@dataclasses.dataclass
class PhaseEnergyLedger:
    """Per-step modeled energy accounting — a thin view over PowerManager.

    Rebuilt on ``repro_torch.power``: the dwell filter, transition pricing, and
    the accounting itself live in ``PowerManager.account_step``; this class
    keeps the historical (schedule, tasks) construction working.  Pass a
    ``PowerManager`` as ``schedule`` to reuse an existing session; a bare
    ``CapSchedule`` gets a private simulated session.

    ``min_dwell_s``: phases shorter than this inherit the previous applied
    cap instead of triggering a power-API write — cap transitions are not
    free, so sub-millisecond phases coalesce.  This is the production form
    of the paper's observation that per-task capping must amortize its
    switching overhead."""

    schedule: "CapSchedule | PowerManager"
    tasks: list[Task]
    spec: object = dataclasses.field(default_factory=lambda: DEFAULT_SUPERCHIP)
    min_dwell_s: float | None = None   # None: inherit the manager's (1e-3)

    def __post_init__(self):
        if isinstance(self.schedule, PowerManager):
            self.pm = self.schedule
            self.pm.tasks.update({t.name: t for t in self.tasks})
            if self.min_dwell_s is not None:
                self.pm.min_dwell_s = self.min_dwell_s
            else:
                self.min_dwell_s = self.pm.min_dwell_s
        else:
            if self.min_dwell_s is None:
                self.min_dwell_s = 1e-3
            self.pm = PowerManager(tasks=self.tasks, spec=self.spec,
                                   schedule=self.schedule,
                                   min_dwell_s=self.min_dwell_s)

    def applied_caps(self) -> list[tuple[str, float]]:
        return self.pm.applied_caps(self.tasks)

    def account_step(self) -> dict:
        return self.pm.account_step(self.tasks)
