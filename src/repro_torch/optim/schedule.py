"""Learning-rate schedules, ported from ``repro/optim/schedule.py``."""

from __future__ import annotations

import math


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor_frac: float = 0.1):
    """Linear warmup then cosine decay to floor_frac * peak.  The returned
    ``lr(step)`` takes a Python number or a 0-d tensor and returns a
    Python float."""

    def lr(step) -> float:
        step = float(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        floor = floor_frac * peak_lr
        cos = floor + (peak_lr - floor) * 0.5 * (1 + math.cos(math.pi
                                                              * progress))
        return warm if step < warmup_steps else cos

    return lr
