"""Learning-rate schedules (host-side pure functions of the step); a copy of
``repro.optim.schedules``."""

from __future__ import annotations

import math


def constant(lr: float):
    def sched(step: int) -> float:
        return lr
    return sched


def cosine_with_warmup(lr: float, total_steps: int, warmup_steps: int = 100,
                       final_ratio: float = 0.1):
    """Paper setup: linear warmup (Table 10: 100 steps) then cosine decay."""
    def sched(step: int) -> float:
        if step < warmup_steps:
            return lr * (step + 1) / max(1, warmup_steps)
        t = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        t = min(1.0, t)
        return lr * (final_ratio + (1 - final_ratio)
                     * 0.5 * (1 + math.cos(math.pi * t)))
    return sched
