"""Learning-rate schedules as plain functions of the update count
(counterpart of diffsinger_tpu/training/schedules.py)."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

Schedule = Callable[[int], float]


def rsqrt_schedule(lr: float, warmup_updates: int = 8000,
                   hidden_size: int = 256) -> Schedule:
    """``lr * min(step / warmup, 1) * max(warmup, step)^-0.5 * hidden^-0.5``,
    floored at 1e-7."""
    def schedule(step: int) -> float:
        warmup = min(step / warmup_updates, 1.0)
        return max(lr * warmup * max(float(warmup_updates), step) ** -0.5
                   * hidden_size ** -0.5, 1e-7)

    return schedule


def step_lr_schedule(lr: float, decay_steps: int = 50000, gamma: float = 0.5) -> Schedule:
    """StepLR: ``lr * gamma ** floor(step / decay_steps)``."""
    def schedule(step: int) -> float:
        return lr * gamma ** math.floor(step / decay_steps)

    return schedule


def build_lr_schedule(hp: Dict[str, Any]) -> Schedule:
    """Diffusion tasks use StepLR when ``decay_steps`` is set; FS2 tasks the
    RSQRT warmup."""
    if hp.get("decay_steps"):
        return step_lr_schedule(float(hp["lr"]), int(hp["decay_steps"]))
    return rsqrt_schedule(float(hp["lr"]), int(hp.get("warmup_updates", 8000)),
                          int(hp.get("hidden_size", 256)))
