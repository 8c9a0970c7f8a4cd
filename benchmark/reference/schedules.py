"""Frozen copy of the learning-rate schedule of
diffsinger_tpu_torch/training/schedules.py that the benchmark's training cell
runs (StepLR, the diffusion tasks' with ``decay_steps``), the plain math of
its reference; it imports nothing of the program."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

Schedule = Callable[[int], float]


def step_lr_schedule(lr: float, decay_steps: int = 50000, gamma: float = 0.5) -> Schedule:
    """StepLR: ``lr * gamma ** floor(step / decay_steps)``."""
    def schedule(step: int) -> float:
        return lr * gamma ** math.floor(step / decay_steps)

    return schedule


def build_lr_schedule(hp: Dict[str, Any]) -> Schedule:
    """StepLR; the FS2 tasks' RSQRT warmup (no ``decay_steps``) is left out."""
    if not hp.get("decay_steps"):
        raise NotImplementedError("the reference leaves out the RSQRT schedule")
    return step_lr_schedule(float(hp["lr"]), int(hp["decay_steps"]))
