"""Learning-rate and gradient-accumulation schedules as plain functions of
the update count (counterpart of diffsinger_tpu/training/schedules.py)."""

from __future__ import annotations

import math
import bisect
from typing import Any, Callable, Dict

import numpy as np

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


def grad_accum_schedule(scheduling: Dict[int, int],
                        batches_per_epoch: int) -> Callable[[int], int]:
    """A per-epoch ``accumulate_grad_batches`` dict as a function of the
    optimizer-update count: ``{epoch: factor}``, epochs indexed from 1, the
    factor of the largest key <= the epoch, ``{1: 1}`` implied. An epoch span
    of E epochs at factor f covers ``E * batches_per_epoch / f`` updates."""
    if not scheduling:
        raise TypeError("Empty dict cannot be interpreted correct")
    sched = {int(k): int(v) for k, v in scheduling.items()}
    if min(sched) < 1:
        raise IndexError(f"Epochs indexing from 1, epoch {min(sched)} "
                         "cannot be interpreted correct")
    sched.setdefault(1, 1)
    keys = sorted(sched)
    starts, u = [], 0.0
    for i, k in enumerate(keys):
        starts.append(u)
        if i + 1 < len(keys):
            u += (keys[i + 1] - k) * batches_per_epoch / sched[k]
    # the update counts where a factor starts, compared in float32 as JAX does
    starts = [float(np.float32(x)) for x in starts]
    factors = [sched[k] for k in keys]

    def every_k(num_updates: int) -> int:
        return factors[max(bisect.bisect_right(starts, float(num_updates)) - 1, 0)]

    return every_k


def build_lr_schedule(hp: Dict[str, Any]) -> Schedule:
    """Diffusion tasks use StepLR when ``decay_steps`` is set; FS2 tasks the
    RSQRT warmup."""
    if hp.get("decay_steps"):
        return step_lr_schedule(float(hp["lr"]), int(hp["decay_steps"]))
    return rsqrt_schedule(float(hp["lr"]), int(hp.get("warmup_updates", 8000)),
                          int(hp.get("hidden_size", 256)))
