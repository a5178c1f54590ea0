"""Learning-rate schedules by iteration: constant, step, linear, poly, cosine.

Counterpart of ``fastscnn_tpu/utils/lr_scheduler.py``: ``lr_schedule``
returns a ``step -> lr`` callable (Python floats), and ``LRScheduler`` is
the reference trainer's ``scheduler(iter) -> lr`` object. The trainer's
poly configuration is power 0.9 over the total iterations.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["lr_schedule", "LRScheduler"]


def lr_schedule(
    mode: str,
    base_lr: float = 0.01,
    target_lr: float = 0.0,
    niters: int = 0,
    nepochs: int = 0,
    iters_per_epoch: int = 0,
    offset: int = 0,
    power: float = 0.9,
    step_iter: Sequence[int] | None = None,
    step_epoch: Sequence[int] | None = None,
    step_factor: float = 0.1,
) -> Callable[[int], float]:
    """A ``step -> lr`` schedule with the reference class's semantics."""
    if mode not in ("constant", "step", "linear", "poly", "cosine"):
        raise ValueError(f"unknown lr mode {mode!r}")
    if mode == "constant":
        target_lr = base_lr
    if nepochs * iters_per_epoch > 0:
        niters = nepochs * iters_per_epoch
        if step_epoch is not None:
            step_iter = [s * iters_per_epoch for s in step_epoch]
    if mode == "step" and step_iter is None and step_epoch is None:
        raise ValueError("step mode requires step_iter or step_epoch")

    steps = tuple(step_iter) if step_iter is not None else None
    if mode == "step" and steps and niters <= max(steps):
        # without niters (or with thresholds beyond it) the clip below
        # would freeze the counter before any decay step fires
        niters = max(steps) + 1
    n = max(niters - 1, 1)

    def schedule(num_update) -> float:
        t = float(min(max(int(num_update) - offset, 0), n))
        if mode == "constant":
            factor = 0.0
        elif mode == "linear":
            factor = 1.0 - t / n
        elif mode == "poly":
            # 0 at the last step exactly (the JAX form guards its traced
            # power, which returns NaN at base 0)
            base = 1.0 - t / n
            factor = base**power if base > 0.0 else 0.0
        elif mode == "cosine":
            factor = (1.0 + math.cos(math.pi * t / n)) / 2.0
        else:  # step
            if steps is not None:
                return base_lr * step_factor ** sum(s <= t for s in steps)
            return float(base_lr)
        return target_lr + (base_lr - target_lr) * factor

    return schedule


class LRScheduler:
    """Stateful wrapper with the reference's ``scheduler(iter) -> lr``
    calling convention."""

    def __init__(self, mode, base_lr=0.01, **kwargs):
        self._schedule = lr_schedule(mode, base_lr=base_lr, **kwargs)
        self.learning_rate = base_lr

    def __call__(self, num_update: int) -> float:
        self.learning_rate = float(self._schedule(num_update))
        return self.learning_rate
