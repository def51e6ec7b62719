"""Learning-rate / noise schedules and accept/reject bookkeeping (a copy
of ``rsrgan_tpu/training/schedules.py``; host-side scalars)."""

from __future__ import annotations

import math


def exponential_decay(iteration: int, num_jobs: int, num_iters: int,
                      init_value: float, multiply_jobs: bool = True) -> float:
    """Decays to 1e-4x the initial value over ``num_iters`` iterations
    (geometric interpolation); optionally scales by the replica count.
    ``init_value == 0`` returns 0."""
    if init_value == 0.0:
        return 0.0
    final_value = 0.0001 * init_value
    if iteration + 1 >= num_iters:
        current = final_value
    else:
        current = init_value * math.exp(
            iteration * math.log(final_value / init_value) / num_iters)
    if multiply_jobs:
        return num_jobs * current
    return current


def staged_decay(init_lr: float, decay_factor: float,
                 decay_steps: int) -> float:
    """The frame trainers' staged decay: ``init_lr * decay_factor **
    decay_steps``, stepped whenever the CV improvement falls below
    ``start_decay_impr``."""
    return init_lr * decay_factor ** decay_steps


class ImprovementTracker:
    """Windowed relative-improvement accept/reject bookkeeping: collect CV
    losses into a window; at each check interval compare the window mean
    to the best accepted mean; accept (and save) on improvement, never
    roll back; stop when the relative improvement falls below
    ``end_improve`` past ``min_iters``."""

    def __init__(self, end_improve: float = 0.001, check_interval: int = 1):
        self.loss_prev = 10000.0
        self.rel_impr = 1.0
        self.end_improve = end_improve
        self.check_interval = check_interval
        self.window = []

    def add(self, cv_loss: float) -> None:
        self.window.append(cv_loss)

    def check(self, iteration: int) -> bool:
        """Whether to save. Call after add()."""
        should_save = False
        if (iteration + 1) % self.check_interval == 0 and self.window:
            loss_new = sum(self.window) / len(self.window)
            self.rel_impr = (self.loss_prev - loss_new) / self.loss_prev
            if self.rel_impr > 0.0:
                should_save = True
                self.loss_prev = loss_new
            self.window = []
        return should_save

    def should_stop(self, iteration: int, min_iters: int) -> bool:
        return (iteration + 1 > min_iters
                and (iteration + 1) % self.check_interval == 0
                and self.rel_impr < self.end_improve)
