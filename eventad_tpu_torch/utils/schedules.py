"""Learning-rate schedules and the optimizer of detector training
(counterpart of ``eventad_tpu/utils/schedules.py``; reference ``LRSchedule``,
src/dagr/utils/learning_rate_scheduler.py:8-47, and the adam/sgd factory,
optimization.py:3-48).

A schedule is a plain function of the update count.  The optimizer is the
JAX package's optax chain as a torch object: the global-norm clip, then
AdamW (optax's constants) or SGD with momentum 0.9, its rate set from the
schedule before every update.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from ..parallel.train_step import ClippedOptimizer


def yolox_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                   min_lr_ratio: float = 0.05,
                   no_aug_steps: int = 0) -> Callable[[int], float]:
    """Quadratic warm-up, then a cosine to ``min_lr_ratio * base_lr``, flat
    at that floor over the final no-augmentation steps (YOLOX)."""
    min_lr = base_lr * min_lr_ratio
    cos_steps = max(total_steps - warmup_steps - no_aug_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (min(step, warmup_steps)
                              / max(warmup_steps, 1)) ** 2
        t = min(max((step - warmup_steps) / cos_steps, 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))

    return schedule


def step_schedule(base_lr: float, boundaries,
                  factor: float = 0.1) -> Callable[[int], float]:
    """``base_lr`` times ``factor`` for every boundary the count has
    reached (optax ``piecewise_constant_schedule``)."""
    bounds = sorted(int(b) for b in boundaries)

    def schedule(step: int) -> float:
        lr = base_lr
        for b in bounds:
            if step >= b:
                lr *= factor
        return lr

    return schedule


def make_detector_optimizer(params: Iterable[torch.nn.Parameter], kind: str,
                            schedule: Callable[[int], float],
                            weight_decay: float, clip: float,
                            momentum: float = 0.9,
                            grad_norm=None) -> ClippedOptimizer:
    """``clip_by_global_norm(clip)`` then ``sgd(schedule, momentum)`` for
    ``kind == "sgd"``, else ``adamw(schedule, weight_decay)``, over every
    parameter in ``params`` (``grad_norm``: see ``ClippedOptimizer``)."""
    params = list(params)
    if kind == "sgd":
        inner = torch.optim.SGD(params, lr=0.0, momentum=momentum)
    else:
        inner = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=weight_decay)
    return ClippedOptimizer(params, inner, clip, schedule, grad_norm)
