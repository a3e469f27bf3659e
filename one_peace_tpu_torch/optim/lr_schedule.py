"""LR schedules (counterpart of ``one_peace_tpu/optim/lr_schedule.py``).

Warmup by updates, or by a ratio of the total, then cosine (or polynomial)
decay from the peak lr to ``min_lr``.  A schedule maps an update count to
an lr, in float32 as the JAX package computes it.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from one_peace_tpu.core.config import LRSchedulerConfig, OptimizationConfig


def _warmup(cfg: LRSchedulerConfig, total_updates: int) -> int:
    if cfg.warmup_updates == 0 and cfg.warmup_ratio > 0:
        return int(total_updates * cfg.warmup_ratio)
    return cfg.warmup_updates


def _schedule(cfg, opt, total_updates, decay: Callable) -> Callable[[int], float]:
    peak, end = np.float32(opt.lr), np.float32(cfg.min_lr)
    warmup = _warmup(cfg, total_updates)

    def schedule(step) -> float:
        step = np.float32(step)
        if step < warmup:
            return float(peak * step / np.float32(max(warmup, 1)))
        t = np.clip((step - np.float32(warmup)) / np.float32(max(total_updates - warmup, 1)),
                    np.float32(0), np.float32(1))
        return float(decay(peak, end, t))

    return schedule


def cosine_schedule(cfg: LRSchedulerConfig, opt: OptimizationConfig, total_updates: int):
    return _schedule(cfg, opt, total_updates, lambda peak, end, t: end + np.float32(0.5) * (
        peak - end) * (np.float32(1) + np.cos(np.float32(math.pi) * t)))


def polynomial_schedule(cfg: LRSchedulerConfig, opt: OptimizationConfig,
                        total_updates: int, power: float = 1.0):
    return _schedule(cfg, opt, total_updates,
                     lambda peak, end, t: (peak - end) * (np.float32(1) - t) ** power + end)


SCHEDULES = {"cosine": cosine_schedule, "adjust_cosine": cosine_schedule,
             "polynomial_decay": polynomial_schedule}


def build_lr_schedule(cfg: LRSchedulerConfig, opt: OptimizationConfig, total_updates: int):
    name = cfg._name or "cosine"
    if name not in SCHEDULES:
        raise NotImplementedError(f"lr scheduler {name!r} is not ported")
    return SCHEDULES[name](cfg, opt, total_updates)
