"""Optimizer and LR schedules (counterpart of ``one_peace_tpu/optim``)."""

from .adamw import build_optimizer, decay_mask, layer_decay_scales, layer_id_for_path
from .lr_schedule import build_lr_schedule

__all__ = ["build_lr_schedule", "build_optimizer", "decay_mask", "layer_decay_scales",
           "layer_id_for_path"]
