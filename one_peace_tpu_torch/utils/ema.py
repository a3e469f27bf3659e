"""Exponential moving average of the parameters (counterpart of
``one_peace_tpu/utils/ema.py``).

The shadow is a copy of every parameter of the model, frozen ones included
(the JAX shadow covers the whole parameter tree), in fp32 under
``ema_fp32`` and in each parameter's dtype otherwise, on the parameters'
device.  Before ``ema_start_update`` updates it copies the parameters;
after, every ``ema_update_freq`` updates, it moves to
``s * decay + p * (1 - decay)``: ``s * decay`` rounded, then
``p * (1 - decay)`` added to it with one rounding, the fused multiply-add
that XLA compiles the JAX update to (not ``lerp``, whose rounding
differs).  A skipped (non-finite) step leaves it where it was.  The
trainer steps it on accumulation boundaries only.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..core.config import EMAConfig


class EMA:
    def __init__(self, cfg: EMAConfig, named_params: Iterable[Tuple[str, torch.Tensor]]):
        self.cfg = cfg
        self.shadow: Dict[str, torch.Tensor] = {}
        self._copy(named_params)

    @torch.no_grad()
    def _copy(self, named_params) -> None:
        for name, p in named_params:
            dtype = torch.float32 if self.cfg.ema_fp32 else p.dtype
            if name in self.shadow:
                self.shadow[name].copy_(p)
            else:
                self.shadow[name] = p.detach().to(dtype, copy=True)

    @torch.no_grad()
    def step(self, named_params: Iterable[Tuple[str, torch.Tensor]], num_updates: int,
             skipped: bool = False) -> None:
        """Track the parameters after ``num_updates`` updates; ``skipped``:
        the step that led here changed nothing, and the shadow stays."""
        cfg = self.cfg
        if num_updates < cfg.ema_start_update:
            self._copy(named_params)  # a skipped step left the parameters as they were
        elif num_updates % cfg.ema_update_freq == 0 and not skipped:
            rest = float(np.float32(1 - cfg.ema_decay))
            named = list(named_params)
            shadows = [self.shadow[name] for name, _ in named]
            torch._foreach_mul_(shadows, cfg.ema_decay)
            for s, (_, p) in zip(shadows, named):
                # p * (1 - decay) + s rounded once, through fp64 (the product
                # of two fp32 values is exact there), and cast as it is
                # stored: the fused multiply-add that XLA compiles the JAX
                # update to
                torch.add(s, p.double(), alpha=rest, out=s)
