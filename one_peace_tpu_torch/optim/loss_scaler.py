"""Dynamic loss scaling for fp16 training (counterpart of
``one_peace_tpu/optim/loss_scaler.py``).

The scale starts at ``init_scale`` (2**15), halves on a step whose gradients
are not finite (down to ``min_scale``, 1e-4) and doubles after
``scale_window`` (2000) finite steps in a row.  The scale is an fp32 value,
as the JAX state's ``jnp.float32`` is, and every update rounds as it does.
The trainer scales the loss before the backward, unscales the fp32
gradients before their norm, and updates the scale on every micro-step,
skipped ones included.  The state lives on the host: the trainer already
reads the finiteness of each step's gradient norm there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


SCALE_FACTOR = np.float32(2.0)
MIN_SCALE = np.float32(1e-4)


class LossScaler:
    """The JAX ``LossScaleState`` (``scale``, ``good_steps``) with
    ``update_loss_scale``, ``scale_loss`` and ``unscale_grads``."""

    def __init__(self, init_scale: float = 2.0**15, scale_window: int = 2000):
        self.scale = np.float32(init_scale)
        self.good_steps = 0
        self.scale_window = scale_window

    def update(self, grads_finite: bool) -> None:
        """Shrink on overflow, grow on a full window of good steps
        (``update_loss_scale``)."""
        grown = self.good_steps + 1 >= self.scale_window
        if grads_finite:
            if grown:
                self.scale = np.float32(self.scale * SCALE_FACTOR)
            self.good_steps = 0 if grown else self.good_steps + 1
        else:
            self.scale = np.maximum(np.float32(self.scale / SCALE_FACTOR), MIN_SCALE)
            self.good_steps = 0

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss * scale``, the scale cast to the loss's dtype first (a
        host scalar: no copy to the card, which would wait for it)."""
        return loss * torch.tensor(float(self.scale), dtype=loss.dtype)

    @torch.no_grad()
    def unscale_(self, grads: List[torch.Tensor]) -> None:
        """Multiply each fp32 gradient by the fp32 ``1 / scale``, in place
        (on the card, a few multi-tensor launches for all of them)."""
        torch._foreach_mul_(grads, float(np.float32(1.0) / self.scale))

    def state_dict(self) -> Dict[str, float]:
        return {"scale": float(self.scale), "good_steps": int(self.good_steps)}

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.scale = np.float32(state["scale"])
        self.good_steps = int(state["good_steps"])
