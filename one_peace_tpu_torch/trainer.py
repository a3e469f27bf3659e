"""Trainer: one optimizer step per ``train_step`` (counterpart of
``one_peace_tpu/trainer.py``).

What the JAX ``Trainer`` does inside one jitted step, in the same order:

- fp32 master parameters; the loss runs on copies of every float parameter
  in the compute dtype (``cast_floats``), through ``torch.func.
  functional_call``, so the gradients arrive in fp32 on the masters.  No
  ``torch.autocast``: its per-op casting rules are not the JAX package's;
- the non-finite skip: a step whose gradient norm is not finite changes
  neither the parameters nor the optimizer state nor the accumulation;
- ``update_freq`` accumulation as ``optax.MultiSteps``: the running mean of
  the micro-gradients, applied every ``update_freq``-th finite micro-step;
- global-norm clipping by optax's rule, ``g * min(1, c / ||g||)`` on the
  accumulated gradient (``clip_grad_norm_`` would add 1e-6 to the norm);
- AdamW groups with the layer decay and the no-decay set
  (``optim/adamw.py``), their lr set from the schedule at the count of
  applied updates, as ``scale_by_learning_rate`` counts;
- ``step`` counts optimizer updates (``micro // update_freq``) and
  ``micro`` counts ``train_step`` calls.

The fp16 loss scaler, the EMA, Adan, ``trainable_mask`` and ``valid_step``
are not ported yet; a config that asks for the first three raises.
Everything runs on the device of the model's parameters.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils import get_total_norm

from one_peace_tpu.core.config import FrameworkConfig

from .models.components import split_generator
from .optim import build_lr_schedule, build_optimizer


class _CriterionCall(nn.Module):
    """The criterion as a module over the model, so that one
    ``functional_call`` swaps the compute-dtype copies in for the whole
    loss, ``logit_scale_exp`` included."""

    def __init__(self, model: nn.Module, criterion):
        super().__init__()
        self.model = model
        self.criterion = criterion

    def forward(self, batch, generator):
        return self.criterion(self.model, batch, generator=generator, deterministic=False)


class Trainer:
    def __init__(self, cfg: FrameworkConfig, model: nn.Module, criterion,
                 total_updates: Optional[int] = None):
        if cfg.common.fp16:
            raise NotImplementedError("fp16 with loss scaling is not ported yet: use bf16")
        if cfg.ema.store_ema:
            raise NotImplementedError("the EMA is not ported yet")
        self.cfg = cfg
        self.model = model
        self.criterion = criterion
        self.compute_dtype = torch.bfloat16 if cfg.common.bf16 else torch.float32
        self._names, self._params = [], []
        for name, p in model.named_parameters():
            if p.dtype != torch.float32:
                raise TypeError(f"master parameter {name} is {p.dtype}, not float32")
            p.requires_grad_(True)
            self._names.append(name)
            self._params.append(p)
        self.device = self._params[0].device

        total = total_updates or cfg.optimization.max_update or 100000
        self.lr_schedule = build_lr_schedule(cfg.lr_scheduler, cfg.optimization, total)
        self.optimizer = build_optimizer(cfg.optimizer, cfg.optimization,
                                         zip(self._names, self._params),
                                         num_layers=cfg.model.encoder.layers)
        self._clip = cfg.optimization.clip_norm
        self._update_freq = max(int(cfg.optimization.update_freq), 1)
        self._acc = None   # running mean of this accumulation's micro-gradients
        self._mini = 0     # finite micro-steps in it
        self._updates = 0  # applied optimizer updates: the schedule's count
        self.step = 0
        self._micro = 0
        self.train_time = 0.0
        self.generator = torch.Generator().manual_seed(cfg.common.seed + 1)
        self._call = _CriterionCall(model, criterion)

    def _compute_params(self) -> Dict[str, torch.Tensor]:
        if self.compute_dtype == torch.float32:
            return {f"model.{n}": p for n, p in zip(self._names, self._params)}
        return {f"model.{n}": p.to(self.compute_dtype) for n, p in zip(self._names, self._params)}

    def gradients(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """(metrics, fp32 gradients of the master parameters) of the loss on
        ``batch`` (numpy arrays or tensors, as the data pipeline collates
        them), computed on the compute-dtype copies; nothing is updated."""
        batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 .to(self.device) for k, v in batch.items()}
        loss, metrics = torch.func.functional_call(self._call, self._compute_params(),
                                                   (batch, generator))
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self._params, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One micro-step on ``batch``.  Returns the metrics as floats."""
        t0 = time.time()
        metrics, grads = self.gradients(batch, split_generator(self.generator, 1)[0])
        gnorm = get_total_norm(grads)
        finite = bool(torch.isfinite(gnorm))
        lr = self.lr_schedule(self._micro // self._update_freq)
        if finite:
            self._accumulate(grads)
        del grads
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics.update(gnorm=float(gnorm), lr=lr, skipped=0.0 if finite else 1.0)
        self._micro += 1
        self.step = self._micro // self._update_freq
        metrics["step_time"] = time.time() - t0
        self.train_time += metrics["step_time"]
        return metrics

    @torch.no_grad()
    def _accumulate(self, grads) -> None:
        if self._update_freq == 1:
            self._apply(grads)
            return
        if self._acc is None:
            self._acc = [torch.zeros_like(g) for g in grads]
        for acc, g in zip(self._acc, grads):  # optax.MultiSteps' Welford mean
            acc.add_((g - acc) / (self._mini + 1))
        self._mini += 1
        if self._mini == self._update_freq:
            self._apply(self._acc)
            self._acc, self._mini = None, 0

    @torch.no_grad()
    def _apply(self, grads) -> None:
        if self._clip and self._clip > 0:  # in place: the gradients are ours
            factor = (self._clip / get_total_norm(grads)).clamp(max=1.0)
            for g in grads:
                g.mul_(factor)
        for p, g in zip(self._params, grads):
            p.grad = g
        lr = self.lr_schedule(self._updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self._updates += 1

    def state_dict(self) -> Dict[str, Any]:
        """A copy of the whole train state: parameters, optimizer state,
        the accumulation in progress, counters, generator and train time."""
        return {
            "params": {n: p.detach().clone() for n, p in zip(self._names, self._params)},
            "opt_state": copy.deepcopy(self.optimizer.state_dict()),
            "acc": None if self._acc is None else [a.clone() for a in self._acc],
            "mini": self._mini,
            "updates": self._updates,
            "step": self.step,
            "micro": self._micro,
            "rng": self.generator.get_state(),
            "train_time": self.train_time,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for n, p in zip(self._names, self._params):
            p.copy_(state["params"][n])
        self.optimizer.load_state_dict(copy.deepcopy(state["opt_state"]))
        self._acc = None if state["acc"] is None else [
            a.to(self.device).clone() for a in state["acc"]]
        self._mini = int(state["mini"])
        self._updates = int(state["updates"])
        self.step = int(state["step"])
        self._micro = int(state["micro"])
        self.generator.set_state(state["rng"])
        self.train_time = float(state.get("train_time", 0.0))
