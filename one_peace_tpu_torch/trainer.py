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
  ``micro`` counts ``train_step`` calls;
- a criterion whose ``__call__`` takes ``num_updates`` gets the count of
  updates before this micro-step (``micro // update_freq``), which drives
  the classify model's ``freeze_finetune_updates``;
- a model's ``trainable_mask()`` (stage-2 pretraining) freezes parameters:
  the JAX ``Trainer`` gives them ``optax.set_to_zero`` updates, so that
  clipping and weight decay see only the trainable ones.  Here a frozen
  parameter takes no gradient at all (``requires_grad`` is off, so its
  weight-gradient GEMMs are never run) and stays out of AdamW, the clip
  and the accumulation; it keeps its compute-dtype copy.  ``gnorm`` is
  logged over the trainable gradients, where the JAX ``Trainer`` logs it
  over every gradient, frozen ones included (ROADMAP section 3).

The fp16 loss scaler, the EMA, Adan and ``valid_step`` are not ported yet;
a config that asks for the first three raises.
Everything runs on the device of the model's parameters.
"""

from __future__ import annotations

import copy
import inspect
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils import get_total_norm

from .core.config import FrameworkConfig

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
        try:
            params = inspect.signature(criterion.__call__).parameters
        except (TypeError, ValueError):
            params = {}
        self.takes_updates = "num_updates" in params

    def forward(self, batch, generator, num_updates: int):
        kw = {"num_updates": num_updates} if self.takes_updates else {}
        return self.criterion(self.model, batch, generator=generator, deterministic=False, **kw)


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
        trainable = model.trainable_mask() if hasattr(model, "trainable_mask") else {}
        self._names, self._params = [], []  # the trainable masters
        for name, p in model.named_parameters():
            if p.dtype != torch.float32:
                raise TypeError(f"master parameter {name} is {p.dtype}, not float32")
            p.requires_grad_(trainable.get(name, True))
            if p.requires_grad:
                self._names.append(name)
                self._params.append(p)
        self.device = next(model.parameters()).device

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

    def _compute_params(self, prefix: str = "model.") -> Dict[str, torch.Tensor]:
        """The parameters in the compute dtype (the masters themselves in
        fp32), named for ``functional_call`` on the criterion's module, or
        on the model itself with ``prefix=""``."""
        named = self.model.named_parameters()
        if self.compute_dtype == torch.float32:
            return {f"{prefix}{n}": p for n, p in named}
        return {f"{prefix}{n}": p.to(self.compute_dtype) for n, p in named}

    def gradients(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """(metrics, fp32 gradients of the trainable master parameters, in
        the order of ``_names``) of the loss on ``batch`` (numpy arrays or
        tensors, as the data pipeline collates them), computed on the
        compute-dtype copies; nothing is updated."""
        batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 .to(self.device) for k, v in batch.items()}
        loss, metrics = torch.func.functional_call(
            self._call, self._compute_params(),
            (batch, generator, self._micro // self._update_freq))
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
        """A host copy of the whole train state: parameters, optimizer state,
        the accumulation in progress, counters, generator and train time.
        Every tensor is copied to the CPU on its own, so the copy takes no
        device memory and shares no storage with the live state."""
        return {
            "params": {n: _host(p) for n, p in self.model.named_parameters()},
            "opt_state": _walk(self.optimizer.state_dict(), _host),
            "acc": None if self._acc is None else [_host(a) for a in self._acc],
            "mini": self._mini,
            "updates": self._updates,
            "step": self.step,
            "micro": self._micro,
            "rng": self.generator.get_state(),
            "train_time": self.train_time,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` bundle; its tensors are copied to the
        parameters' device, and the bundle stays unchanged by later steps."""
        for n, p in self.model.named_parameters():
            p.copy_(state["params"][n])
        opt = state["opt_state"]
        # the moments go to the device; AdamW's step counts stay host tensors
        self.optimizer.load_state_dict({
            "state": {i: {k: (v.clone() if k == "step" else v.to(self.device, copy=True))
                          if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                      for i, st in opt["state"].items()},
            "param_groups": copy.deepcopy(opt["param_groups"])})
        self._acc = None if state["acc"] is None else [
            a.to(self.device, copy=True) for a in state["acc"]]
        self._mini = int(state["mini"])
        self._updates = int(state["updates"])
        self.step = int(state["step"])
        self._micro = int(state["micro"])
        self.generator.set_state(state["rng"])
        self.train_time = float(state.get("train_time", 0.0))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _walk(node: Any, fn) -> Any:
    """``node`` (dicts, lists, tuples) with ``fn`` applied to every tensor;
    other leaves are copied."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _walk(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, fn) for v in node)
    return copy.copy(node)
