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
  (``optim/adamw.py``), or Adan (``optim/adan.py``), their lr set from the
  schedule at the count of applied updates, as ``scale_by_learning_rate``
  counts;
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

- ``common.fp16`` (it wins over ``common.bf16``, as in JAX) computes in
  fp16 with dynamic loss scaling (``optim/loss_scaler.py``): the loss is
  scaled before the backward, the fp32 gradients unscaled before their
  norm, and the scale updated on every micro-step, skipped ones included;
  ``loss_scale`` is logged;
- ``ema.store_ema`` keeps an EMA of every parameter (``utils/ema.py``),
  stepped on accumulation boundaries after the update, and held still by a
  skipped step;
- ``valid_step`` scores the criterion's metrics without a gradient,
  deterministically, on the compute-dtype copies.

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
from .optim.loss_scaler import LossScaler
from .utils.ema import EMA


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

    def forward(self, batch, generator, num_updates: int, deterministic: bool = False):
        kw = {"num_updates": num_updates} if self.takes_updates else {}
        return self.criterion(self.model, batch, generator=generator,
                              deterministic=deterministic, **kw)


class Trainer:
    def __init__(self, cfg: FrameworkConfig, model: nn.Module, criterion,
                 total_updates: Optional[int] = None):
        self.cfg = cfg
        self.model = model
        self.criterion = criterion
        if cfg.common.fp16:
            self.compute_dtype = torch.float16
        elif cfg.common.bf16:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self.scaler = LossScaler() if cfg.common.fp16 else None
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
        self.ema = EMA(cfg.ema, model.named_parameters()) if cfg.ema.store_ema else None

    def _compute_params(self, prefix: str = "model.",
                        source: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """The parameters (or ``source``, a tensor per parameter name: the
        EMA shadow) in the compute dtype (the tensors themselves in fp32),
        named for ``functional_call`` on the criterion's module, or on the
        model itself with ``prefix=""``."""
        named = self.model.named_parameters() if source is None else source.items()
        if self.compute_dtype == torch.float32:
            return {f"{prefix}{n}": p for n, p in named}
        return {f"{prefix}{n}": p.to(self.compute_dtype) for n, p in named}

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                .to(self.device) for k, v in batch.items()}

    def gradients(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """(metrics, fp32 gradients of the trainable master parameters, in
        the order of ``_names``) of the loss on ``batch`` (numpy arrays or
        tensors, as the data pipeline collates them), computed on the
        compute-dtype copies; under fp16 the loss is scaled before the
        backward and the gradients unscaled after it.  Nothing is updated."""
        loss, metrics = torch.func.functional_call(
            self._call, self._compute_params(),
            (self._to_device(batch), generator, self._micro // self._update_freq))
        if self.scaler is not None:
            loss = self.scaler.scale_loss(loss)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self._params, grads)]
        if self.scaler is not None:
            self.scaler.unscale_(grads)
        return {k: v.detach() for k, v in metrics.items()}, grads

    @torch.no_grad()
    def valid_step(self, batch: Dict[str, Any], fetch: bool = False):
        """The criterion's metrics on ``batch``, without a gradient,
        deterministic, on the compute-dtype copies.  Tensors, or floats with
        ``fetch``."""
        _, metrics = torch.func.functional_call(
            self._call, self._compute_params(),
            (self._to_device(batch), None, self._micro // self._update_freq, True))
        if fetch:
            return {k: float(v) for k, v in metrics.items()}
        return {k: v.detach() for k, v in metrics.items()}

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
        if self.scaler is not None:
            self.scaler.update(finite)
            metrics["loss_scale"] = float(self.scaler.scale)
        metrics.update(gnorm=float(gnorm), lr=lr, skipped=0.0 if finite else 1.0)
        self._micro += 1
        self.step = self._micro // self._update_freq
        if self.ema is not None and self._micro % self._update_freq == 0:
            # once per optimizer update, after it (the JAX gate: on the
            # micro-step count, with that micro-step's skip)
            self.ema.step(self.model.named_parameters(), self.step, skipped=not finite)
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
            group["schedule_lr"] = lr  # Adan's proximal decay takes it unscaled
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self._updates += 1

    def state_dict(self) -> Dict[str, Any]:
        """A host copy of the whole train state: parameters, optimizer state,
        the accumulation in progress, counters, generator and train time, and
        the loss scale and the EMA shadow where there are.  Every tensor is
        copied to the CPU on its own, so the copy takes no device memory and
        shares no storage with the live state."""
        state = {
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
        if self.scaler is not None:
            state["loss_scale"] = self.scaler.state_dict()
        if self.ema is not None:
            state["ema_shadow"] = {n: _host(s) for n, s in self.ema.shadow.items()}
        return state

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
        if "loss_scale" in state and self.scaler is not None:
            self.scaler.load_state_dict(state["loss_scale"])
        if "ema_shadow" in state and self.ema is not None:
            for n, s in self.ema.shadow.items():
                s.copy_(state["ema_shadow"][n])


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
