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

Under an open process group (``torchrun``) the trainer runs data parallelism
and FSDP across the processes, as the JAX ``Trainer`` runs one jitted step
over its mesh:

- the mesh comes from ``cfg.distributed`` (``parallel.mesh``; a layout that
  does not match the world raises), and ``parallel.sharding.shard_model``
  places the parameters by the sharding rules with FSDP2 over the mesh's
  (``dp``, ``fsdp``) dimensions, even where they have size 1.  The root of
  the FSDP units is the criterion's module, so that every parameter is
  gathered for the whole loss.  FSDP gathers its parameters in the compute
  dtype and reduces their gradients in fp32; the replicated ones go through
  ``functional_call`` as compute-dtype copies, as every parameter does on one
  process, and the trainer all-reduces their gradients;
- each rank is given its contiguous slice of the global batch
  (``parallel.data.slice_rows``).  The criterion runs inside
  ``parallel.data.batch_rows``, which makes its contrastive gallery, its
  batch-wide counts and its random draws those of the global batch; the
  ranks' losses and metrics are merged weighted by their share of the
  batch, so they are the 1-rank values of the global batch;
- the gradient norm that clipping, ``gnorm`` and the non-finite skip read is
  global (an all-reduce over the shards), so a non-finite gradient on one
  rank skips the step, and moves the loss scale, on every rank;
- the accumulation, AdamW, Adan and the EMA shadow work on the sharded
  parameters, so their states stay sharded;
- ``state_dict`` gathers everything to the one-process layout on the host
  (every rank takes part; the caller writes it once), the optimizer state
  by parameter name, and ``load_state_dict`` takes such a bundle at any
  number of ranks.

Without a process group nothing is wrapped.
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import get_total_norm

from .core.config import FrameworkConfig

from .models.components import split_generator
from .optim import build_lr_schedule, build_optimizer
from .optim.loss_scaler import LossScaler
from .parallel.data import Rows, batch_rows, local_tensor
from .parallel.mesh import mesh_from_config, mesh_shape, world_size
from .parallel.sharding import fsdp_modules, shard_model
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
        for name, p in model.named_parameters():
            if p.dtype != torch.float32:
                raise TypeError(f"master parameter {name} is {p.dtype}, not float32")
            p.requires_grad_(trainable.get(name, True))
        self.device = next(model.parameters()).device
        self._call = _CriterionCall(model, criterion)
        d = cfg.distributed
        mesh_shape(d.dp, d.fsdp, d.tp, d.pp, d.sp, world_size())  # raises on a mismatch
        self.mesh = mesh_from_config(d, self.device) if dist.is_initialized() else None
        # the names of the parameters outside FSDP; None when nothing is wrapped
        self._replicated = None
        if self.mesh is not None:
            param_dtype = None if self.compute_dtype == torch.float32 else self.compute_dtype
            self._replicated = shard_model(self._call, model, self.mesh, param_dtype,
                                           shard_params=d.shard_params)
        self._names, self._params = [], []  # the trainable masters
        for name, p in model.named_parameters():
            if p.requires_grad:
                self._names.append(name)
                self._params.append(p)

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
        self.ema = EMA(cfg.ema, model.named_parameters()) if cfg.ema.store_ema else None

    def _compute_params(self, prefix: str = "model.",
                        source: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """The parameters (or ``source``, a tensor per parameter name: the
        EMA shadow) in the compute dtype (the tensors themselves in fp32),
        named for ``functional_call`` on the criterion's module, or on the
        model itself with ``prefix=""``."""
        named = self.model.named_parameters() if source is None else source.items()
        if self._replicated is not None:  # FSDP gathers the rest in the compute dtype
            named = [(n, p) for n, p in named if n in self._replicated]
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
        backward and the gradients unscaled after it.  Nothing is updated.
        Under FSDP ``batch`` is this rank's slice of the global batch, and
        the metrics and gradients are those of the global batch (the
        gradients sharded as their parameters are)."""
        if self._replicated is not None:
            return self._sharded_gradients(batch, generator)
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

    def _rows(self, batch: Dict[str, Any]) -> Rows:
        """Every rank's row count of its slice of the global batch."""
        local = next(len(v) for v in batch.values() if np.ndim(v) > 0)
        sizes = [torch.zeros(1, dtype=torch.int64, device=self.device)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(sizes, torch.tensor([local], dtype=torch.int64, device=self.device))
        sizes = [int(s) for s in sizes]
        if min(sizes) == 0:
            raise ValueError(f"a global batch of {sum(sizes)} rows leaves a rank without "
                             f"rows: every one of the {len(sizes)} ranks needs one")
        return Rows(sizes, dist.get_rank())

    def _merge(self, metrics: Dict[str, torch.Tensor], rows: Rows) -> Dict[str, torch.Tensor]:
        """The ranks' metrics weighted by their share of the batch, summed."""
        keys = sorted(metrics)
        flat = torch.stack([metrics[k].detach().to(torch.float64).reshape(()) for k in keys])
        flat = flat * rows.share
        dist.all_reduce(flat)
        return {k: flat[i].to(torch.float32) for i, k in enumerate(keys)}

    def _sharded_gradients(self, batch, generator):
        """``gradients`` under FSDP: each rank's loss weighted by its share of
        the batch, so that its gradients are its part of the one-process
        gradients (of their magnitude, which fp16 needs), summed over the
        ranks in fp32 by FSDP, and by one all-reduce for the replicated
        parameters."""
        rows = self._rows(batch)
        with batch_rows(rows):  # the backward's recomputes draw as the forward did
            loss, metrics = torch.func.functional_call(
                self._call, self._compute_params(),
                (self._to_device(batch), generator, self._micro // self._update_freq))
            loss = loss * rows.share
            if self.scaler is not None:
                loss = self.scaler.scale_loss(loss)
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self._params]
        for p in self._params:
            p.grad = None
        plain = [g for g in grads if not hasattr(g, "to_local")]
        if plain:  # the replicated parameters: one all-reduce for all of them
            flat = torch.cat([g.reshape(-1) for g in plain])
            dist.all_reduce(flat)
            for g, part in zip(plain, flat.split([g.numel() for g in plain])):
                g.copy_(part.view_as(g))
        if self.scaler is not None:
            self.scaler.unscale_([local_tensor(g) for g in grads])
        return self._merge(metrics, rows), grads

    def _total_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of ``grads``: sharded gradients reduced over
        their shards."""
        if self._replicated is None:
            return get_total_norm(grads)
        sharded = [g for g in grads if hasattr(g, "to_local")]
        plain = [g for g in grads if not hasattr(g, "to_local")]
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        if sharded:
            sq = sq + get_total_norm(sharded).full_tensor() ** 2
        if plain:
            sq = sq + get_total_norm(plain) ** 2
        return sq.sqrt()

    @torch.no_grad()
    def valid_step(self, batch: Dict[str, Any], fetch: bool = False):
        """The criterion's metrics on ``batch``, without a gradient,
        deterministic, on the compute-dtype copies.  Tensors, or floats with
        ``fetch``.  Under FSDP every rank calls it on its slice, and the
        metrics are those of the global batch."""
        rows = self._rows(batch) if self._replicated is not None else None
        with batch_rows(rows):
            _, metrics = torch.func.functional_call(
                self._call, self._compute_params(),
                (self._to_device(batch), None, self._micro // self._update_freq, True))
        if rows is not None:
            metrics = self._merge(metrics, rows)
        if fetch:
            return {k: float(v) for k, v in metrics.items()}
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One micro-step on ``batch``.  Returns the metrics as floats."""
        t0 = time.time()
        metrics, grads = self.gradients(batch, split_generator(self.generator, 1)[0])
        gnorm = self._total_norm(grads)
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
            acc, g = local_tensor(acc), local_tensor(g)
            acc.add_((g - acc) / (self._mini + 1))
        self._mini += 1
        if self._mini == self._update_freq:
            self._apply(self._acc)
            self._acc, self._mini = None, 0

    @torch.no_grad()
    def _apply(self, grads) -> None:
        if self._clip and self._clip > 0:  # in place: the gradients are ours
            factor = (self._clip / self._total_norm(grads)).clamp(max=1.0)
            for g in grads:
                local_tensor(g).mul_(factor)
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
        shares no storage with the live state.  The optimizer state is kept
        by parameter name.  Under FSDP the shards are gathered to the
        one-process layout: every rank must call it."""
        state = {
            "params": {n: _host(p) for n, p in self.model.named_parameters()},
            "opt_state": self._named_opt_state(),
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

    def _opt_names(self) -> List[str]:
        """The optimizer's parameters by name, in its state's index order."""
        return [n for group in self.optimizer.param_groups for n in group["names"]]

    def _named_opt_state(self) -> Dict[str, Any]:
        sd = self.optimizer.state_dict()
        names = self._opt_names()
        return {"state": {names[i]: _walk(st, _host) for i, st in sd["state"].items()},
                "param_groups": _walk([{k: v for k, v in g.items() if k != "params"}
                                       for g in sd["param_groups"]], _host)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` bundle, saved at any number of ranks; its
        tensors are copied to the parameters' device (their shards, under
        FSDP), and the bundle stays unchanged by later steps."""
        for n, p in self.model.named_parameters():
            local_tensor(p).copy_(_piece(state["params"][n], p))
        opt = state["opt_state"]
        current = self.optimizer.state_dict()
        if all(isinstance(k, str) for k in opt["state"]):
            # by name: the moments go to the device as shards of their
            # parameters; AdamW's step counts stay host tensors
            by_name = dict(zip(self._opt_names(), self._params_in_opt_order()))
            loaded = {}
            for i, name in enumerate(self._opt_names()):
                if name in opt["state"]:
                    p = by_name[name]
                    loaded[i] = {k: (v.clone() if k == "step" else _dist_like(v, p))
                                 if isinstance(v, torch.Tensor) else v
                                 for k, v in opt["state"][name].items()}
            self.optimizer.load_state_dict({"state": loaded,
                                            "param_groups": current["param_groups"]})
        else:  # an index-keyed bundle of an earlier version, same grouping
            self.optimizer.load_state_dict({
                "state": {i: {k: (v.clone() if k == "step" else v.to(self.device, copy=True))
                              if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                          for i, st in opt["state"].items()},
                "param_groups": copy.deepcopy(opt["param_groups"])})
        self._acc = None if state["acc"] is None else [
            _dist_like(a, p) for a, p in zip(state["acc"], self._params)]
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
                local_tensor(s).copy_(_piece(state["ema_shadow"][n], s))

    def full_params(self, source: Optional[Dict[str, torch.Tensor]] = None):
        """The parameters (or ``source``, the EMA shadow) in the one-process
        layout for an export: ``source`` itself unless the model is sharded,
        else a host copy of every tensor gathered from its shards (every
        rank must call it)."""
        if self._replicated is None:
            return source
        named = self.model.named_parameters() if source is None else source.items()
        return {n: _host(p) for n, p in named}

    def _params_in_opt_order(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    @contextlib.contextmanager
    def eval_params(self, source: Optional[Dict[str, torch.Tensor]] = None):
        """The parameters validation runs on, for ``functional_call`` on the
        model: the compute-dtype copies of the masters, or of ``source`` (the
        EMA shadow).  Under FSDP every unit is gathered in the compute dtype
        for the whole block (the shadow's shards swapped in first, where it
        is given), so that each rank evaluates its own rows with no
        collective, and the copies cover the replicated parameters only."""
        if self._replicated is None:
            with torch.no_grad():
                yield self._compute_params(prefix="", source=source)
            return
        units = fsdp_modules(self._call)
        if units:  # the root's lazy init, if no step has run it yet
            self._call._get_fsdp_state()._lazy_init()
        saved = []
        with torch.no_grad():
            if source is not None:
                for n, p in self.model.named_parameters():
                    if hasattr(p, "to_local"):
                        saved.append((p, local_tensor(p).clone()))
                        local_tensor(p).copy_(local_tensor(source[n]))
            for unit in units:
                unit.unshard()
            for unit in units:
                unit.set_reshard_after_forward(False, recurse=False)
            params = self._compute_params(prefix="", source=source)
        try:
            yield params
        finally:
            del params
            with torch.no_grad():
                for unit in units:
                    unit.set_reshard_after_forward(unit is not self._call, recurse=False)
                    unit.reshard()
                for p, value in saved:
                    local_tensor(p).copy_(value)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, gathered from its shards where it has them."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().to("cpu", copy=True)


def _piece(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full`` in the layout of ``like`` (an FSDP
    parameter), or ``full`` itself for a plain tensor."""
    if not hasattr(like, "device_mesh"):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def _dist_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A device copy of ``full`` laid out as ``like`` (a ``DTensor`` of its
    shards under FSDP)."""
    if not hasattr(like, "device_mesh"):
        return full.to(like.device, copy=True)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device, copy=True), like.device_mesh, like.placements,
                             src_data_rank=None)


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
