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

Model parallelism over the layout's other axes (``parallel.mesh.Layout``):

- ``tp``: ``tensor_parallel.shard_model_`` cuts the model to this rank's
  slices before FSDP wraps it (FSDP then shards the slices over ``fsdp``);
- ``pp``: the model's ``enable_pipeline`` keeps this stage's layers, which
  stay outside FSDP (replicated over the data ranks);
- ``sp``: ring attention reads the layout (``ops.attention``);
- the batch layout, the metrics' merge and the replicated gradients'
  all-reduce go over the *data* ranks only; the parameters that run before
  the pipeline (the adapters, each stage holding a part of their gradient:
  stage 0 the input's, every stage its layers' share of the rel-pos bias)
  are summed over ``pp`` first.  The gradient norm counts the ``tp``- and
  ``pp``-owned gradients once each (their squares summed over their
  group), a replicated one once; whether it is finite is agreed by the
  whole world;
- ``state_dict``, ``full_params`` and the EMA's exports hold full tensors
  under every layout (the ``tp`` slices gathered, every stage's layers),
  with the names and values of a one-process run, and ``load_state_dict``
  takes such a bundle under any layout, each rank cutting what it keeps.

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
from .parallel import tensor_parallel
from .parallel.data import Rows, batch_rows, local_tensor
from .parallel.mesh import check_split, make_layout, mesh_shape, world_size
from .parallel.sharding import fsdp_modules, pipelined_params, shard_model
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
        # the trainable parameters' names in the one-process layout
        self._all_names = [n for n, p in model.named_parameters() if p.requires_grad]
        self._call = _CriterionCall(model, criterion)
        d = cfg.distributed
        mesh_shape(d.dp, d.fsdp, d.tp, d.pp, d.sp, world_size())  # raises on a mismatch
        if d.tp > 1:
            tensor_parallel.check_model(model)
        if d.sp > 1:
            tensor_parallel.check_sequence_parallel(model)
        fusion = tensor_parallel.fusion_model(model)
        if (d.tp > 1 or d.pp > 1) and fusion:
            encoders = [model.cfg.encoder] + ([model.cfg.decoder]
                                              if hasattr(model, "decoder_wrapper") else [])
            check_split(encoders, d.tp, d.pp)
        self.layout = make_layout(d, self.device) if dist.is_initialized() else None
        self.mesh = None if self.layout is None else self.layout.mesh
        self._tp_dims: Dict[str, int] = {}      # tp-split parameters: their dimension
        self._pp_owned: set = set()             # this stage's layers' parameters
        self._pp_partial: tuple = ()            # name prefixes of what runs before the pipeline
        if self.layout is not None and self.layout.size("tp") > 1:
            self._tp_dims = tensor_parallel.shard_model_(model, self._shard("tp"))
        if self.layout is not None and self.layout.size("pp") > 1 and fusion:
            # the fusion encoder's layers only: the pretrain decoder stays
            # whole (~1% of the FLOPs, its depth rarely divides ``pp``) and
            # the vision trunks replicated, as in JAX
            self._pp_partial = tuple("encoder_wrapper." + p for p in
                                     model.encoder_wrapper.enable_pipeline(
                                         self._shard("pp"), self.layout.ranks["pp"],
                                         d.pp_micro_batches))
            self._pp_owned = pipelined_params(model)
        # the names of the parameters outside FSDP; None when nothing is wrapped
        self._replicated = None
        if self.mesh is not None:
            param_dtype = None if self.compute_dtype == torch.float32 else self.compute_dtype
            self._replicated = shard_model(self._call, model, self.mesh, param_dtype,
                                           shard_params=d.shard_params, exclude=self._pp_owned)
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

    def _shard(self, axis: str) -> "tensor_parallel.Shard":
        layout = self.layout
        return tensor_parallel.Shard(layout.group(axis), layout.rank(axis), layout.size(axis))

    def _sum_over(self, tensors: List[torch.Tensor], axis: str) -> None:
        """Sum ``tensors`` (local tensors) in place over the layout's
        ``axis`` ranks, in one all-reduce."""
        if not tensors or self.layout is None or self.layout.size(axis) == 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.layout.group(axis))
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

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
        n = self.layout.size("data")
        sizes = [torch.zeros(1, dtype=torch.int64, device=self.device) for _ in range(n)]
        mine = torch.tensor([local], dtype=torch.int64, device=self.device)
        if n > 1:
            dist.all_gather(sizes, mine, group=self.layout.group("data"))
        else:
            sizes = [mine]
        sizes = [int(s) for s in sizes]
        if min(sizes) == 0:
            raise ValueError(f"a global batch of {sum(sizes)} rows leaves a rank without "
                             f"rows: every one of the {len(sizes)} ranks needs one")
        return Rows(sizes, self.layout.rank("data"))

    def _merge(self, metrics: Dict[str, torch.Tensor], rows: Rows) -> Dict[str, torch.Tensor]:
        """The ranks' metrics weighted by their share of the batch, summed."""
        keys = sorted(metrics)
        flat = torch.stack([metrics[k].detach().to(torch.float64).reshape(()) for k in keys])
        flat = flat * rows.share
        if len(rows.sizes) > 1:
            dist.all_reduce(flat, group=self.layout.group("data"))
        return {k: flat[i].to(torch.float32) for i, k in enumerate(keys)}

    def _sharded_gradients(self, batch, generator):
        """``gradients`` under FSDP: each rank's loss weighted by its share of
        the batch, so that its gradients are its part of the one-process
        gradients (of their magnitude, which fp16 needs), summed over the
        data ranks in fp32 by FSDP, and by one all-reduce for the replicated
        parameters; those before a pipeline summed over ``pp`` first."""
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
        if self._pp_partial:  # each stage holds a part of these
            self._sum_over([local_tensor(g) for n, g in zip(self._names, grads)
                            if n.startswith(self._pp_partial)], "pp")
        # the replicated parameters: one all-reduce for all of them
        self._sum_over([g for g in grads if not hasattr(g, "to_local")], "data")
        if self.scaler is not None:
            self.scaler.unscale_([local_tensor(g) for g in grads])
        return self._merge(metrics, rows), grads

    def _total_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of ``grads`` (in the order of ``_names``):
        FSDP's gradients reduced over their shards, the squares of the
        ``tp``-split and of this stage's gradients summed over ``tp`` and
        ``pp``, a replicated gradient counted once."""
        if self._replicated is None:
            return get_total_norm(grads)
        sq = torch.zeros(4, dtype=torch.float32, device=self.device)
        for k, (tp, pp) in enumerate(((False, False), (True, False), (False, True),
                                      (True, True))):
            kind = [g for n, g in zip(self._names, grads)
                    if (n in self._tp_dims) == tp and (n in self._pp_owned) == pp]
            sharded = [g for g in kind if hasattr(g, "to_local")]
            plain = [g for g in kind if not hasattr(g, "to_local")]
            if sharded:
                sq[k] += get_total_norm(sharded).full_tensor().float() ** 2
            if plain:
                sq[k] += get_total_norm(plain).float() ** 2
        for axis, cut in (("tp", [1, 3]), ("pp", [2, 3])):
            if self.layout.size(axis) > 1:
                part = sq[cut].clone()
                dist.all_reduce(part, group=self.layout.group(axis))
                sq[cut] = part
        return sq.sum().sqrt()

    def _finite(self, gnorm: torch.Tensor) -> bool:
        """Whether ``gnorm`` is finite on every rank of the world."""
        ok = torch.isfinite(gnorm).to(torch.float32).reshape(1)
        if self.layout is not None and dist.get_world_size() > 1:
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return bool(ok)

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
        finite = self._finite(gnorm)
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
        acc = None
        if self._acc is not None:
            acc = self._gathered(zip(self._names, self._acc))
            acc = [acc[n] for n in self._all_names]
        state = {
            "params": self._gathered(self.model.named_parameters()),
            "opt_state": self._named_opt_state(),
            "acc": acc,
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
            state["ema_shadow"] = self._gathered(self.ema.shadow.items())
        return state

    def _opt_names(self) -> List[str]:
        """The optimizer's parameters by name, in its state's index order."""
        return [n for group in self.optimizer.param_groups for n in group["names"]]

    def _host_full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A host copy of the tensor ``t`` of parameter ``name`` (the
        parameter, its gradient, a moment, the EMA shadow) in the
        one-process layout: gathered from its FSDP shards, and its ``tp``
        slices all-gathered."""
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        if name in self._tp_dims and t.ndim > 0:
            shard = self._shard("tp")
            parts = [torch.empty_like(t) for _ in range(shard.size)]
            dist.all_gather(parts, t.detach().contiguous(), group=shard.group)
            t = torch.cat(parts, dim=self._tp_dims[name])
        return t.detach().to("cpu", copy=True)

    def _gathered(self, named) -> Dict[str, torch.Tensor]:
        """``_host_full`` of every (name, tensor), every pipeline stage's
        merged in (every rank must call it)."""
        out = {n: self._host_full(n, t) for n, t in named}
        return self._merge_stages(out)

    def _merge_stages(self, out: Dict[str, Any]) -> Dict[str, Any]:
        if not self._pp_owned:
            return out
        parts = [None] * self.layout.size("pp")
        dist.all_gather_object(parts, {n: v for n, v in out.items() if n in self._pp_owned},
                               group=self.layout.group("pp"))
        for part in parts:
            out.update(part)
        return out

    def _mine(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's ``tp`` slice of a full tensor of parameter ``name``."""
        if name not in self._tp_dims or full.ndim == 0:
            return full
        shard = self._shard("tp")
        return tensor_parallel.chunk_of(full, self._tp_dims[name], shard.rank, shard.size)

    def _named_opt_state(self) -> Dict[str, Any]:
        sd = self.optimizer.state_dict()
        names = self._opt_names()
        state = {names[i]: _walk(st, lambda t, n=names[i]: self._host_full(n, t))
                 for i, st in sd["state"].items()}
        return {"state": self._merge_stages(state),
                "param_groups": _walk([{k: v for k, v in g.items() if k != "params"}
                                       for g in sd["param_groups"]], _host)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` bundle, saved at any number of ranks; its
        tensors are copied to the parameters' device (their shards, under
        FSDP), and the bundle stays unchanged by later steps."""
        for n, p in self.model.named_parameters():
            local_tensor(p).copy_(_piece(self._mine(n, state["params"][n]), p))
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
                    loaded[i] = {k: (v.clone() if k == "step"
                                     else _dist_like(self._mine(name, v), p))
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
        self._acc = None
        if state["acc"] is not None:
            acc = dict(zip(self._all_names, state["acc"]))
            self._acc = [_dist_like(self._mine(n, acc[n]), p)
                         for n, p in zip(self._names, self._params)]
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
                local_tensor(s).copy_(_piece(self._mine(n, state["ema_shadow"][n]), s))

    def full_params(self, source: Optional[Dict[str, torch.Tensor]] = None):
        """The parameters (or ``source``, the EMA shadow) in the one-process
        layout for an export: ``source`` itself unless the model is sharded,
        else a host copy of every tensor gathered from its shards (every
        rank must call it)."""
        if self._replicated is None:
            return source
        named = self.model.named_parameters() if source is None else source.items()
        return self._gathered(named)

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
