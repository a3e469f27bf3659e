"""Tensor parallelism written by hand (the JAX package has no counterpart
module: XLA partitions its model from the rules' ``tp`` entries,
``parallel/sharding.py``, and inserts these collectives itself).

Every ``tp`` rank computes the same loss on the same activations outside
the split layers, so the collectives come in pairs whose backward is what
that implies (``Megatron``'s f and g):

- ``copy_to``: identity forward, gradient all-reduced in the backward: the
  input of a column-parallel product, whose ranks each add their heads'
  (or FFN columns') part of dx;
- ``reduce_from``: all-reduce forward, identity backward: the output of a
  row-parallel product.  ``torch.distributed.nn.functional.all_reduce``
  all-reduces the gradient again, which gives ``tp`` times the gradient here,
  since every rank holds the whole loss downstream;
- ``slice_from``: a replicated leaf's (or activation's) own chunk forward,
  the gradient all-gathered in the backward (q/v biases, the per-head gains,
  the Magneto LN's affine, the rel-pos tables by head; ring attention's
  sequence chunk over ``sp``);
- ``gather_to``: all-gather forward, own chunk of the gradient backward (a
  column-parallel head's output; ring attention's output over ``sp``);
- ``layer_norm``: a LayerNorm over a feature axis that the ranks split (the
  Magneto LN over the heads' outputs, ``ffn_ln`` over the FFN width): the
  row mean and variance are all-reduced, and so are the two row reductions
  of its backward.

Each takes a ``Shard`` (process group, this rank's index, the count);
``None`` or a count of 1 makes it the plain local operation.

``shard_model_`` turns a whole fusion-encoder model (retrieval, classify,
pretrain) into this rank's part: every parameter whose sharding rule names
``tp`` is cut to its slice along that dimension, and the attention layers,
the FFNs, the projection heads and the adapters' rel-pos gathers are told
the ``Shard``.  The detection, segmentation and video trunks and int8
layers under ``tp`` are refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class Shard:
    """A process group split: the group, this rank's index, their count."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def __repr__(self):
        return f"Shard(rank={self.rank}, size={self.size})"


def _active(shard: Optional[Shard]) -> bool:
    return shard is not None and shard.size > 1


def chunk_of(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s chunk of ``x``'s ``size`` equal chunks along ``dim``,
    contiguous: a view where the chunk is one already (its start need not
    be 16-byte aligned; ``ops.flash_attention.flash_attention`` copies a
    bias that is not)."""
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


def _all_gather(x: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x.contiguous(), group=shard.group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=shard.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SliceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return chunk_of(x, dim, shard.rank, shard.size)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.shard), None, None


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _all_gather(x, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return chunk_of(grad, ctx.dim, ctx.shard.rank, ctx.shard.size), None, None


def copy_to(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    return _CopyTo.apply(x, shard) if _active(shard) else x


def reduce_from(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    return _ReduceFrom.apply(x, shard) if _active(shard) else x


def slice_from(x: Optional[torch.Tensor], dim: int, shard: Optional[Shard]):
    if x is None or not _active(shard):
        return x
    return _SliceFrom.apply(x, dim, shard)


def gather_to(x: torch.Tensor, dim: int, shard: Optional[Shard]) -> torch.Tensor:
    return _GatherTo.apply(x, dim, shard) if _active(shard) else x


class _LayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis split over ``shard``: eps 1e-5, biased
    variance, statistics and affine in fp32 (``components.layer_norm``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, shard, eps):
        xf = x.float()
        n = xf.shape[-1] * shard.size
        mean = _all_reduce(xf.sum(-1, keepdim=True), shard) / n
        centred = xf - mean
        var = _all_reduce((centred * centred).sum(-1, keepdim=True), shard) / n
        rstd = torch.rsqrt(var + eps)
        xhat = centred * rstd
        ctx.save_for_backward(xhat, rstd, weight)
        ctx.shard, ctx.n, ctx.dtypes = shard, n, (x.dtype, weight.dtype, bias.dtype)
        return (xhat * weight.float() + bias.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        xhat, rstd, weight = ctx.saved_tensors
        gf = grad.float()
        g = gf * weight.float()
        sums = torch.cat([g.sum(-1, keepdim=True), (g * xhat).sum(-1, keepdim=True)], -1)
        sums = _all_reduce(sums, ctx.shard) / ctx.n
        dx = rstd * (g - sums[..., :1] - xhat * sums[..., 1:])
        rows = tuple(range(gf.ndim - 1))
        dw = (gf * xhat).sum(rows)
        db = gf.sum(rows)
        x_dtype, w_dtype, b_dtype = ctx.dtypes
        return dx.to(x_dtype), dw.to(w_dtype), db.to(b_dtype), None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               shard: Optional[Shard], eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of x, whose last axis is this rank's part of the normalised
    one, with this part's ``weight`` and ``bias``."""
    if not _active(shard):
        from ..models.components import layer_norm as plain

        return plain(x, weight, bias, eps)
    return _LayerNorm.apply(x, weight, bias, shard, eps)


def column_linear(x: torch.Tensor, linear: nn.Module, shard: Optional[Shard],
                  gather: bool = False) -> torch.Tensor:
    """``linear`` whose weight holds this rank's rows (output features): x
    enters through ``copy_to``, a replicated bias through ``slice_from``;
    ``gather`` all-gathers the outputs to the whole width."""
    if not _active(shard):
        return linear(x)
    y = F.linear(copy_to(x, shard), linear.weight, slice_from(linear.bias, 0, shard))
    return gather_to(y, -1, shard) if gather else y


def row_linear(x: torch.Tensor, linear: nn.Module, shard: Optional[Shard]) -> torch.Tensor:
    """``linear`` whose weight holds this rank's columns (input features):
    the partial products are all-reduced, then the bias is added."""
    if not _active(shard):
        return linear(x)
    y = reduce_from(F.linear(x, linear.weight), shard)
    return y if linear.bias is None else y + linear.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def tp_dims(model: nn.Module) -> Dict[str, int]:
    """The dimension each parameter is split on over ``tp`` by the sharding
    rules, by name."""
    from .sharding import param_specs

    return {name: spec.index("tp") for name, spec in param_specs(model).items() if "tp" in spec}


def fusion_model(model: nn.Module) -> bool:
    """Whether ``model`` is one of the fusion-encoder models that ``tp``,
    ``sp`` and ``pp`` split (retrieval, classify, pretrain: those with an
    ``enable_pipeline`` in the JAX package); the video classifier holds an
    ``encoder_wrapper`` too, but is a vision trunk."""
    from ..models.classify import OnePeaceClassifyModel
    from ..models.one_peace import OnePeaceRetrievalModel
    from ..models.pretrain import OnePeacePretrainModel

    return isinstance(model, (OnePeaceRetrievalModel, OnePeaceClassifyModel,
                              OnePeacePretrainModel))


def check_model(model: nn.Module) -> None:
    """Refuse what ``shard_model_`` does not split: the detection,
    segmentation and video trunks, and int8 layers."""
    from ..ops.quant import QuantizedLinear

    if not fusion_model(model):
        raise NotImplementedError(
            f"distributed.tp > 1 for {type(model).__name__}: tensor parallelism of the "
            f"detection, segmentation and video trunks is not ported yet (the fusion-encoder "
            f"models are)")
    if any(isinstance(m, QuantizedLinear) for m in model.modules()):
        raise NotImplementedError("distributed.tp > 1 with int8 layers (w_q / w_scale): "
                                  "int8 under tensor parallelism is not ported (the JAX "
                                  "package serves int8 without a mesh)")


def check_sequence_parallel(model: nn.Module) -> None:
    """Refuse ``sp`` > 1 where the ring cannot run: sequence parallelism
    runs the fusion encoder's attention as a ring over the whole sequence's
    activations (``attn_impl=ring``, ``ops.attention``); a sequence-sharded
    layer stack, every layer's activations split over ``sp``, is not
    ported."""
    if not fusion_model(model) or model.cfg.encoder.attn_impl != "ring":
        raise NotImplementedError(
            "distributed.sp > 1 runs ring attention in the fusion encoder "
            "(model.encoder.attn_impl=ring); a sequence-sharded layer stack under sp is not "
            "ported")


@torch.no_grad()
def shard_model_(model: nn.Module, shard: Shard) -> Dict[str, int]:
    """Cut ``model`` to this rank's part in place (see the module's
    docstring); returns ``tp_dims``, the split dimension by parameter name."""
    from ..models.adapters.audio import AudioAdapter
    from ..models.adapters.image import ImageAdapter
    from ..models.adapters.text import TextAdapter
    from ..models.encoder import Attention, GeGLU

    check_model(model)
    dims = tp_dims(model)
    for name, dim in dims.items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        if p.shape[dim] % shard.size:
            raise ValueError(f"distributed.tp={shard.size} does not divide {name}'s "
                             f"dimension {dim} of size {p.shape[dim]}")
        part = chunk_of(p.detach(), dim, shard.rank, shard.size).clone()
        setattr(module, leaf, nn.Parameter(part, requires_grad=p.requires_grad))
    for module in model.modules():
        if isinstance(module, (Attention, GeGLU, TextAdapter, ImageAdapter, AudioAdapter)):
            module.tp = shard
    if hasattr(model, "tp_heads"):  # the retrieval and pretrain models' projections
        model.tp_heads = shard
    return dims
