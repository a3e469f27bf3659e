"""Parameter sharding rules and their FSDP2 placement (counterpart of
``one_peace_tpu/parallel/sharding.py``).

``_RULES`` are the JAX package's rules on the port's parameter names: one
module per layer (no stacked ``layers`` axis) and torch's layouts (a dense
``weight`` is (out, in), an int8 ``w_q`` (out, in)), so a JAX spec
``P(None, "fsdp", "tp")`` on a stacked (L, in, out) kernel is
``("tp", "fsdp")`` here.  The first match wins; a leaf that no rule matches
is replicated (LN scales, LayerScale gammas, rel-pos tables, conv stacks,
heads).  The JAX rules key on the leaf's rank as well, and the detection
trunk stacks its windowed layers on two axes (``win_layers``: groups,
period - 1), so no rule reaches them: ``param_specs`` leaves those layers
replicated as the JAX package does, and shards the global ones.

The ``tp`` entries are kept for the model-parallel slice; this slice places
the ``fsdp`` entries only.  ``shard_model`` applies them with FSDP2:
``fully_shard`` on each layer of a stack (the fusion encoder's, the pretrain
decoder's, the detection, segmentation and video trunks'), then on the root,
over the mesh's (``dp``, ``fsdp``) dimensions (HSDP: sharded over ``fsdp``,
replicated over ``dp``, gradients reduce-scattered over ``fsdp`` and
all-reduced over ``dp``, summed: each rank's loss is its share of the global
batch's).  A rule's ``fsdp`` dimension becomes the
parameter's ``Shard`` dimension.  The replicated leaves stay outside FSDP
(``ignored_params``): full fp32 tensors on every rank, which the trainer
casts to the compute dtype with the rest of its copies and whose gradients
it all-reduces itself.  ``shard_params=False`` (the config's
``distributed.shard_params``) replicates every leaf.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch import nn

Spec = Tuple[Optional[str], ...]

_LAYER = r"layers\.\d+\."
_FFN = _LAYER + r"(text|image|audio)_ffn\."
_ATTN = _LAYER + r"self_attn\."

# (regex on the parameter's name, spec by the leaf's rank)
_RULES: List[Tuple[str, Dict[int, Spec]]] = [
    # attention projections: q/k/v column-parallel, out row-parallel; fsdp
    # shards the other dimension
    (_ATTN + r"(q_proj|k_proj|v_proj)\.weight$", {2: ("tp", "fsdp")}),
    (_ATTN + r"out_proj\.weight$", {2: ("fsdp", "tp")}),
    (_ATTN + r"(q_proj|v_proj|out_proj)\.bias$", {1: (None,)}),
    # GeGLU FFN: wi_* column-parallel (F, D), wo row-parallel (D, F)
    (_FFN + r"(wi_0|wi_1)\.weight$", {2: ("tp", "fsdp")}),
    (_FFN + r"wo\.weight$", {2: ("fsdp", "tp")}),
    (_FFN + r"wo\.bias$", {1: (None,)}),
    # the FFN-internal LN lives on the sharded F dimension
    (_FFN + r"ffn_ln\.(weight|bias)$", {1: ("tp",)}),
    # token embedding: the vocabulary over fsdp
    (r"text_adapter\.embed_tokens$", {2: ("fsdp", None)}),
    # projection heads (D, D)
    (r"(text|image|audio)_proj\.weight$", {2: ("tp", "fsdp")}),
    # int8 layers (``ops.quant.QuantizedLinear``: w_q (out, in), a scale per
    # output channel): the placements of the float weights
    (_ATTN + r"(q_proj|k_proj|v_proj)\.w_q$", {2: ("tp", "fsdp")}),
    (_ATTN + r"(q_proj|k_proj|v_proj)\.w_scale$", {1: ("tp",)}),
    (_ATTN + r"out_proj\.w_q$", {2: ("fsdp", "tp")}),
    (_ATTN + r"out_proj\.w_scale$", {1: ("fsdp",)}),
    (_FFN + r"(wi_0|wi_1)\.w_q$", {2: ("tp", "fsdp")}),
    (_FFN + r"(wi_0|wi_1)\.w_scale$", {1: ("tp",)}),
    (_FFN + r"wo\.w_q$", {2: ("fsdp", "tp")}),
    (_FFN + r"wo\.w_scale$", {1: ("fsdp",)}),
]

_UNIT = re.compile(r"(^|\.)layers\.\d+$")


def spec_for_path(path: str, ndim: int) -> Spec:
    """The spec of the parameter ``path`` of rank ``ndim``: one mesh axis
    name (or None) per dimension, or () for a replicated leaf."""
    for pattern, by_ndim in _RULES:
        if re.search(pattern, path):
            if ndim in by_ndim:
                return by_ndim[ndim]
    return ()


def windowed_layers(model: nn.Module) -> Set[str]:
    """The module paths of the detection trunk's windowed layers (every layer
    of a ``jax_layout`` period but its last, the global one)."""
    layout = model.jax_layout() if hasattr(model, "jax_layout") else {}
    out = set()
    for stack, period in layout.get("periods", {}).items():
        layers = model.get_submodule(stack)
        out.update(f"{stack}.{i}" for i in range(len(layers)) if i % period != period - 1)
    return out


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """Every parameter's spec by name."""
    windowed = windowed_layers(model)
    specs = {}
    for name, p in model.named_parameters():
        if any(name.startswith(w + ".") for w in windowed):
            specs[name] = ()
        else:
            specs[name] = spec_for_path(name, p.ndim)
    return specs


def fsdp_dims(model: nn.Module, shard_params: bool = True) -> Dict[str, int]:
    """The dimension each sharded parameter is split on over ``fsdp``, by
    name; the parameters left out are replicated."""
    if not shard_params:
        return {}
    return {name: spec.index("fsdp") for name, spec in param_specs(model).items()
            if "fsdp" in spec}


def layer_units(model: nn.Module) -> List[nn.Module]:
    """The layers of every stack (``*.layers.<i>``), each an FSDP unit."""
    return [m for name, m in model.named_modules() if _UNIT.search(name)]


def shard_model(root: nn.Module, model: nn.Module, mesh, param_dtype: Optional[torch.dtype],
                shard_params: bool = True) -> Set[str]:
    """Apply FSDP2 to ``model`` (inside ``root``, the module whose forward
    runs the whole loss) by the rules; returns the names of the replicated
    parameters, which FSDP leaves alone.  ``param_dtype``: the compute
    dtype FSDP gathers the parameters in (None keeps fp32); gradients are
    reduced in fp32."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    dims = fsdp_dims(model, shard_params)
    replicated = {name for name, _ in model.named_parameters() if name not in dims}
    if not dims:
        return replicated
    placement = {p: Shard(dims[name]) for name, p in model.named_parameters() if name in dims}
    ignored = {p for name, p in model.named_parameters() if name in replicated}
    mp = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=torch.float32,
                              cast_forward_inputs=False)
    hsdp = mesh["dp", "fsdp"]
    kw = dict(mesh=hsdp, mp_policy=mp, shard_placement_fn=placement.get)
    for unit in layer_units(model):
        fully_shard(unit, ignored_params=ignored & set(unit.parameters()), **kw)
    fully_shard(root, ignored_params=ignored, **kw)
    for unit in fsdp_modules(root):  # each rank's loss is its share: sum the gradients
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)  # a plain sum, which gloo has too
    return replicated


def fsdp_modules(root: nn.Module) -> List[nn.Module]:
    """The FSDP units under ``root`` (itself included), outermost first."""
    from torch.distributed.fsdp import FSDPModule

    return [m for m in root.modules() if isinstance(m, FSDPModule)]
