"""AdamW with the no-decay set and layer decay (counterpart of
``one_peace_tpu/optim/adamw.py``), as ``torch.optim.AdamW`` parameter groups.

The JAX chain is clip -> adam -> add_decayed_weights(wd, mask) ->
scale_by_tree(layer scale) -> lr, so a parameter moves by
``-lr * s * (adam + wd * p)``.  ``torch.optim.AdamW`` with a group lr of
``lr * s`` and a group weight decay of ``wd`` (0 in the no-decay set) moves it
by ``-lr * s * wd * p - lr * s * adam``: the same update, the layer scale on
the decay term included.  The trainer sets each group's lr from the schedule
before every update (``group["lr_scale"] * schedule(n)``); clipping and
gradient accumulation live in the trainer.

A parameter whose scale differs along its leading axis (the per-layer
rel-pos tables under layer decay: table i carries layer i's scale) runs in a
group at scale 1, and ``AdamW.step`` then moves each slice by its own scale:
``p = p0 + s * (p1 - p0)``.  AdamW's step is linear in the lr, so this is the
JAX update ``-lr * s * (adam + wd * p0)`` slice by slice.

Parameter names are the port's (``encoder_wrapper.fusion.layers.3.
self_attn.q_proj.weight``, ``backbone.layers.3.self_attn.q_proj.weight`` of
the detection and video trunks, ``backbone.encoder.layers.3.self_attn.
q_proj.weight``); the rules are the JAX package's, applied to the unstacked
layers.  ``_name: adan`` or ``use_adan`` builds Adan instead (``optim/adan.py``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..core.config import OptimizationConfig, OptimizerConfig

NO_WEIGHT_DECAY_SUFFIXES = ("embed_positions", "cls_embedding", "pos_embed", "cls_pos_embed")
ADAPTERS = ("text_adapter", "image_adapter", "audio_adapter")


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """True where weight decay applies: not for tensors of ndim <= 1, biases
    or the no-decay suffixes (cls embeddings, absolute position tables)."""
    return {name: not (p.ndim <= 1 or name.endswith("bias")
                       or name.endswith(NO_WEIGHT_DECAY_SUFFIXES))
            for name, p in named_params}


def layer_id_for_path(name: str, num_layers: int) -> Optional[int]:
    """0 for the adapters, i + 1 for encoder layer i (and for layer i of the
    pretrain model's decoder, as the JAX package scales any stacked
    ``fusion/layers``), num_layers + 1 for the rest (final norms, heads,
    logit scale, the decoder's adapters); None for an adapter's rel-pos
    table, whose scale goes per table.  The detector (``OnePeaceDetector``)
    as detectron2's recipe: ``backbone.image_adapter`` 0, trunk layer i
    i + 1, everything else (the pyramid, the proposer, the heads and the
    trunk's shared rel-pos table) num_layers + 1.  The video classifier
    (``OnePeaceVideoClassifier``) as the JAX rules map its tree: trunk layer
    i (its adapters too) i + 1, everything else (the stem, CLS, positions,
    temporal embedding, rel-pos table, norm and head) num_layers + 1.  The
    segmenters
    (``OnePeaceSegmenter``) as mmseg's ViT rule: ``backbone.image_adapter``
    0 but its per-layer rel-pos tables (None), ``backbone.encoder.layers.<i>``
    i + 1, everything else (the spatial priors, the interactions, the level
    embeddings, ``up``, ``norm1-4``, the encoder's final norm and the head)
    num_layers + 1."""
    if name.startswith("backbone."):
        rest = name.removeprefix("backbone.")
        if rest.startswith("image_adapter."):
            return None if "rel_pos_table" in rest else 0
        for stack in ("layers.", "encoder.layers."):
            if rest.startswith(stack):
                return int(rest.removeprefix(stack).split(".")[0]) + 1
        return num_layers + 1
    p = name.removeprefix("encoder_wrapper.")
    if p.startswith(ADAPTERS):
        return None if "rel_pos_table" in p else 0
    if p.startswith("fusion.layers."):
        return int(p.split(".")[2]) + 1
    if p.startswith("decoder_wrapper.fusion.layers."):
        return int(p.split(".")[3]) + 1
    return num_layers + 1


def layer_decay_scales(named_params: Iterable[Tuple[str, torch.Tensor]], num_layers: int,
                       decay: float) -> Dict[str, Union[float, torch.Tensor]]:
    """LR multiplier per parameter, decay ** (num_layers + 1 - layer id).  A
    rel-pos table gets one value per table, shaped (tables, 1, 1), as the
    table of layer i carries layer i's scale (table 0 of 1 carries layer
    0's)."""
    values = [decay ** (num_layers + 1 - i) for i in range(num_layers + 2)]
    out: Dict[str, Union[float, torch.Tensor]] = {}
    for name, p in named_params:
        lid = layer_id_for_path(name, num_layers)
        if lid is not None:
            out[name] = values[lid]
            continue
        n = p.shape[0]
        ids = [min(i + 1, num_layers + 1) for i in range(n)] if n > 1 else [1]
        out[name] = torch.tensor([values[i] for i in ids], dtype=torch.float64).reshape(
            (n,) + (1,) * (p.ndim - 1))
    return out


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose ``slice_scales`` parameters (each beside a
    scale tensor that broadcasts against it) move by their scale slice by
    slice: the group's step at scale 1, then ``p = p0 + s * (p1 - p0)``."""

    def __init__(self, params, slice_scales: List[Tuple[torch.Tensor, torch.Tensor]], **kw):
        super().__init__(params, **kw)
        self.slice_scales = slice_scales

    @torch.no_grad()
    def step(self, closure=None):
        before = [p.clone() for p, _ in self.slice_scales]
        loss = super().step(closure)
        for (p, s), p0 in zip(self.slice_scales, before):
            p.copy_(torch.lerp(p0, p, s))
        return loss


def build_optimizer(cfg: OptimizerConfig, opt_cfg: OptimizationConfig,
                    named_params: Iterable[Tuple[str, torch.Tensor]],
                    num_layers: int = 40) -> torch.optim.Optimizer:
    """AdamW with one parameter group per (weight decay, layer scale, FSDP
    sharded or not); a
    parameter with one scale per leading index (a per-layer rel-pos table)
    goes to a group at scale 1 and into ``slice_scales``.  Under
    ``_name: adan`` or ``use_adan``, Adan with the same layer scales."""
    named_params = list(named_params)
    scales = {name: 1.0 for name, _ in named_params}
    if opt_cfg.layer_decay and opt_cfg.layer_decay < 1.0:
        scales = layer_decay_scales(named_params, num_layers, opt_cfg.layer_decay)
    if getattr(cfg, "use_adan", False) or cfg._name == "adan":
        from .adan import build_adan

        return build_adan(cfg, named_params, scales)
    mask = decay_mask(named_params)
    groups: Dict[Tuple[float, float], dict] = {}
    slice_scales = []
    for name, p in named_params:
        scale = scales[name]
        if isinstance(scale, torch.Tensor):
            if scale.numel() > 1:
                slice_scales.append((p, scale.to(p.device, p.dtype)))
                scale = 1.0
            scale = float(scale)
        wd = cfg.weight_decay if mask[name] else 0.0
        # FSDP's sharded parameters (DTensors) and replicated ones in groups
        # of their own: a multi-tensor step takes one kind at a time
        sharded = hasattr(p, "device_mesh")
        group = groups.setdefault((wd, scale, sharded),
                                  {"params": [], "names": [], "weight_decay": wd,
                                   "lr_scale": scale, "lr": 0.0})
        group["params"].append(p)
        group["names"].append(name)
    b1, b2 = cfg.adam_betas
    return AdamW(list(groups.values()), slice_scales, lr=0.0, betas=(b1, b2), eps=cfg.adam_eps)
