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

Parameter names are the port's (``encoder_wrapper.fusion.layers.3.
self_attn.q_proj.weight``, ``backbone.layers.3.self_attn.q_proj.weight``);
the rules are the JAX package's, applied to the unstacked layers.  Adan and
the segmentation and video trunks' layer ids are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

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
    trunk's shared rel-pos table) num_layers + 1."""
    if name.startswith("backbone."):
        rest = name.removeprefix("backbone.")
        if rest.startswith("image_adapter."):
            return 0
        if rest.startswith("layers."):
            return int(rest.split(".")[1]) + 1
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


def build_optimizer(cfg: OptimizerConfig, opt_cfg: OptimizationConfig,
                    named_params: Iterable[Tuple[str, torch.Tensor]],
                    num_layers: int = 40) -> torch.optim.AdamW:
    """AdamW with one parameter group per (weight decay, layer scale)."""
    if getattr(cfg, "use_adan", False) or cfg._name == "adan":
        raise NotImplementedError("Adan is not ported yet: use adamw")
    named_params = list(named_params)
    mask = decay_mask(named_params)
    scales = {name: 1.0 for name, _ in named_params}
    if opt_cfg.layer_decay and opt_cfg.layer_decay < 1.0:
        scales = layer_decay_scales(named_params, num_layers, opt_cfg.layer_decay)
    groups: Dict[Tuple[float, float], dict] = {}
    for name, p in named_params:
        scale = scales[name]
        if isinstance(scale, torch.Tensor):
            if scale.numel() > 1:
                raise NotImplementedError(
                    f"{name}: one lr per rel-pos table (copy_rel_pos_table with layer decay) "
                    f"is not ported yet")
            scale = float(scale)
        wd = cfg.weight_decay if mask[name] else 0.0
        group = groups.setdefault((wd, scale), {"params": [], "names": [], "weight_decay": wd,
                                                "lr_scale": scale, "lr": 0.0})
        group["params"].append(p)
        group["names"].append(name)
    b1, b2 = cfg.adam_betas
    return torch.optim.AdamW(list(groups.values()), lr=0.0, betas=(b1, b2), eps=cfg.adam_eps)
