"""Fairseq ``.pt`` checkpoints into the port (counterpart of
``one_peace_tpu/utils/checkpoint_convert.py``).

``convert_retrieval_model`` applies the JAX package's numpy rules (legacy
rel-table rename and broadcast to per-layer tables, image position tables
interpolated to the model's resolution, the per-module conversions) and
returns the port's ``state_dict`` through ``params_from_jax``.  Those rules
are imported from the JAX module, which needs no JAX for them; only its
``_stack_layers`` does, and in its place each fusion layer is converted on
its own and walked into ``fusion.layers.{i}``.

Host memory: the fairseq entries are popped as they are converted (the
caller's dict is consumed), so converting the 16 GB fp32 state of the 4B
model peaks near one copy of it, not two or three.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from one_peace_tpu.utils.checkpoint_convert import (  # numpy (and torch) only
    _lin,
    _ln,
    convert_audio_adapter,
    convert_encoder_layer,
    convert_image_adapter,
    convert_text_adapter,
    load_torch_state_dict,
    upgrade_image_adapter_resolution,
    upgrade_state_dict,
)

from .checkpoint import params_from_jax

__all__ = ["convert_retrieval_model", "load_torch_state_dict"]


def _pop_prefix(sd: Dict[str, np.ndarray], prefix: str) -> None:
    for key in [k for k in sd if k.startswith(prefix)]:
        del sd[key]


def convert_retrieval_model(sd: Dict[str, np.ndarray], model_cfg) -> Dict[str, torch.Tensor]:
    """fairseq ``one_peace_retrieval`` state dict ({name: np.ndarray}, as
    ``load_torch_state_dict`` gives it) -> the port's ``state_dict``, fp32.
    The entries of ``sd`` are consumed."""
    enc = model_cfg.encoder
    num_rel = enc.layers if model_cfg.copy_rel_pos_table else 1
    sd_up = upgrade_state_dict(sd, num_rel)
    sd.clear()
    pre = "encoder_wrapper"

    wrapper: Dict[str, Any] = {}
    if any(k.startswith(f"{pre}.text_adapter.") for k in sd_up):
        wrapper["text_adapter"] = convert_text_adapter(sd_up, f"{pre}.text_adapter")
    if any(k.startswith(f"{pre}.image_adapter.") for k in sd_up):
        upgrade_image_adapter_resolution(sd_up, f"{pre}.image_adapter",
                                         enc.image_adapter.bucket_size,
                                         enc.image_adapter.rel_bucket_size)
        wrapper["image_adapter"] = convert_image_adapter(
            sd_up, f"{pre}.image_adapter", enc.image_adapter.vision_encoder_type)
    if any(k.startswith(f"{pre}.audio_adapter.") for k in sd_up):
        wrapper["audio_adapter"] = convert_audio_adapter(
            sd_up, f"{pre}.audio_adapter", len(enc.audio_adapter.feature_encoder_spec),
            enc.audio_adapter.conv_pos_depth)
    for name in ("text", "image", "audio"):
        _pop_prefix(sd_up, f"{pre}.{name}_adapter.")

    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"{pre}.fusion_model.layers.{i}.self_attn_layer_norm.weight" in sd_up:
        layer_pre = f"{pre}.fusion_model.layers.{i}"
        layer = convert_encoder_layer(sd_up, layer_pre)
        _pop_prefix(sd_up, f"{layer_pre}.")
        for key, value in params_from_jax(layer).items():
            out[f"{pre}.fusion.layers.{i}.{key}"] = value
        del layer
        i += 1

    fusion = {f"{mod}_layer_norm": _ln(sd_up, f"{pre}.fusion_model.{mod}_layer_norm")
              for mod in ("text", "image", "audio")
              if f"{pre}.fusion_model.{mod}_layer_norm.weight" in sd_up}
    tree: Dict[str, Any] = {pre: {**wrapper, "fusion": fusion}}
    for mod in ("text", "image", "audio"):
        if f"{mod}_proj.weight" in sd_up:
            tree[f"{mod}_proj"] = _lin(sd_up, f"{mod}_proj")
    if "logit_scale" in sd_up:
        tree["logit_scale"] = sd_up["logit_scale"].reshape(())
    out.update(params_from_jax(tree))
    return out
