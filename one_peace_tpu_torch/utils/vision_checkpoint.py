"""Pretrain checkpoints into the detection and video trunks (the port's copy
of the detection part of ``one_peace_tpu/utils/vision_checkpoint.py``, and
its video conversion rewritten).

``to_vision_state_dict`` is the reference's ``convert_to_vision.py`` remap
(image branch only, ``encoder.layers.N.*``); ``convert_det_backbone`` turns a
vision (or pretrain) flat state dict into the JAX package's DetBackbone tree
in numpy: windowed layers stacked (groups, period-1, ...) and global layers
(groups, ...), the shared rel table kept at pretrain size, the decomposed
rel-pos tables zeros (the reference's fresh ``nn.Parameter(torch.zeros)``).
``convert_video_backbone`` gives the trunk of the JAX package's VideoBackbone
tree: the layers stacked on a leading axis, without the adapters, which
keep the model's own init (the JAX conversion draws them from
``jax.random``), the temporal embedding zero and the rel-pos table zero
where its size differs from the checkpoint's.
``utils.checkpoint.params_from_jax`` takes these trees to the port's names.
``tests/test_torch_port_det_model.py`` and
``tests/test_torch_port_video_model.py`` hold them equal to the originals.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .checkpoint_convert import _ln, convert_encoder_layer
from .interpolate import resize_pos_embed_2d

_DROP_SUBSTR = ("text", "audio", "decoder", "mask", "logit_scale", "version")


def to_vision_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pretrain/retrieval flat sd -> vision naming: image branch only,
    ``encoder.layers.N.*`` + unprefixed ``image_adapter.*``.  Pass-through
    when already in vision naming."""
    if any(k.startswith("encoder.layers.") for k in sd):
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if any(s in k for s in _DROP_SUBSTR):
            continue
        if k.startswith("image_proj.") or "image_layer_norm" in k or "rp_bucket" in k:
            continue
        k = k.replace("encoder_wrapper", "encoder").replace("fusion_model.", "")
        if "image_adapter" in k:
            k = k.replace("encoder.", "")
        out[k] = v
    return out


def _convert_hmlp(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    def conv(i):
        w = sd[f"image_adapter.embed_images.{i}.weight"]  # (out, in, kh, kw)
        c = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
        if f"image_adapter.embed_images.{i}.bias" in sd:
            c["b"] = sd[f"image_adapter.embed_images.{i}.bias"]
        return c

    return {
        "conv1": conv(0),
        "ln1": _ln(sd, "image_adapter.embed_images.1.layer_norm"),
        "conv2": conv(3),
        "ln2": _ln(sd, "image_adapter.embed_images.4.layer_norm"),
        "conv3": conv(6),
    }


def _resized_pos_embed(sd: Dict[str, np.ndarray], bucket_size: int) -> np.ndarray:
    """(src^2+1, D) -> (bucket^2+1, D), CLS row kept, grid rows bicubic."""
    pos = sd["image_adapter.pos_embed"]
    src = int((pos.shape[0] - 1) ** 0.5)
    if src == bucket_size:
        return pos
    return np.concatenate([pos[:1], resize_pos_embed_2d(pos[1:], src, bucket_size)], axis=0)


def _trunk_layer(sd: Dict[str, np.ndarray], i: int) -> Dict[str, Any]:
    """One encoder layer, image branch only (vision naming)."""
    lay = convert_encoder_layer(sd, f"encoder.layers.{i}")
    return {k: v for k, v in lay.items()
            if k in ("self_attn", "self_attn_layer_norm", "final_layer_norm",
                     "image_ffn", "gamma_1", "gamma_2")}


def _stack(trees):
    """Trees of one structure -> one tree with the leaves stacked."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def convert_det_backbone(sd: Dict[str, np.ndarray], backbone) -> Dict[str, Any]:
    """Vision (or pretrain) flat sd -> the DetBackbone tree (numpy, the JAX
    package's layout) for the port's ``backbone``."""
    sd = to_vision_state_dict(sd)
    dh = backbone.d // backbone.heads

    def det_layer(i: int, input_size: int) -> Dict[str, Any]:
        lay = _trunk_layer(sd, i)
        if backbone.use_decomposed:
            lay["self_attn"]["rel_pos_h"] = np.zeros((2 * input_size - 1, dh), np.float32)
            lay["self_attn"]["rel_pos_w"] = np.zeros((2 * input_size - 1, dh), np.float32)
        return lay

    groups = len(backbone.layers) // backbone.global_period
    nwin = backbone.global_period - 1
    win_groups, glob_layers = [], []
    for g in range(groups):
        win_groups.append(_stack([det_layer(g * backbone.global_period + s, backbone.window_size)
                                  for s in range(nwin)]))
        glob_layers.append(det_layer(g * backbone.global_period + nwin, backbone.bucket_size))
    params: Dict[str, Any] = {
        "image_adapter": {"hmlp": _convert_hmlp(sd),
                          "pos_embed": _resized_pos_embed(sd, backbone.bucket_size)},
        "win_layers": _stack(win_groups),
        "glob_layers": _stack(glob_layers),
    }
    if backbone.shared_rp_bias:
        # kept at pretrain size; the trunk interpolates it at run time
        params["rel_pos_table"] = sd["image_adapter.rel_pos_table_list.0.weight"]
    return params


def convert_video_backbone(sd: Dict[str, np.ndarray], backbone) -> Dict[str, Any]:
    """Vision (or pretrain) flat sd -> the trunk of the VideoBackbone tree
    (numpy, the JAX package's layout) for the port's ``backbone``: the hMLP
    stem, CLS, the positions resized to the bucket grid, the layers' trunk
    leaves stacked, the temporal embedding zero and the rel-pos table the
    checkpoint's, or zero where its size differs (the reference zero-inits
    it then)."""
    sd = to_vision_state_dict(sd)
    num_rel = (2 * backbone.bucket_size - 1) ** 2 + 3
    table = sd.get("image_adapter.rel_pos_table_list.0.weight")
    if table is None or table.shape[0] != num_rel:
        table = np.zeros((num_rel, backbone.heads), np.float32)
    return {
        "hmlp": _convert_hmlp(sd),
        "cls_embedding": sd["image_adapter.cls_embedding"].reshape(1, 1, backbone.d),
        "pos_embed": _resized_pos_embed(sd, backbone.bucket_size),
        "temporal_embedding": np.zeros((1, backbone.num_frames, backbone.d), np.float32),
        "rel_pos_table": table,
        "layers": _stack([_trunk_layer(sd, i) for i in range(len(backbone.layers))]),
    }
