"""Fairseq ``.pt`` checkpoints into the port (counterpart of
``one_peace_tpu/utils/checkpoint_convert.py``).

``convert_retrieval_model`` and ``convert_classify_model`` apply the JAX
package's numpy rules (legacy rel-table rename and broadcast to per-layer
tables, image position tables interpolated to the model's resolution, the
per-module conversions) and return the port's ``state_dict`` through
``params_from_jax``.  The rules (``load_torch_state_dict`` to
``convert_encoder_layer``, and the classify head's in
``convert_classify_head``) are the port's copy of the JAX module's
(``tests/test_torch_port_copies.py`` holds them equal); in place of its
``_stack_layers`` each fusion layer is converted on its own and walked into
``fusion.layers.{i}``.

Host memory: the fairseq entries are popped as they are converted (the
caller's dict is consumed), so converting the 16 GB fp32 state of the 4B
model peaks near one copy of it, not two or three.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from .checkpoint import params_from_jax

logger = logging.getLogger(__name__)

__all__ = ["convert_classify_model", "convert_encoder_wrapper", "convert_retrieval_model",
           "load_torch_state_dict", "upgrade_state_dict"]


# --- the JAX package's conversion rules, copied -----------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a fairseq .pt checkpoint to {name: np.ndarray} on host."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    return {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in state.items()}


def _lin(sd, name, bias=True):
    p = {"w": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def upgrade_state_dict(sd: Dict[str, np.ndarray], num_layers_rel: int) -> Dict[str, np.ndarray]:
    """Apply the reference's legacy-key upgrades in place."""
    out = dict(sd)
    for prefix in list({k.rsplit("rel_pos_table.weight", 1)[0]
                        for k in sd if k.endswith("rel_pos_table.weight")}):
        out[f"{prefix}rel_pos_table_list.0.weight"] = out.pop(f"{prefix}rel_pos_table.weight")
    if num_layers_rel > 1:
        adapters = {k.rsplit("rel_pos_table_list.", 1)[0]
                    for k in out if "rel_pos_table_list.0.weight" in k}
        for prefix in adapters:
            if f"{prefix}rel_pos_table_list.1.weight" not in out:
                base = out[f"{prefix}rel_pos_table_list.0.weight"]
                for i in range(num_layers_rel):
                    out[f"{prefix}rel_pos_table_list.{i}.weight"] = base.copy()
    return out


def geometric_sequence_interpolation(src_size: int, dst_size: int,
                                     table: np.ndarray) -> np.ndarray:
    """Interpolate a (src_size**2, H) relative-position table to
    (dst_size**2, H) on a geometric-progression coordinate grid
    (ref adapter/image.py:115-162): bucket spacing grows geometrically
    away from zero so the outer buckets stretch; values are resampled with
    a bicubic spline (scipy interp2d 'cubic' equivalent)."""
    from scipy.interpolate import RectBivariateSpline

    def geometric_progression(a, r, n):
        return a * (1.0 - r**n) / (1.0 - r)

    left, right = 1.01, 1.5
    while right - left > 1e-6:
        q = (left + right) / 2.0
        gp = geometric_progression(1, q, src_size // 2)
        if gp > dst_size // 2:
            right = q
        else:
            left = q
    dis, cur = [], 1.0
    for i in range(src_size // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    r_ids = [-v for v in reversed(dis)]
    x = np.asarray(r_ids + [0] + dis)
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)
    heads = table.shape[-1]
    k = min(3, src_size - 1)  # cubic when the grid allows it
    out = np.empty((dst_size * dst_size, heads), np.float32)
    for h in range(heads):
        z = table[:, h].reshape(src_size, src_size).astype(np.float64)
        spline = RectBivariateSpline(x, x, z, kx=k, ky=k)
        out[:, h] = spline(dx, dx).reshape(-1)
    return out


def upgrade_image_adapter_resolution(sd: Dict[str, np.ndarray], prefix: str,
                                     bucket_size: int, rel_bucket_size: int) -> None:
    """In-place abs/rel position-table interpolation to a new input
    resolution (ref adapter/image.py:262-305) — applied when the model is
    built for a larger patch_image_size than the checkpoint's."""
    from .interpolate import resize_pos_embed_2d

    pos_key = f"{prefix}.pos_embed"
    if pos_key in sd:
        pos = sd[pos_key]
        src = int((pos.shape[0] - 1) ** 0.5)
        if src != bucket_size:
            logger.info("interpolating abs pos embed %d -> %d", src, bucket_size)
            sd[pos_key] = np.concatenate(
                [pos[:1], resize_pos_embed_2d(pos[1:], src, bucket_size)], axis=0)
    i = 0
    while f"{prefix}.rel_pos_table_list.{i}.weight" in sd:
        key = f"{prefix}.rel_pos_table_list.{i}.weight"
        tbl = sd[key]
        src = int((tbl.shape[0] - 3) ** 0.5)
        dst = 2 * rel_bucket_size - 1
        if src != dst:
            logger.info("interpolating rel pos table %d -> %d", src, dst)
            extra = tbl[-3:]
            sd[key] = np.concatenate(
                [geometric_sequence_interpolation(src, dst, tbl[:-3]), extra],
                axis=0)
        i += 1


def _collect_rel_tables(sd, prefix) -> Optional[np.ndarray]:
    tables = []
    i = 0
    while f"{prefix}.rel_pos_table_list.{i}.weight" in sd:
        tables.append(sd[f"{prefix}.rel_pos_table_list.{i}.weight"])
        i += 1
    if not tables:
        return None
    return np.stack(tables)


def convert_text_adapter(sd, prefix) -> Dict[str, Any]:
    p = {
        "embed_tokens": sd[f"{prefix}.embed_tokens.weight"],
        "embed_positions": sd[f"{prefix}.embed_positions.weight"],
        "cls_embedding": sd[f"{prefix}.cls_embedding"],
    }
    if f"{prefix}.layernorm_embedding.weight" in sd:
        p["layernorm_embedding"] = _ln(sd, f"{prefix}.layernorm_embedding")
    if f"{prefix}.type_embedding" in sd:
        p["type_embedding"] = sd[f"{prefix}.type_embedding"]
    rel = _collect_rel_tables(sd, prefix)
    if rel is not None:
        p["rel_pos_table"] = rel
    return p


def convert_image_adapter(sd, prefix, vision_encoder_type="hmlp") -> Dict[str, Any]:
    p = {
        "cls_embedding": sd[f"{prefix}.cls_embedding"],
        "pos_embed": sd[f"{prefix}.pos_embed"],
    }
    if vision_encoder_type == "hmlp":
        # Sequential indices: 0 conv4, 1 LN2D, 3 conv2, 4 LN2D, 6 conv2
        def conv(i):
            w = sd[f"{prefix}.embed_images.{i}.weight"]  # (out, in, kh, kw)
            c = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
            if f"{prefix}.embed_images.{i}.bias" in sd:
                c["b"] = sd[f"{prefix}.embed_images.{i}.bias"]
            return c

        p["hmlp"] = {
            "conv1": conv(0),
            "ln1": _ln(sd, f"{prefix}.embed_images.1.layer_norm"),
            "conv2": conv(3),
            "ln2": _ln(sd, f"{prefix}.embed_images.4.layer_norm"),
            "conv3": conv(6),
        }
    elif vision_encoder_type == "mlp":
        w = sd[f"{prefix}.embed_images.weight"]
        p["patch_conv"] = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
    if f"{prefix}.layernorm_embedding.weight" in sd:
        p["layernorm_embedding"] = _ln(sd, f"{prefix}.layernorm_embedding")
    if f"{prefix}.type_embedding" in sd:
        p["type_embedding"] = sd[f"{prefix}.type_embedding"]
        p["type_embedding_2"] = sd[f"{prefix}.type_embedding_2"]
    rel = _collect_rel_tables(sd, prefix)
    if rel is not None:
        p["rel_pos_table"] = rel
    return p


def convert_audio_adapter(sd, prefix, num_feat_layers: int, conv_pos_depth: int) -> Dict[str, Any]:
    def conv1d_w(name):
        w = sd[f"{name}.weight"]  # (out, in/groups, k)
        c = {"w": np.ascontiguousarray(w.transpose(2, 1, 0))}
        if f"{name}.bias" in sd:
            c["b"] = sd[f"{name}.bias"]
        return c

    feat = []
    for i in range(num_feat_layers):
        base = f"{prefix}.embed_audios.0.conv_layers.{i}"
        feat.append({
            "conv": conv1d_w(f"{base}.0"),
            "ln": _ln(sd, f"{base}.2.1"),
        })
    p = {
        "feature_extractor": feat,
        "post_extract_ln": _ln(sd, f"{prefix}.embed_audios.2"),
        "post_extract_proj": _lin(sd, f"{prefix}.embed_audios.3"),
        "cls_embedding": sd[f"{prefix}.cls_embedding"],
        "mask_embedding": sd[f"{prefix}.mask_embedding"],
    }
    if f"{prefix}.cls_pos_embed" in sd:
        p["cls_pos_embed"] = sd[f"{prefix}.cls_pos_embed"]
        # embed_positions Sequential: 0 TransposeLast, then depth blocks
        pos_convs = []
        for i in range(conv_pos_depth):
            pos_convs.append(conv1d_w(f"{prefix}.embed_positions.{i + 1}.0"))
        p["pos_convs"] = pos_convs
        if f"{prefix}.embed_positions.0.weight" in sd:  # conv_pos_pre_ln variant
            p["pos_pre_ln"] = _ln(sd, f"{prefix}.embed_positions.0")
    elif f"{prefix}.embed_positions.weight" in sd:
        p["embed_positions"] = sd[f"{prefix}.embed_positions.weight"]
    if f"{prefix}.layernorm_embedding.weight" in sd:
        p["layernorm_embedding"] = _ln(sd, f"{prefix}.layernorm_embedding")
    if f"{prefix}.type_embedding" in sd:
        p["type_embedding"] = sd[f"{prefix}.type_embedding"]
    rel = _collect_rel_tables(sd, prefix)
    if rel is not None:
        p["rel_pos_table"] = rel
    return p


def convert_encoder_layer(sd, prefix) -> Dict[str, Any]:
    attn_prefix = f"{prefix}.self_attn"
    attn = {
        "q_proj": _lin(sd, f"{attn_prefix}.q_proj"),
        "k_proj": _lin(sd, f"{attn_prefix}.k_proj"),
        "v_proj": _lin(sd, f"{attn_prefix}.v_proj"),
        "out_proj": _lin(sd, f"{attn_prefix}.out_proj"),
    }
    if f"{attn_prefix}.c_attn" in sd:
        attn["c_attn"] = sd[f"{attn_prefix}.c_attn"]
    if f"{attn_prefix}.ln.weight" in sd:
        attn["ln"] = _ln(sd, f"{attn_prefix}.ln")
    layer = {
        "self_attn": attn,
        "self_attn_layer_norm": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "final_layer_norm": _ln(sd, f"{prefix}.final_layer_norm"),
    }
    if f"{prefix}.attn_ln.weight" in sd:
        layer["attn_ln"] = _ln(sd, f"{prefix}.attn_ln")
    for mod in ("text", "image", "audio"):
        base = f"{prefix}.{mod}_ffn"
        if f"{base}.0.wi_0.weight" not in sd:
            continue
        ffn = {
            "wi_0": _lin(sd, f"{base}.0.wi_0"),
            "wi_1": _lin(sd, f"{base}.0.wi_1"),
            "wo": _lin(sd, f"{base}.3"),
        }
        if f"{base}.2.weight" in sd:
            ffn["ffn_ln"] = _ln(sd, f"{base}.2")
        layer[f"{mod}_ffn"] = ffn
    if f"{prefix}.gamma_1" in sd:
        layer["gamma_1"] = sd[f"{prefix}.gamma_1"]
        layer["gamma_2"] = sd[f"{prefix}.gamma_2"]
    return layer


# --- the port's converter ---------------------------------------------------


def _pop_prefix(sd: Dict[str, np.ndarray], prefix: str) -> None:
    for key in [k for k in sd if k.startswith(prefix)]:
        del sd[key]


def convert_encoder_wrapper(sd_up: Dict[str, np.ndarray], enc) -> Dict[str, torch.Tensor]:
    """The ``encoder_wrapper`` entries of an upgraded fairseq state dict
    (adapters, with the image tables brought to the model's resolution;
    fusion layers; the modality norms) as the port's ``state_dict``
    entries.  The converted entries are popped from ``sd_up``."""
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
    out.update(params_from_jax({pre: {**wrapper, "fusion": fusion}}))
    return out


def convert_retrieval_model(sd: Dict[str, np.ndarray], model_cfg) -> Dict[str, torch.Tensor]:
    """fairseq ``one_peace_retrieval`` state dict ({name: np.ndarray}, as
    ``load_torch_state_dict`` gives it) -> the port's ``state_dict``, fp32.
    The entries of ``sd`` are consumed."""
    enc = model_cfg.encoder
    num_rel = enc.layers if model_cfg.copy_rel_pos_table else 1
    sd_up = upgrade_state_dict(sd, num_rel)
    sd.clear()
    out = convert_encoder_wrapper(sd_up, enc)
    tree: Dict[str, Any] = {}
    for mod in ("text", "image", "audio"):
        if f"{mod}_proj.weight" in sd_up:
            tree[f"{mod}_proj"] = _lin(sd_up, f"{mod}_proj")
    if "logit_scale" in sd_up:
        tree["logit_scale"] = sd_up["logit_scale"].reshape(())
    out.update(params_from_jax(tree))
    return out


def convert_classify_head(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The ``classify_head`` of a fairseq ``one_peace_classify`` state dict
    as the JAX package's tree (``convert_classify_model``'s rule, copied):
    ``norm``, ``attn_pooling_func`` -> ``attn_pooling``, ``pooler.1`` ->
    ``pooler``, ``classifier.{0,1,3}`` -> ``classifier.{fc1,ln,fc2}``."""
    head: Dict[str, Any] = {"norm": _ln(sd, "classify_head.norm")}
    if "classify_head.attn_pooling_func.q" in sd:
        ap = {
            "k_proj": _lin(sd, "classify_head.attn_pooling_func.k_proj"),
            "v_proj": _lin(sd, "classify_head.attn_pooling_func.v_proj"),
            "out_proj": _lin(sd, "classify_head.attn_pooling_func.out_proj"),
            "q": sd["classify_head.attn_pooling_func.q"],
        }
        head["attn_pooling"] = ap
    if "classify_head.pooler.1.weight" in sd:
        head["pooler"] = _lin(sd, "classify_head.pooler.1")
    head["classifier"] = {
        "fc1": _lin(sd, "classify_head.classifier.0"),
        "ln": _ln(sd, "classify_head.classifier.1"),
        "fc2": _lin(sd, "classify_head.classifier.3"),
    }
    return head


def convert_classify_model(sd: Dict[str, np.ndarray], model_cfg) -> Dict[str, torch.Tensor]:
    """fairseq ``one_peace_classify`` state dict -> the port's
    ``state_dict``, fp32, by the JAX package's rule: one rel-pos table per
    layer always, the image tables at the model's resolution (a 16 x 16
    pretrained table becomes 24 x 24 at 384 px, 30 x 30 at 480 px), and the
    head.  A pretrained checkpoint, which has no ``classify_head``, gives
    the encoder only (the JAX rule raises there).  The entries of ``sd`` are
    consumed."""
    sd_up = upgrade_state_dict(sd, model_cfg.encoder.layers)
    sd.clear()
    out = convert_encoder_wrapper(sd_up, model_cfg.encoder)
    if "classify_head.norm.weight" in sd_up:
        out.update(params_from_jax({"classify_head": convert_classify_head(sd_up)}))
    return out
