"""Random weights drawn from a seeded ``torch.Generator``.

The distributions are the JAX package's init (``model.init``): dense
weights of the encoder, embeddings and positional tables truncated
N(0, 0.02^2) within one sigma; the projection heads and the audio
post-extract projection Xavier-uniform; the classify head as
``ClassifyHead.init`` and ``init_attention_pooling`` draw it (its dense
layers Xavier-uniform through ``init_linear``, the attention pooling's
``k_proj`` and query truncated N(0, 0.02^2)); the pretrain model's
``decoder_*_embed`` and ``*_mask_head`` Xavier-uniform and its mask tokens
truncated N(0, 0.02^2); the hMLP stem and the audio
positional convs PyTorch's conv default (uniform, bound sqrt(3 / fan_in));
the audio feature convs He-normal; LayerNorms one and zero; biases zero
except the convs'; ``logit_scale`` ln(1 / 0.07).  Two values differ, as in
``tests/torch_fixture.make_random_state_dict``: the LayerScale gammas are
0.1 and the rel-pos tables N(0, 0.05^2) (the detection trunk's decomposed
``rel_pos_h`` / ``rel_pos_w`` too), where the JAX init's 1e-6 and zeros would
leave every layer and the bias invisible in the output.  GroupNorms are one
and zero, the FCOS box scales one.  The segmenters' level embeddings and
queries are truncated N(0, 0.02^2), the ViT-Adapter injectors' ``gamma`` 0.1
(the recipe's 0 would cut the priors out of the trunk), and every
deformable attention's offset bias the deformable-DETR ring of its init.
``init_weights_`` puts the LayerScale gammas and the tables back to the
config's values (gammas at ``layer_scale_init_value``, rel-pos tables
zero): it is the initial state of a training run that restores no
checkpoint, and ``fill_random_`` is what the tests and the chip smoke use.
``init_detector_`` is the detector's initial state, as
``OnePeaceDetector.init`` of the JAX package draws it, and
``init_segmenter_`` the segmenters' as ``OnePeaceSegmenter.init`` draws it,
and ``init_video_classifier_`` the video classifier's as
``VideoClassifierV2.init`` draws it.  ``fill_random_`` draws the video
trunk's temporal embedding truncated N(0, 0.02^2) and its adapters' ``fc2``
like any dense weight, where that init's zeros would leave the temporal
branch, and so the attention's gradient at L = frames, at zero.

Values are drawn in fp32 in a fixed order, so models of different dtypes
filled from the same seed hold the same weights up to rounding.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ..models.components import Conv, LayerNorm, Linear
from ..vision.ms_deform_attn import MSDeformAttn, offset_ring

LAYER_SCALE = 0.1
REL_POS_STD = 0.05
XAVIER_LINEARS = ("text_proj", "image_proj", "audio_proj", "post_extract_proj") + tuple(
    head for mod in ("text", "image", "audio")
    for head in (f"decoder_{mod}_embed", f"{mod}_mask_head"))


def _draw(p: torch.Tensor, kind: str, scale: float = 1.0, *,
          generator: torch.Generator) -> None:
    """Fill ``p`` with ``scale`` times fp32 draws from ``generator``: N(0, 1)
    truncated to one sigma ("trunc"), N(0, 1) ("normal") or U(-1, 1)."""
    x = torch.empty(p.shape, device=p.device, dtype=torch.float32)
    if kind == "trunc":
        nn.init.trunc_normal_(x, 0.0, 1.0, -1.0, 1.0, generator=generator)
    elif kind == "normal":
        x.normal_(0.0, 1.0, generator=generator)
    else:
        x.uniform_(-1.0, 1.0, generator=generator)
    p.copy_(x * scale)


@torch.no_grad()
def fill_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` in place; returns ``model``."""

    draw = functools.partial(_draw, generator=generator)

    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Linear):
            out_f, in_f = m.weight.shape
            if leaf in XAVIER_LINEARS or (name.startswith("classify_head.")
                                          and leaf != "k_proj"):
                draw(m.weight, "uniform", math.sqrt(6.0 / (in_f + out_f)))
            else:
                draw(m.weight, "trunc", 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv):
            fan_in = m.weight[0].numel()
            if ".feature_extractor." in name:
                draw(m.weight, "normal", math.sqrt(2.0 / fan_in))
            else:
                draw(m.weight, "uniform", math.sqrt(3.0 / fan_in))
            if m.bias is not None:
                draw(m.bias, "uniform", 1.0 / math.sqrt(fan_in))

    for name, p in model.named_parameters(recurse=True):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("embed_tokens", "embed_positions", "cls_embedding", "pos_embed",
                    "cls_pos_embed", "mask_embedding", "temporal_embedding") or name.endswith(
                        ("attn_pooling.q", "_mask_token")):
            draw(p, "trunc", 0.02)
        elif leaf in ("type_embedding", "type_embedding_2"):
            p.zero_()
        elif leaf in ("rel_pos_table", "rel_pos_h", "rel_pos_w"):
            draw(p, "normal", REL_POS_STD)
        elif leaf == "scales":  # the FCOS head's per-level box scales
            p.fill_(1.0)
        elif leaf in ("gamma_1", "gamma_2"):
            p.fill_(LAYER_SCALE)
        elif leaf == "c_attn":
            p.fill_(1.0)
        elif leaf == "logit_scale":
            p.fill_(math.log(1 / 0.07))
        elif leaf in ("level_embed", "query_feat", "query_embed"):  # the segmenters'
            draw(p, "trunc", 0.02)
        elif leaf == "gamma":  # the ViT-Adapter injectors' LayerScale
            p.fill_(LAYER_SCALE)
    _offset_rings_(model)
    for wrapper in ("encoder_wrapper", "decoder_wrapper"):
        text = getattr(getattr(model, wrapper, None), "text_adapter", None)
        if text is not None:
            text.embed_tokens[text.cfg.padding_idx] = 0
    return model


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator,
                  layer_scale_init_value: float) -> nn.Module:
    """``fill_random_``, then the LayerScale gammas at
    ``layer_scale_init_value`` and the rel-pos tables at zero, as the JAX
    package's ``model.init`` leaves them; returns ``model``."""
    fill_random_(model, generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma_1", "gamma_2"):
            p.fill_(layer_scale_init_value)
        elif leaf in ("rel_pos_table", "rel_pos_h", "rel_pos_w"):
            p.zero_()
    return model


@torch.no_grad()
def init_detector_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The initial state of a detection fine-tuning run, with the
    distributions and constants of the JAX package's
    ``OnePeaceDetector.init`` (``vision/zoo.py``): every conv, transposed
    conv and the hMLP stem's weights uniform within sqrt(3 / fan_in) and
    biases within 1 / sqrt(fan_in) (``models.components.init_conv2d``); the
    trunk's dense weights truncated N(0, 0.02^2) within one sigma, the
    cascade heads' Xavier-uniform (``init_linear``), their biases zero;
    ``pos_embed`` N(0, 1 / d); LayerNorms and GroupNorms one and zero; the
    LayerScale gammas 1e-2; the rel-pos tables zero; the FCOS class bias at
    -log(99) and its box scales one (``vision/detection.FCOSHead.init``).
    Values are drawn in fp32 in a fixed order; returns ``model``."""

    draw = functools.partial(_draw, generator=generator)

    for name, m in model.named_modules():
        if isinstance(m, LayerNorm):  # GroupNorm too
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Linear):
            out_f, in_f = m.weight.shape
            if name.startswith("backbone."):
                draw(m.weight, "trunc", 0.02)
            else:
                draw(m.weight, "uniform", math.sqrt(6.0 / (in_f + out_f)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv):
            fan_in = m.weight[0].numel()  # in * kh * kw, transposed convs too
            draw(m.weight, "uniform", math.sqrt(3.0 / fan_in))
            if m.bias is not None:
                draw(m.bias, "uniform", 1.0 / math.sqrt(fan_in))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            draw(p, "normal", p.shape[-1] ** -0.5)
        elif leaf in ("rel_pos_table", "rel_pos_h", "rel_pos_w"):
            p.zero_()
        elif leaf in ("gamma_1", "gamma_2"):
            p.fill_(1e-2)
        elif leaf == "scales":  # the FCOS head's per-level box scales
            p.fill_(1.0)
    cls_pred = getattr(getattr(model, "proposer", None), "cls_pred", None)
    if cls_pred is not None:  # FCOS: a background-heavy prior of 0.01
        cls_pred.bias.fill_(-math.log((1 - 0.01) / 0.01))
    return model


def _offset_rings_(model: nn.Module) -> None:
    """Every deformable attention's ``sampling_offsets`` bias at the
    deformable-DETR ring (``MSDeformAttnModule.init``)."""
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.sampling_offsets.bias.copy_(offset_ring(m.heads, m.levels, m.points))


@torch.no_grad()
def init_segmenter_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The initial state of a segmentation run, with the distributions and
    constants of the JAX package's ``OnePeaceSegmenter.init`` /
    ``OnePeaceMask2FormerSegmenter.init`` (``vision/zoo.py``): every conv
    uniform within sqrt(3 / fan_in), biases within 1 / sqrt(fan_in)
    (``init_conv2d``); the encoder's dense weights truncated N(0, 0.02^2),
    every other dense layer Xavier-uniform (``init_linear``), biases zero;
    each deformable attention's offset and weight projections zero with the
    offset bias at the deformable-DETR ring; the injectors' ``gamma`` at
    their ``init_values``; the backbone's and the head's level embeddings and
    the queries N(0, 0.02^2), the pixel decoder's level embedding N(0, 1);
    the image adapter's embeddings truncated N(0, 0.02^2), its rel-pos
    tables zero, the LayerScale gammas at the config's
    ``layer_scale_init_value``; LayerNorms and GroupNorms one and zero; any
    other leaf as ``fill_random_`` draws it first.  Values are drawn in fp32
    in a fixed order; returns ``model``."""
    fill_random_(model, generator)

    draw = functools.partial(_draw, generator=generator)

    for name, m in model.named_modules():
        if isinstance(m, LayerNorm):  # GroupNorm too
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Linear):
            out_f, in_f = m.weight.shape
            if name.startswith("backbone.encoder."):
                draw(m.weight, "trunc", 0.02)
            else:
                draw(m.weight, "uniform", math.sqrt(6.0 / (in_f + out_f)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv):
            fan_in = m.weight[0].numel()
            draw(m.weight, "uniform", math.sqrt(3.0 / fan_in))
            if m.bias is not None:
                draw(m.bias, "uniform", 1.0 / math.sqrt(fan_in))
    for name, m in model.named_modules():
        if isinstance(m, MSDeformAttn):
            m.sampling_offsets.weight.zero_()
            m.attention_weights.weight.zero_()
            m.attention_weights.bias.zero_()
        elif hasattr(m, "init_values"):  # an injector
            m.gamma.fill_(m.init_values)
    _offset_rings_(model)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "head.pixel_decoder.level_embed":
            draw(p, "normal", 1.0)
        elif leaf in ("level_embed", "query_feat", "query_embed"):
            draw(p, "normal", 0.02)
        elif leaf in ("cls_embedding", "pos_embed"):
            draw(p, "trunc", 0.02)
        elif leaf == "rel_pos_table":
            p.zero_()
        elif leaf in ("gamma_1", "gamma_2"):
            p.fill_(model.backbone.cfg.layer_scale_init_value)
    return model


@torch.no_grad()
def init_video_classifier_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The initial state of a video fine-tuning run that restores no
    checkpoint, with the distributions and constants of the JAX package's
    ``VideoClassifierV2.init`` (``vision/video_backbone.py``): the hMLP
    stem's convs uniform within sqrt(3 / fan_in), their biases within
    1 / sqrt(fan_in) (``init_conv2d``); the trunk's dense weights truncated
    N(0, 0.02^2) within one sigma (``init_det_layer``); the adapters' ``fc1``
    and the head Xavier-uniform (``init_linear``), the adapters' ``fc2``
    zero; biases zero; ``cls_embedding`` and ``pos_embed`` N(0, 1 / d); the
    temporal embedding and the rel-pos table zero; the LayerScale gammas
    1e-2; LayerNorms one and zero.  Values are drawn in fp32 in a fixed
    order; returns ``model``."""

    draw = functools.partial(_draw, generator=generator)

    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Linear):
            out_f, in_f = m.weight.shape
            if "_adapter." in name and leaf == "fc2":
                m.weight.zero_()
            elif "_adapter." in name or not name.startswith("backbone."):
                draw(m.weight, "uniform", math.sqrt(6.0 / (in_f + out_f)))
            else:
                draw(m.weight, "trunc", 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Conv):
            fan_in = m.weight[0].numel()
            draw(m.weight, "uniform", math.sqrt(3.0 / fan_in))
            if m.bias is not None:
                draw(m.bias, "uniform", 1.0 / math.sqrt(fan_in))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_embedding", "pos_embed"):
            draw(p, "normal", p.shape[-1] ** -0.5)
        elif leaf in ("temporal_embedding", "rel_pos_table"):
            p.zero_()
        elif leaf in ("gamma_1", "gamma_2"):
            p.fill_(1e-2)
    return model
