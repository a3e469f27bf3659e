"""Random weights drawn from a seeded ``torch.Generator``.

The distributions are the JAX package's init (``model.init``): dense
weights of the encoder, embeddings and positional tables truncated
N(0, 0.02^2) within one sigma; the projection heads and the audio
post-extract projection Xavier-uniform; the hMLP stem and the audio
positional convs PyTorch's conv default (uniform, bound sqrt(3 / fan_in));
the audio feature convs He-normal; LayerNorms one and zero; biases zero
except the convs'; ``logit_scale`` ln(1 / 0.07).  Two values differ, as in
``tests/torch_fixture.make_random_state_dict``: the LayerScale gammas are
0.1 and the rel-pos tables N(0, 0.05^2) (the detection trunk's decomposed
``rel_pos_h`` / ``rel_pos_w`` too), where the JAX init's 1e-6 and zeros would
leave every layer and the bias invisible in the output.  GroupNorms are one
and zero, the FCOS box scales one.  ``init_weights_`` puts those two back to
the config's values (gammas at ``layer_scale_init_value``, rel-pos tables
zero): it is the initial state of a training run that restores no
checkpoint, and ``fill_random_`` is what the tests and the chip smoke use.
``init_detector_`` is the detector's initial state, as
``OnePeaceDetector.init`` of the JAX package draws it.

Values are drawn in fp32 in a fixed order, so models of different dtypes
filled from the same seed hold the same weights up to rounding.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.components import Conv, LayerNorm, Linear

LAYER_SCALE = 0.1
REL_POS_STD = 0.05
XAVIER_LINEARS = ("text_proj", "image_proj", "audio_proj", "post_extract_proj")


@torch.no_grad()
def fill_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` in place; returns ``model``."""

    def draw(p, kind: str, scale: float = 1.0) -> None:
        x = torch.empty(p.shape, device=p.device, dtype=torch.float32)
        if kind == "trunc":
            nn.init.trunc_normal_(x, 0.0, 1.0, -1.0, 1.0, generator=generator)
        elif kind == "normal":
            x.normal_(0.0, 1.0, generator=generator)
        else:
            x.uniform_(-1.0, 1.0, generator=generator)
        p.copy_(x * scale)

    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Linear):
            out_f, in_f = m.weight.shape
            if leaf in XAVIER_LINEARS:
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
                    "cls_pos_embed", "mask_embedding"):
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
    text = getattr(getattr(model, "encoder_wrapper", None), "text_adapter", None)
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

    def draw(p, kind: str, scale: float) -> None:
        x = torch.empty(p.shape, device=p.device, dtype=torch.float32)
        if kind == "trunc":
            nn.init.trunc_normal_(x, 0.0, 1.0, -1.0, 1.0, generator=generator)
        elif kind == "normal":
            x.normal_(0.0, 1.0, generator=generator)
        else:
            x.uniform_(-1.0, 1.0, generator=generator)
        p.copy_(x * scale)

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
