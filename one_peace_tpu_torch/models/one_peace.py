"""ONE-PEACE model assemblies (counterpart of ``one_peace_tpu/models/one_peace.py``).

``ModelWrapper`` runs the modality adapters and the fusion encoder and
splits the concatenated output back into per-modality features;
``OnePeaceRetrievalModel`` adds the per-modality projection heads and the
L2 normalisation; ``logit_scale`` trains through the straight-through
clamp of ``logit_scale_exp``.  The classify and pretrain models are not
ported yet.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from one_peace_tpu.core.config import EncoderConfig, ModelConfig

from .adapters.audio import AudioAdapter
from .adapters.image import ImageAdapter
from .adapters.text import TextAdapter
from .components import Linear, empty_param, split_generator
from .encoder import FusionEncoder

ENCODER_TYPES = ("text", "image", "audio", "vl", "al", "val")


def combine_rel_bias(biases: Sequence[Optional[torch.Tensor]],
                     lens: Sequence[int]) -> Optional[torch.Tensor]:
    """Combine per-modality biases block-diagonally.

    biases: (T, H, l, l) / (T, B, H, l, l) / None per modality; lens: the
    matching sequence lengths.  Off-diagonal blocks are zero: cross-modal
    attention carries no rel-pos bias.  Returns a bias over sum(lens)."""
    total = sum(lens)
    out = None
    offset = 0
    for bias, l in zip(biases, lens):
        if bias is not None:
            after = total - offset - l
            padded = F.pad(bias, (offset, after, offset, after))
            if out is None:
                out = padded
            else:
                # broadcast batch dims: (T, H, L, L) against (T, B, H, L, L)
                if out.ndim < padded.ndim:
                    out = out[:, None]
                if padded.ndim < out.ndim:
                    padded = padded[:, None]
                out = out + padded
        offset += l
    return out


class ModelWrapper(nn.Module):
    """Adapters + fusion encoder."""

    def __init__(self, cfg: EncoderConfig, use_text_norm=True, use_image_norm=True,
                 use_audio_norm=True, num_rel_tables: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        args = (cfg.embed_dim, cfg.attention_heads, num_rel_tables)
        self.text_adapter = (TextAdapter(cfg.text_adapter, *args, **kw)
                             if cfg.use_text_moe else None)
        self.image_adapter = (ImageAdapter(cfg.image_adapter, *args, **kw)
                              if cfg.use_image_moe else None)
        self.audio_adapter = (AudioAdapter(cfg.audio_adapter, *args, **kw)
                              if cfg.use_audio_moe else None)
        self.fusion = FusionEncoder(cfg, use_text_norm, use_image_norm, use_audio_norm, **kw)

    def forward(
        self,
        src_tokens: Optional[torch.Tensor] = None,
        src_images: Optional[torch.Tensor] = None,
        is_second_image: bool = False,
        src_audios: Optional[torch.Tensor] = None,
        audio_padding_masks: Optional[torch.Tensor] = None,
        encoder_type: str = "text",
        deterministic: bool = True,
        return_padding_mask: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns the per-modality features (None where absent), each
        (B, l_mod, D), and their padding masks when requested.  With
        ``deterministic=False`` the adapters' dropout and the encoder's
        dropout, drop path and LayerDrop draw from ``generator``."""
        if encoder_type not in ENCODER_TYPES:
            raise NotImplementedError(f"unknown encoder_type {encoder_type!r}")
        gens = split_generator(generator, 4)
        infos: List = [None, None, None]
        if encoder_type in ("text", "vl", "al", "val"):
            infos[0] = self.text_adapter(src_tokens, deterministic, gens[0])
        if encoder_type in ("image", "vl", "val"):
            infos[1] = self.image_adapter(src_images, is_second_image, deterministic, gens[1])
        if encoder_type in ("audio", "al", "val"):
            infos[2] = self.audio_adapter(src_audios, audio_padding_masks, deterministic,
                                          gens[2])

        present = [i for i in infos if i is not None]
        lens = [i[0].shape[1] for i in present]
        x = torch.cat([i[0] for i in present], dim=1)
        padding_mask = torch.cat([i[1] for i in present], dim=1)
        rel_bias = combine_rel_bias([i[2] for i in present], lens)
        split_lens = tuple(0 if i is None else i[0].shape[1] for i in infos)

        out = self.fusion(x, padding_mask, rel_bias, encoder_type, split_lens,
                          deterministic, gens[3])

        feats, pads, start = [], [], 0
        for info, l in zip(infos, split_lens):
            feats.append(None if info is None else out[:, start:start + l])
            pads.append(None if info is None else padding_mask[:, start:start + l])
            start += l
        if return_padding_mask:
            return (*feats, *pads)
        return tuple(feats)


class OnePeaceRetrievalModel(nn.Module):
    """Dual/tri-encoder with L2-normalized CLS projections.

    ``cfg`` is the JAX package's ``ModelConfig``; the model keeps a copy, and
    ``model.cfg.encoder.attn_impl`` selects the attention path at run time.
    Parameters are created uninitialised on ``device`` in ``dtype``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        cfg = copy.deepcopy(cfg)
        self.cfg = cfg
        enc = cfg.encoder
        head = cfg.head_type
        # drop modality branches not used by the head
        enc.use_text_moe = head in ("text", "vl", "al", "val")
        enc.use_image_moe = head in ("image", "vl", "val")
        enc.use_audio_moe = head in ("audio", "al", "val")
        self.head_type = head
        kw = dict(device=device, dtype=dtype)
        self.encoder_wrapper = ModelWrapper(
            enc, use_text_norm=enc.use_text_moe, use_image_norm=enc.use_image_moe,
            use_audio_norm=enc.use_audio_moe,
            num_rel_tables=enc.layers if cfg.copy_rel_pos_table else None, **kw)
        d = enc.embed_dim
        self.text_proj = Linear(d, d, **kw) if enc.use_text_moe else None
        self.image_proj = Linear(d, d, **kw) if enc.use_image_moe else None
        self.audio_proj = Linear(d, d, **kw) if enc.use_audio_moe else None
        self.logit_scale = empty_param((), device=device, dtype=torch.float32)

    def logit_scale_exp(self) -> torch.Tensor:
        """exp(logit_scale) with the value clamped to [0, ln 100] and the
        gradient passed straight through."""
        x = self.logit_scale
        return torch.exp(x + (x.clamp(0.0, math.log(100.0)) - x).detach())

    def forward(
        self,
        src_tokens: Optional[torch.Tensor] = None,
        src_images: Optional[torch.Tensor] = None,
        src_audios: Optional[torch.Tensor] = None,
        audio_padding_masks: Optional[torch.Tensor] = None,
        encoder_type: str = "text",
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, D) unit-norm embeddings for encoder_type text, image or audio.
        ``deterministic=False`` with a generator is the training path."""
        if encoder_type not in ("text", "image", "audio"):
            raise NotImplementedError(encoder_type)
        text_f, image_f, audio_f = self.encoder_wrapper(
            src_tokens=src_tokens, src_images=src_images, src_audios=src_audios,
            audio_padding_masks=audio_padding_masks, encoder_type=encoder_type,
            deterministic=deterministic, generator=generator)
        feats = {"text": text_f, "image": image_f, "audio": audio_f}[encoder_type]
        out = getattr(self, f"{encoder_type}_proj")(feats[:, 0])
        outf = out.float()
        return (outf / torch.linalg.vector_norm(outf, dim=-1, keepdim=True)).to(out.dtype)
