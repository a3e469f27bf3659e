"""ONE-PEACE model assemblies (counterpart of ``one_peace_tpu/models/one_peace.py``).

``ModelWrapper`` runs the modality adapters and the fusion encoder and
splits the concatenated output back into per-modality features;
``OnePeaceRetrievalModel`` adds the per-modality projection heads and the
L2 normalisation; ``logit_scale`` trains through the straight-through
clamp of ``logit_scale_exp``.  ``AttentionPooling`` and ``ClassifyHead``
are the classify model's head (``models/classify.py``): CLS or single-query
attention pooling, an optional tanh pooler, an optional second image's
features concatenated, then ``fc1 -> LN -> GELU -> fc2``.  The pretrain
model (``models/pretrain.py``) runs two ``ModelWrapper``s, the encoder and
the masked-denoising decoder.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import EncoderConfig, ModelConfig

from .adapters.audio import AudioAdapter
from .adapters.image import ImageAdapter
from .adapters.text import TextAdapter
from .components import (LayerNorm, Linear, dropout, empty_param, gelu, generator_on,
                         split_generator)
from .encoder import FusionEncoder
from ..parallel.tensor_parallel import column_linear

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
        self.audio_adapter = (AudioAdapter(cfg.audio_adapter, *args,
                                           remat=cfg.checkpoint_activations, **kw)
                              if cfg.use_audio_moe else None)
        self.fusion = FusionEncoder(cfg, use_text_norm, use_image_norm, use_audio_norm, **kw)

    def enable_pipeline(self, shard, ranks, num_micro_batches: int) -> List[str]:
        """Pipeline the fusion encoder (``FusionEncoder.enable_pipeline``);
        returns the name prefixes of the parameters that run before it (the
        adapters), whose gradients each stage holds a part of."""
        self.fusion.enable_pipeline(shard, ranks, num_micro_batches)
        return [f"{mod}_adapter." for mod in ("text", "image", "audio")
                if getattr(self, f"{mod}_adapter") is not None]

    def forward(
        self,
        src_tokens: Optional[torch.Tensor] = None,
        text_preserve_ids: Optional[torch.Tensor] = None,
        text_preserve_embed: Optional[torch.Tensor] = None,
        text_mask_token: Optional[torch.Tensor] = None,
        src_images: Optional[torch.Tensor] = None,
        image_preserve_ids: Optional[torch.Tensor] = None,
        image_preserve_embed: Optional[torch.Tensor] = None,
        image_mask_token: Optional[torch.Tensor] = None,
        is_second_image: bool = False,
        src_audios: Optional[torch.Tensor] = None,
        audio_padding_masks: Optional[torch.Tensor] = None,
        audio_preserve_ids: Optional[torch.Tensor] = None,
        audio_preserve_embed: Optional[torch.Tensor] = None,
        audio_mask_token: Optional[torch.Tensor] = None,
        encoder_type: str = "text",
        deterministic: bool = True,
        return_padding_mask: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns the per-modality features (None where absent), each
        (B, l_mod, D), and their padding masks when requested.  With
        ``deterministic=False`` the adapters' dropout and the encoder's
        dropout, drop path and LayerDrop draw from ``generator``.  The
        ``*_preserve_ids`` / ``*_preserve_embed`` / ``*_mask_token`` of a
        modality select its adapter's student or decoder pass (the pretrain
        model's)."""
        if encoder_type not in ENCODER_TYPES:
            raise NotImplementedError(f"unknown encoder_type {encoder_type!r}")
        gens = split_generator(generator, 4)
        infos: List = [None, None, None]
        if encoder_type in ("text", "vl", "al", "val"):
            infos[0] = self.text_adapter(
                src_tokens, text_preserve_ids, text_preserve_embed, text_mask_token,
                deterministic=deterministic, generator=gens[0])
        if encoder_type in ("image", "vl", "val"):
            infos[1] = self.image_adapter(
                src_images, image_preserve_ids, image_preserve_embed, image_mask_token,
                is_second_image, deterministic=deterministic, generator=gens[1])
        if encoder_type in ("audio", "al", "val"):
            infos[2] = self.audio_adapter(
                src_audios, audio_padding_masks, audio_preserve_ids, audio_preserve_embed,
                audio_mask_token, deterministic=deterministic, generator=gens[2])

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
    Parameters are created uninitialised on ``device`` (the card unless the
    caller asks for another) in ``dtype``."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=torch.float32):
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
        self.tp_heads = None  # a tensor_parallel.Shard: the heads' rows of this rank

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
        out = column_linear(feats[:, 0], getattr(self, f"{encoder_type}_proj"), self.tp_heads,
                            gather=True)
        outf = out.float()
        return (outf / torch.linalg.vector_norm(outf, dim=-1, keepdim=True)).to(out.dtype)


class AttentionPooling(nn.Module):
    """Single learned query per head over the tokens (``attention_pooling``).
    The logits q·k carry no 1/sqrt(d) scaling, as in the reference; they are
    computed in fp32, padded keys set to the fp32 minimum, and the
    probabilities cast to x's dtype before they weight v."""

    def __init__(self, embed_dim: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.k_proj = Linear(embed_dim, embed_dim, bias=False, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
        self.q = empty_param(1, 1, num_heads, embed_dim // num_heads, **kw)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, D), key_padding_mask (B, L) True at pads -> (B, D)."""
        b, l, d = x.shape
        h = self.num_heads
        k = self.k_proj(x).reshape(b, l, h, d // h)
        v = self.v_proj(x).reshape(b, l, h, d // h)
        logits = torch.einsum("qhd,bkhd->bhk", self.q[0].float(), k.float())
        logits = logits.masked_fill(key_padding_mask[:, None, :], torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        return self.out_proj(torch.einsum("bhk,bkhd->bhd", probs, v).reshape(b, d))


class Classifier(nn.Module):
    """``fc1 -> LN -> GELU -> fc2``."""

    def __init__(self, in_dim: int, inner_dim: int, num_classes: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Linear(in_dim, inner_dim, **kw)
        self.ln = LayerNorm(inner_dim, **kw)
        self.fc2 = Linear(inner_dim, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.ln(self.fc1(x))))


class ClassifyHead(nn.Module):
    """CLS-token or attention pooling -> classifier (``ClassifyHead``).

    With attention pooling the tokens after CLS are pooled and then
    ``norm``-ed (``norm`` exists either way, as in the JAX tree).  The
    optional pooler is dropout -> tanh(linear) in fp32 -> dropout.  A second
    image's features go through the same pooling, with the first image's
    padding mask and the same dropout masks, and are concatenated before
    ``fc1``."""

    def __init__(self, attn_pooling: bool, use_pooler: bool, pooler_dropout: float,
                 input_dim: int, num_heads: int, head_scale_ratio: float, num_classes: int,
                 use_two_images: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pooler_dropout = pooler_dropout
        self.norm = LayerNorm(input_dim, **kw)
        self.attn_pooling = AttentionPooling(input_dim, num_heads, **kw) if attn_pooling else None
        self.pooler = Linear(input_dim, input_dim, **kw) if use_pooler else None
        cin = input_dim * 2 if use_two_images else input_dim
        self.classifier = Classifier(cin, int(input_dim * head_scale_ratio), num_classes, **kw)

    def forward_features(self, features: torch.Tensor, padding_mask: torch.Tensor,
                         deterministic: bool, seed: Optional[int]) -> torch.Tensor:
        if self.attn_pooling is not None:
            x = self.norm(self.attn_pooling(features[:, 1:], padding_mask[:, 1:]))
        else:
            x = features[:, 0]
        if self.pooler is not None:
            gens = [None, None] if seed is None else [
                generator_on(g, x.device)
                for g in split_generator(torch.Generator().manual_seed(seed), 2)]
            x = dropout(x, self.pooler_dropout, deterministic, gens[0])
            x = torch.tanh(self.pooler(x).float()).to(x.dtype)
            x = dropout(x, self.pooler_dropout, deterministic, gens[1])
        return x

    def forward(self, features_1: torch.Tensor, features_2: Optional[torch.Tensor],
                padding_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_classes) logits; ``generator`` draws the pooler's dropout."""
        seed = None if generator is None else int(
            torch.randint(0, 2**62, (), generator=generator, device=generator.device))
        x = self.forward_features(features_1, padding_mask, deterministic, seed)
        if features_2 is not None:
            x2 = self.forward_features(features_2, padding_mask, deterministic, seed)
            x = torch.cat([x, x2], dim=1)
        return self.classifier(x)
