"""ONE-PEACE pretraining model (counterpart of ``one_peace_tpu/models/pretrain.py``).

An encoder ``ModelWrapper``, a small decoder ``ModelWrapper`` (2 layers,
768 wide in the recipes), and the heads: ``{mod}_proj`` (the encoder's CLS
projection), ``decoder_{mod}_embed`` (encoder width -> decoder width),
``{mod}_mask_token`` and ``{mod}_mask_head`` (decoder width -> encoder
width) for each modality both towers use.

A teacher pass (no preserve ids) returns (unit-norm CLS projection,
features) for text, image or audio, and (text features, other features)
for vl or al.  A student pass (any ``*_preserve_ids``) runs the encoder on
the preserved positions only, projects its features to the decoder's
width, puts them back among mask tokens at their positions, runs the
decoder, and maps its output back through the mask heads: the masked
denoising branch that the DCL losses score.

``trainable_mask`` is stage 2's freezing (``stage2_pretrain``): only the
encoder's audio adapter, audio FFNs and audio final LayerNorm and the heads
outside the encoder train, ``text_proj`` not.  The trainer gives the frozen
parameters no gradient.  ``upgrade_stage1_params`` overlays a stage-1
export onto this model's fresh weights by path and shape.
"""

from __future__ import annotations

import copy
import logging
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.registry import MODELS

from ..utils.checkpoint import _to_torch, model_to_jax, params_from_jax
from ..parallel.tensor_parallel import column_linear
from .components import Linear, empty_param, split_generator
from .one_peace import ModelWrapper

logger = logging.getLogger(__name__)

MODALITIES = ("text", "image", "audio")


@MODELS.register("one_peace_pretrain")
class OnePeacePretrainModel(nn.Module):
    """``cfg`` is the JAX package's ``ModelConfig`` (``cfg.encoder`` and
    ``cfg.decoder``); the model keeps a copy.  Parameters are created
    uninitialised on ``device`` (the card unless the caller asks for
    another) in ``dtype``."""

    def __init__(self, cfg: ModelConfig, device="cuda", dtype=torch.float32):
        super().__init__()
        cfg = copy.deepcopy(cfg)
        self.cfg = cfg
        self.stage2_pretrain = cfg.stage2_pretrain
        enc, dec = cfg.encoder, cfg.decoder
        kw = dict(device=device, dtype=dtype)
        self.encoder_wrapper = ModelWrapper(enc, **kw)
        self.decoder_wrapper = ModelWrapper(dec, **kw)
        self.logit_scale = empty_param((), device=device, dtype=torch.float32)
        d, dd = enc.embed_dim, dec.embed_dim
        for mod in MODALITIES:
            used_enc = getattr(enc, f"use_{mod}_moe")
            both = used_enc and getattr(dec, f"use_{mod}_moe")
            setattr(self, f"{mod}_proj", Linear(d, d, **kw) if used_enc else None)
            setattr(self, f"decoder_{mod}_embed", Linear(d, dd, **kw) if both else None)
            setattr(self, f"{mod}_mask_token", empty_param(1, dd, **kw) if both else None)
            setattr(self, f"{mod}_mask_head", Linear(dd, d, **kw) if both else None)
        self.tp_heads = None  # a tensor_parallel.Shard: the heads' rows of this rank

    def logit_scale_exp(self) -> torch.Tensor:
        """exp(logit_scale) with the value clamped to [0, ln 100] and the
        gradient passed straight through."""
        x = self.logit_scale
        return torch.exp(x + (x.clamp(0.0, math.log(100.0)) - x).detach())

    def forward(
        self,
        src_tokens: Optional[torch.Tensor] = None,
        text_preserve_ids: Optional[torch.Tensor] = None,
        src_images: Optional[torch.Tensor] = None,
        image_preserve_ids: Optional[torch.Tensor] = None,
        src_audios: Optional[torch.Tensor] = None,
        audio_padding_masks: Optional[torch.Tensor] = None,
        audio_preserve_ids: Optional[torch.Tensor] = None,
        encoder_type: str = "text",
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """Teacher pass (no preserve ids): text, image or audio -> (unit-norm
        CLS logits (B, D), features (B, L, D)); vl or al -> (text features,
        image or audio features).  Student pass: the mask heads' outputs
        (text, image, audio), each (B, L, D) over the modality's whole
        sequence, or None.  ``generator`` draws the encoder's and then the
        decoder's dropout and drop path."""
        gens = split_generator(generator, 2)
        preserve = {"text": text_preserve_ids, "image": image_preserve_ids,
                    "audio": audio_preserve_ids}
        inputs = dict(src_tokens=src_tokens, src_images=src_images, src_audios=src_audios,
                      audio_padding_masks=audio_padding_masks, encoder_type=encoder_type,
                      deterministic=deterministic)
        enc = self.encoder_wrapper(
            **inputs, **{f"{mod}_preserve_ids": ids for mod, ids in preserve.items()},
            generator=gens[0])
        enc = dict(zip(MODALITIES, enc))

        if any(ids is not None for ids in preserve.values()):
            dec_kw = {}
            for mod in MODALITIES:
                embed = getattr(self, f"decoder_{mod}_embed")
                dec_kw[f"{mod}_preserve_ids"] = preserve[mod]
                dec_kw[f"{mod}_preserve_embed"] = (
                    None if enc[mod] is None or embed is None else embed(enc[mod]))
                dec_kw[f"{mod}_mask_token"] = getattr(self, f"{mod}_mask_token")
            dec = self.decoder_wrapper(**inputs, **dec_kw, generator=gens[1])
            return tuple(None if feats is None else getattr(self, f"{mod}_mask_head")(feats)
                         for mod, feats in zip(MODALITIES, dec))

        if encoder_type in MODALITIES:
            feats = enc[encoder_type]
            out = column_linear(feats[:, 0], getattr(self, f"{encoder_type}_proj"),
                                self.tp_heads, gather=True)
            outf = out.float()
            logits = (outf / torch.linalg.vector_norm(outf, dim=-1, keepdim=True)).to(out.dtype)
            return logits, feats
        if encoder_type == "vl":
            return enc["text"], enc["image"]
        if encoder_type == "al":
            return enc["text"], enc["audio"]
        raise NotImplementedError(encoder_type)

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> whether it trains.  Everything trains unless
        ``stage2_pretrain``; then the encoder's parameters train only in its
        audio adapter, its layers' audio FFNs and its audio final
        LayerNorm, and ``text_proj`` is frozen too."""
        mask = {}
        for name, _ in self.named_parameters():
            train = True
            if self.stage2_pretrain and name.startswith("encoder_wrapper."):
                parts = name.split(".")
                train = (parts[1] == "audio_adapter"
                         or parts[1:3] == ["fusion", "audio_layer_norm"]
                         or (parts[1:3] == ["fusion", "layers"] and parts[4] == "audio_ffn"))
            elif self.stage2_pretrain and name.startswith("text_proj."):
                train = False
            mask[name] = train
        return mask

    def upgrade_stage1_params(self, loaded: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A ``state_dict`` for this model from a stage-1 (VL) export in the
        JAX package's tree layout (``native_checkpoint.load_params``): each
        leaf of this model's current weights (its fresh init) whose path
        the export has with the same shape takes the export's value, cast to
        the fresh leaf's dtype; every other leaf stays fresh (the audio
        branch of a stage-2 model; the image branch, absent from a stage-2
        config, is never looked at).  With ``reset_logit_scale``,
        ``logit_scale`` stays fresh too."""
        skip = {"logit_scale"} if getattr(self.cfg, "reset_logit_scale", False) else set()

        def overlay(f, l, path):
            if isinstance(f, dict):
                out = {}
                for k, v in f.items():
                    sub = f"{path}/{k}" if path else k
                    if sub in skip:
                        logger.info("%s reset (reset_logit_scale)", sub)
                        out[k] = v
                    elif isinstance(l, dict) and k in l:
                        out[k] = overlay(v, l[k], sub)
                    else:
                        logger.info("%s not in checkpoint, re-initialized", sub)
                        out[k] = v
                return out
            if isinstance(f, list):
                if isinstance(l, list) and len(l) == len(f):
                    return [overlay(v, w, f"{path}/{i}") for i, (v, w) in enumerate(zip(f, l))]
                logger.info("%s not in checkpoint, re-initialized", path)
                return f
            fresh = _to_torch(f)
            lsh = getattr(l, "shape", None)
            if lsh is not None and tuple(lsh) == tuple(fresh.shape):
                return _to_torch(l).to(fresh.dtype)
            logger.info("%s shape mismatch %s vs %s, re-initialized", path, lsh,
                        tuple(fresh.shape))
            return fresh

        return params_from_jax(overlay(model_to_jax(self), loaded, ""))
