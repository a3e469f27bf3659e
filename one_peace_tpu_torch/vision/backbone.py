"""The image branch as a dense-prediction backbone (counterpart of
``one_peace_tpu/vision/backbone.py``).

- ``VisionBackbone``: the framework's image branch (``models.one_peace.
  ModelWrapper`` with the image adapter only, one rel-pos table per layer)
  returning the stride-16 patch map, and a parameterless pyramid from it:
  bilinear up (``models.components.resize_linear``, ``jax.image.resize``'s
  semantics) to strides 8 and 4, a 2 x 2 max pool down to stride 32.  The
  reference-grade detection trunk and its learned pyramid are
  ``vision/det_backbone.py``'s.
- ``VideoClassifier``: the round-1 K400 recognizer, per-frame image
  features, the mean over frames of CLS and a linear head.  The recipe's
  classifier is ``vision/video_backbone.VideoClassifierV2``.

The parameters carry the JAX trees' names (``VisionBackbone``'s are the
wrapper's own, ``VideoClassifier``'s sit under ``encoder_wrapper``), so
``utils.checkpoint.params_from_jax`` loads those trees.  Built on ``cuda``
unless the caller passes a device.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from ..core.config import EncoderConfig
from ..models.components import Linear, max_pool, resize_linear
from ..models.one_peace import ModelWrapper


def _image_only(cfg: EncoderConfig, image_moe: Optional[bool] = None) -> EncoderConfig:
    cfg = copy.deepcopy(cfg)
    cfg.use_text_moe = False
    cfg.use_audio_moe = False
    if image_moe is not None:
        cfg.use_image_moe = image_moe
    return cfg


class VisionBackbone(ModelWrapper):
    """The image branch as a feature extractor."""

    def __init__(self, cfg: EncoderConfig, device="cuda", dtype=None):
        cfg = _image_only(cfg, image_moe=True)
        super().__init__(cfg, use_text_norm=False, use_image_norm=True, use_audio_norm=False,
                         num_rel_tables=cfg.layers, device=device, dtype=dtype)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (B, 3, H, W) -> stride-16 feature map (B, H/16, W/16, D)."""
        _, image_f, _ = super().forward(src_images=images, encoder_type="image",
                                        deterministic=deterministic, generator=generator)
        b, grid = image_f.shape[0], images.shape[2] // 16
        return image_f[:, 1:].reshape(b, grid, grid, self.cfg.embed_dim)

    def pyramid(self, images: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The parameterless pyramid: {p4, p8, p16, p32} NHWC maps."""
        f16 = self(images, deterministic, generator)
        _, h, w, _ = f16.shape
        return {"p4": resize_linear(f16, (h * 4, w * 4), (1, 2)),
                "p8": resize_linear(f16, (h * 2, w * 2), (1, 2)),
                "p16": f16, "p32": max_pool(f16, 2, 2)}


class VideoClassifier(nn.Module):
    """Per-frame image features, the mean over frames of CLS, a linear
    classifier."""

    def __init__(self, cfg: EncoderConfig, num_classes: int, device="cuda", dtype=None):
        super().__init__()
        cfg = _image_only(cfg)
        self.cfg = cfg
        self.num_classes = num_classes
        self.encoder_wrapper = ModelWrapper(cfg, use_text_norm=False, use_image_norm=True,
                                            use_audio_norm=False, num_rel_tables=cfg.layers,
                                            device=device, dtype=dtype)
        self.head = Linear(cfg.embed_dim, num_classes, device=device, dtype=dtype)

    def forward(self, frames: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """frames (B, T, 3, H, W) -> (B, num_classes) logits."""
        b, t = frames.shape[:2]
        _, image_f, _ = self.encoder_wrapper(
            src_images=frames.reshape((b * t,) + frames.shape[2:]), encoder_type="image",
            deterministic=deterministic, generator=generator)
        return self.head(image_f[:, 0].reshape(b, t, -1).mean(dim=1))
