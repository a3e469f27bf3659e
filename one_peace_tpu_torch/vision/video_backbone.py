"""The K400 video trunk: AIM-style temporal adaptation of the frozen
ONE-PEACE vision trunk (counterpart of ``one_peace_tpu/vision/video_backbone.py``).

- ``Adapter``: the bottleneck MLP (down to D/4, GELU, up; with or without
  the skip); its ``fc2`` starts at zero, so the adapted model starts as the
  frozen trunk.
- ``VideoLayer``: one trunk layer whose shared, frozen attention runs twice:
  first over the frames of each spatial location (the (b t) n d -> (b n) t d
  rearrange, no bias, ``t_adapter`` without the skip, drop path), then over
  the tokens of each frame from the pre-temporal residual (the shared
  rel-pos bias, ``s_adapter`` with the skip, ``gamma_1``); then the GeGLU FFN
  (``image_ffn``, which ``ops.quant.quantize_ffn_`` swaps for int8 as the JAX
  package's dispatch does) and ``adapter_scale`` times ``mlp_adapter`` off
  the same LN.  Both attentions go through ``ops.attention.
  multihead_attention``: the kernels #1 / #2 of ``ops/flash_attention.py`` on
  the card (``attn_impl="pallas"``), at L = frames (32) and L = tokens per
  frame (257 at 256 px).
- ``VideoBackbone``: the hMLP stem (the detection trunk's), CLS, the
  absolute positions of the frame's sub-grid, the temporal embedding over
  frames, the (H, N, N) bias gathered once from ``rel_pos_table``, and the
  layers in a Python loop.  With ``deterministic=False`` and a generator,
  drop path acts on all three branches with one keep draw per frame (the
  JAX package's (B*T, 1, 1) mask) on the ``linspace(0, drop_path_rate,
  layers)`` schedule; ``checkpoint_activations`` recomputes each layer in
  the backward pass, its masks drawn from a generator rebuilt from a seed
  drawn before the layer runs, so the recompute draws the same masks.
- ``VideoClassifierV2``: the mean over frames of the CLS tokens, a LayerNorm
  and the linear head.

``trainable_mask`` is AIM's frozen-trunk recipe: the adapters, the temporal
embedding, the rel-pos table, the norm and the head train.  The modules
take the device they are given; ``vision/zoo.OnePeaceVideoClassifier``, the
entry point, builds on ``cuda`` unless the caller passes another.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.adapters.image import HMLP
from ..models.components import (LayerNorm, Linear, bucket_order, checkpoint_module,
                                 drop_path, empty_param, gather_rel_bias, gelu)
from ..models.rel_pos import make_image_bucket_position
from ..ops.attention import multihead_attention
from .det_backbone import DetFFN

TRAINABLE = ("t_adapter", "s_adapter", "mlp_adapter", "temporal_embedding", "rel_pos_table")


def subgrid_token_indices(h: int, w: int, bucket_size: int) -> np.ndarray:
    """Token indices (CLS + row-major (h, w) sub-grid) into the
    (bucket_size**2 + 1)-token position tables.  A flat ``[:h*w+1]``
    prefix would pick the first h*w positions of the FULL bucket grid —
    wrong whenever the frame grid is smaller than bucket_size."""
    grid = (1 + np.arange(h)[:, None] * bucket_size
            + np.arange(w)[None, :]).reshape(-1)
    return np.concatenate([[0], grid])


class Adapter(nn.Module):
    """``fc2(gelu(fc1(x)))``, plus x with ``skip``."""

    def __init__(self, d: int, mlp_ratio: float = 0.25, device=None, dtype=None):
        super().__init__()
        hid = int(d * mlp_ratio)
        self.fc1 = Linear(d, hid, device=device, dtype=dtype)
        self.fc2 = Linear(hid, d, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: bool) -> torch.Tensor:
        y = self.fc2(gelu(self.fc1(x)))
        return x + y if skip else y


class VideoAttention(nn.Module):
    """q/k/v (k without bias), softmax attention with an optional shared
    (H, L, L) bias, Magneto ``ln``, ``out_proj`` (``_attn``)."""

    def __init__(self, d: int, heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = heads
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, bias=False, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)
        self.ln = LayerNorm(d, **kw)

    def forward(self, x: torch.Tensor, rel_bias: Optional[torch.Tensor],
                impl: str) -> torch.Tensor:
        """x (B, L, D), contiguous: its projections then are too, as the
        kernels need them."""
        b, l, d = x.shape
        dh = d // self.heads
        q, k, v = (proj(x).reshape(b, l, self.heads, dh)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = multihead_attention(q, k, v, rel_bias, None, scaling=dh ** -0.5, impl=impl)
        return self.out_proj(self.ln(out.reshape(b, l, d)))


class VideoLayer(nn.Module):
    """One trunk layer with the three AIM adapters (``video_layer``)."""

    def __init__(self, d: int, f: int, heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = VideoAttention(d, heads, **kw)
        self.self_attn_layer_norm = LayerNorm(d, **kw)
        self.final_layer_norm = LayerNorm(d, **kw)
        self.image_ffn = DetFFN(d, f, **kw)
        self.gamma_1 = empty_param(d, **kw)
        self.gamma_2 = empty_param(d, **kw)
        self.t_adapter = Adapter(d, **kw)
        self.s_adapter = Adapter(d, **kw)
        self.mlp_adapter = Adapter(d, **kw)

    def forward(self, x: torch.Tensor, rel_bias: torch.Tensor, num_frames: int,
                adapter_scale: float, impl: str, drop_path_rate: float = 0.0,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B*T, N, D) -> the same."""
        bt, n, d = x.shape
        b = bt // num_frames
        residual = x

        # 1. temporal: attention over the frames of each spatial location; the
        # reshape after the transpose copies, so the rows are contiguous once
        xt = self.self_attn_layer_norm(x)
        xt = xt.reshape(b, num_frames, n, d).transpose(1, 2).reshape(b * n, num_frames, d)
        xt = self.t_adapter(self.self_attn(xt, None, impl), skip=False)
        xt = xt.reshape(b, n, num_frames, d).transpose(1, 2).reshape(bt, n, d)
        x = x + drop_path(xt, drop_path_rate, deterministic, generator)

        # 2. spatial: from the pre-temporal residual, with the shared bias
        xs = self.s_adapter(self.self_attn(self.self_attn_layer_norm(x), rel_bias, impl),
                            skip=True)
        x = residual + drop_path(xs * self.gamma_1, drop_path_rate, deterministic, generator)

        # 3. joint: the FFN and the scaled MLP adapter off the same LN
        xn = self.final_layer_norm(x)
        y = self.image_ffn(xn)
        mlp = self.mlp_adapter(xn, skip=False) * adapter_scale
        return x + y * self.gamma_2 + drop_path(mlp, drop_path_rate, deterministic, generator)


class VideoBackbone(nn.Module):
    """hMLP embed + CLS + positions + temporal embedding -> the video layers."""

    def __init__(self, embed_dim=1536, ffn_embed_dim=6144, heads=24, layers=40, bucket_size=16,
                 num_frames=8, adapter_scale=0.5, drop_path_rate=0.0,
                 checkpoint_activations=False, attn_impl="pallas", device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.d, self.f, self.heads = embed_dim, ffn_embed_dim, heads
        self.bucket_size = bucket_size
        self.num_frames = num_frames
        self.adapter_scale = adapter_scale
        self.checkpoint_activations = checkpoint_activations
        self.attn_impl = attn_impl
        self.dpr = np.linspace(0, drop_path_rate, layers, dtype=np.float32)
        self.hmlp = HMLP(embed_dim, **kw)
        self.cls_embedding = empty_param(1, 1, embed_dim, **kw)
        self.pos_embed = empty_param(bucket_size ** 2 + 1, embed_dim, **kw)
        self.temporal_embedding = empty_param(1, num_frames, embed_dim, **kw)
        self.rel_pos_table = empty_param((2 * bucket_size - 1) ** 2 + 3, heads, **kw)
        self.layers = nn.ModuleList(VideoLayer(embed_dim, ffn_embed_dim, heads, **kw)
                                    for _ in range(layers))
        self._buckets: Dict[tuple, tuple] = {}

    def trainable_mask(self, prefix: str = "") -> Dict[str, bool]:
        """AIM's recipe: only the adapters, the temporal embedding and the
        rel-pos table train; the pretrained trunk stays frozen."""
        return {prefix + name: bool(set(name.split(".")) & set(TRAINABLE))
                for name, _ in self.named_parameters()}

    def _bucket_index(self, h: int, w: int, device) -> tuple:
        """The (N, N) rel-pos buckets of an (h, w) frame grid with CLS and
        their ``bucket_order``, made once per grid and device."""
        key = (h, w, str(device))
        if key not in self._buckets:
            tok = subgrid_token_indices(h, w, self.bucket_size)
            rp = make_image_bucket_position(self.bucket_size)[np.ix_(tok, tok)]
            idx = torch.from_numpy(np.ascontiguousarray(rp)).to(device)
            self._buckets[key] = (torch.from_numpy(tok).to(device), idx,
                                  bucket_order(idx, self.rel_pos_table.shape[0]))
        return self._buckets[key]

    def forward(self, frames: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """frames (B, T, 3, H, W), cast to the weights' dtype -> (B*T, N, D)
        token features (CLS at 0).  ``generator`` (CPU) draws each layer's
        seed; without one, or when deterministic, nothing is random."""
        b, t = frames.shape[:2]
        assert t == self.num_frames, (t, self.num_frames)
        dtype = self.pos_embed.dtype
        x = self.hmlp(frames.reshape((b * t,) + frames.shape[2:]).permute(0, 2, 3, 1).to(dtype))
        bt, h, w, d = x.shape
        assert h <= self.bucket_size and w <= self.bucket_size, (h, w, self.bucket_size)
        tok, idx, sums = self._bucket_index(h, w, x.device)
        cls = self.cls_embedding.to(x.dtype).expand(bt, 1, d)
        x = torch.cat([cls, x.reshape(bt, h * w, d)], dim=1)
        x = x + self.pos_embed[tok].to(x.dtype)
        n = x.shape[1]
        x = (x.reshape(b, t, n, d) + self.temporal_embedding.to(x.dtype)[:, :, None]).reshape(
            bt, n, d)
        rel_bias = gather_rel_bias(self.rel_pos_table[None], idx, sums)[0]  # (H, N, N) fp32

        n_layers = len(self.layers)
        seeds = [None] * n_layers
        if not deterministic and generator is not None:
            seeds = torch.randint(0, 2**62, (n_layers,), generator=generator,
                                  device=generator.device).tolist()
        remat = self.checkpoint_activations and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            static = dict(num_frames=t, adapter_scale=self.adapter_scale, impl=self.attn_impl,
                          drop_path_rate=float(self.dpr[i]), deterministic=deterministic)

            def kwargs(seed=seeds[i], static=static):
                return dict(static, generator=None if seed is None
                            else torch.Generator(device=x.device).manual_seed(seed))

            if remat:
                x = checkpoint_module(layer, x, rel_bias, make_kwargs=kwargs)
            else:
                x = layer(x, rel_bias, **kwargs())
        return x


class VideoClassifierV2(nn.Module):
    """K400 classifier: the video backbone, the mean over frames of the CLS
    tokens, a LayerNorm and a linear head."""

    def __init__(self, num_classes: int, device=None, dtype=None, **backbone_kw):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.backbone = VideoBackbone(**backbone_kw, **kw)
        self.norm = LayerNorm(self.backbone.d, **kw)
        self.head = Linear(self.backbone.d, num_classes, **kw)
        self.num_classes = num_classes

    def trainable_mask(self) -> Dict[str, bool]:
        """The backbone's mask, and the norm and head, which train."""
        mask = self.backbone.trainable_mask("backbone.")
        mask.update({name: True for name, _ in self.named_parameters()
                     if name.startswith(("norm.", "head."))})
        return mask

    def forward(self, frames: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """frames (B, T, 3, H, W) -> logits (B, num_classes)."""
        b, t = frames.shape[:2]
        tokens = self.backbone(frames, deterministic, generator)
        cls = tokens[:, 0].reshape(b, t, -1).mean(dim=1)
        return self.head(self.norm(cls))
