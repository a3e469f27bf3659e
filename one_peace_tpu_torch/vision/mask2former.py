"""Mask2Former segmentation head (counterpart of
``one_peace_tpu/vision/mask2former.py``): the reference's 896 px ADE20K
decoder (ref seg/configs/ade20k/mask2former_onepeace_adapter_g_896_40k_
ade20k_ss.py: 200 queries, feat/out channels 1024, an MSDeformAttn pixel
decoder of 6 layers over the 1/8-1/32 levels, a 9-layer masked-attention
decoder, sine positional encoding).

Plain PyTorch, as the JAX package leaves it to XLA: NHWC modules, fp32
softmax attention.  The masked cross-attention attends only inside the
previous round's predicted mask (its logits, resized to the attended
level, below 0 are blocked) and everywhere for a query whose whole mask is
blocked; it is an additive -1e9 bias.  Its training losses are
``mask2former_loss.py``'s.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.components import Conv, LayerNorm, Linear, conv2d, empty_param, resize_linear
from .adapter import ConvGN, reference_points
from .ms_deform_attn import MSDeformAttn


def sine_positional_encoding(h: int, w: int, dim: int,
                             temperature: float = 10000.0) -> np.ndarray:
    """(h*w, dim) host-side constant; num_feats = dim/2 per axis, row/col
    indices 1..H cumsum-style, normalized to [0, 2pi] (mmdet
    SinePositionalEncoding with normalize=True, eps=1e-6)."""
    num_feats = dim // 2
    eps, scale = 1e-6, 2 * math.pi
    y = (np.arange(1, h + 1, dtype=np.float64)[:, None]
         / (h + eps) * scale)  # (h, 1)
    x = (np.arange(1, w + 1, dtype=np.float64)[None, :]
         / (w + eps) * scale)  # (1, w)
    dim_t = temperature ** (2 * (np.arange(num_feats) // 2) / num_feats)
    py = y[..., None] / dim_t  # (h, 1, F)
    px = x[..., None] / dim_t  # (1, w, F)

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])],
                        axis=-1).reshape(p.shape[:-1] + (num_feats,))

    py = np.broadcast_to(interleave(py), (h, w, num_feats))
    px = np.broadcast_to(interleave(px), (h, w, num_feats))
    pos = np.concatenate([py, px], axis=-1)  # (h, w, dim) — y first
    return pos.reshape(h * w, dim).astype(np.float32)


def _positions(h: int, w: int, dim: int, level_embed: torch.Tensor) -> torch.Tensor:
    """(1, h*w, dim): the sine encoding plus one level's embedding."""
    pos = torch.from_numpy(sine_positional_encoding(h, w, dim)).to(level_embed.device)
    return pos[None] + level_embed[None, None]


class MHA(nn.Module):
    """Multi-head attention with an additive bias (``init_mha`` / ``mha``)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q, self.k, self.v, self.out = (Linear(dim, dim, **kw) for _ in range(4))

    def forward(self, heads: int, q, k, v, attn_bias=None):
        """q (B, Lq, D); k/v (B, Lk, D); attn_bias (B, Lq, Lk) additive fp32
        (the same for every head) or None."""
        b, lq, d = q.shape
        lk = k.shape[1]
        dh = d // heads
        qh = self.q(q).reshape(b, lq, heads, dh)
        kh = self.k(k).reshape(b, lk, heads, dh)
        vh = self.v(v).reshape(b, lk, heads, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * dh ** -0.5
        if attn_bias is not None:
            logits = logits + attn_bias[:, None].float()
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, lq, d))


class FFN(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device=device, dtype=dtype)
        self.fc2 = Linear(hidden, dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class PixelDecoderLayer(nn.Module):
    def __init__(self, c: int, heads: int, points: int, ffn_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = MSDeformAttn(c, n_levels=3, n_heads=heads, n_points=points, **kw)
        self.attn_ln = LayerNorm(c, **kw)
        self.ffn = FFN(c, ffn_dim, **kw)
        self.ffn_ln = LayerNorm(c, **kw)


class MSDeformAttnPixelDecoder(nn.Module):
    """Deformable-encoder pixel decoder (mmdet ``MSDeformAttnPixelDecoder``):
    the 1/32, 1/16 and 1/8 levels through the deformable encoder layers, the
    1/8 output fused into the 1/4 level FPN-style, then 1x1 to the mask
    features."""

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, num_layers: int = 6, num_heads: int = 8,
                 num_points: int = 4, ffn_dim: int = 1024, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cin, c = list(in_channels), feat_channels
        self.c = c
        # input projections of the transformer levels, coarse -> fine
        self.inputs = nn.ModuleList(ConvGN(ch, c, 1, bias=True, **kw)
                                    for ch in (cin[3], cin[2], cin[1]))
        self.level_embed = empty_param(3, c, **kw)
        self.layers = nn.ModuleList(PixelDecoderLayer(c, num_heads, num_points, ffn_dim, **kw)
                                    for _ in range(num_layers))
        self.lateral = ConvGN(cin[0], c, 1, **kw)
        self.output = ConvGN(c, c, 3, **kw)
        self.mask_feature = Conv(c, out_channels, (1, 1), **kw)

    def forward(self, feats: List[torch.Tensor]):
        """feats: NHWC [f4, f8, f16, f32].  Returns (mask features (B, H4,
        W4, out), memories [(B, Hl*Wl, C)] coarse -> fine, their shapes)."""
        b = feats[0].shape[0]
        coarse = [feats[3], feats[2], feats[1]]
        shapes = [tuple(f.shape[1:3]) for f in coarse]
        toks, poss = [], []
        for i, (f, proj) in enumerate(zip(coarse, self.inputs)):
            t = proj.conv_gn(f)
            toks.append(t.reshape(b, -1, self.c))
            poss.append(_positions(*t.shape[1:3], self.c, self.level_embed[i]))
        x = torch.cat(toks, dim=1)
        pos = torch.cat(poss, dim=1).to(x.dtype)
        ref = reference_points(shapes, b, x.device)
        for layer in self.layers:
            x = layer.attn_ln(x + layer.attn(x + pos, ref, x, shapes))
            x = layer.ffn_ln(x + layer.ffn(x))
        sizes = np.cumsum([0] + [h * w for h, w in shapes])
        memories = [x[:, sizes[i]:sizes[i + 1]] for i in range(3)]
        f8 = memories[2].reshape(b, *shapes[2], self.c)
        lat = self.lateral.conv_gn(feats[0])
        y = self.output(lat + resize_linear(f8, lat.shape[1:3], (1, 2)))
        return conv2d(y, self.mask_feature.weight, self.mask_feature.bias, 1), memories, shapes


class DecoderLayer(nn.Module):
    def __init__(self, c: int, ffn_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cross_attn = MHA(c, **kw)
        self.cross_ln = LayerNorm(c, **kw)
        self.self_attn = MHA(c, **kw)
        self.self_ln = LayerNorm(c, **kw)
        self.ffn = FFN(c, ffn_dim, **kw)
        self.ffn_ln = LayerNorm(c, **kw)


def blocked_keys(mask: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, Q, th*tw) bool: the keys a query may not attend in the next
    round's cross-attention -- its mask logits (B, Q, H4, W4) resized to
    the attended level below 0 (sigmoid < 0.5); a query blocked everywhere
    attends everywhere (the mmdet rule)."""
    b, q = mask.shape[:2]
    small = resize_linear(mask, target_hw, (2, 3))
    blocked = small.reshape(b, q, -1) < 0.0
    return blocked & ~blocked.all(dim=-1, keepdim=True)


class Mask2FormerHead(nn.Module):
    """Learned queries -> (class, mask) set predictions: 9 decoder layers
    round-robin over the pixel decoder's 3 scales, each masked
    cross-attention -> self-attention -> FFN, with a prediction before the
    first layer and after every layer (10 in all)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, num_queries: int = 100, num_layers: int = 9,
                 num_heads: int = 8, ffn_dim: int = 2048, pixel_decoder_layers: int = 6,
                 pixel_heads: int = 8, pixel_ffn_dim: int = 1024, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = feat_channels
        self.c, self.heads = c, num_heads
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels, c, out_channels, num_layers=pixel_decoder_layers,
            num_heads=pixel_heads, ffn_dim=pixel_ffn_dim, **kw)
        self.query_feat = empty_param(num_queries, c, **kw)
        self.query_embed = empty_param(num_queries, c, **kw)
        self.level_embed = empty_param(3, c, **kw)
        self.layers = nn.ModuleList(DecoderLayer(c, ffn_dim, **kw) for _ in range(num_layers))
        self.post_norm = LayerNorm(c, **kw)
        self.cls_embed = Linear(c, num_classes + 1, **kw)
        self.mask_embed = nn.ModuleList([Linear(c, c, **kw), Linear(c, c, **kw),
                                         Linear(c, out_channels, **kw)])

    def _predict(self, query, mask_features, target_hw):
        """-> (cls (B, Q, C+1), mask (B, Q, H4, W4), attn_bias (B, Q, th*tw)
        additive fp32 for the next round's cross-attention)."""
        x = self.post_norm(query)
        cls = self.cls_embed(x)
        emb = x
        for i, lin in enumerate(self.mask_embed):
            emb = lin(emb)
            if i < len(self.mask_embed) - 1:
                emb = torch.relu(emb)
        mask = torch.einsum("bqc,bhwc->bqhw", emb, mask_features)
        blocked = blocked_keys(mask, target_hw)
        attn_bias = torch.zeros(blocked.shape, dtype=torch.float32, device=mask.device)
        return cls, mask, attn_bias.masked_fill_(blocked, -1e9)

    def forward(self, feats: List[torch.Tensor]):
        """feats: the pyramid [f4, f8, f16, f32] NHWC.  Returns (all_cls (L+1,
        B, Q, C+1), all_masks (L+1, B, Q, H4, W4))."""
        mask_features, memories, shapes = self.pixel_decoder(feats)
        b = mask_features.shape[0]
        poss = [_positions(h, w, self.c, self.level_embed[i]).to(mask_features.dtype)
                for i, (h, w) in enumerate(shapes)]
        query = self.query_feat[None].expand(b, -1, -1)
        qpos = self.query_embed[None].expand(b, -1, -1)
        cls, mask, attn_bias = self._predict(query, mask_features, shapes[0])
        all_cls, all_masks = [cls], [mask]
        for li, layer in enumerate(self.layers):
            lvl = li % 3
            mem = memories[lvl]
            y = layer.cross_attn(self.heads, query + qpos, mem + poss[lvl], mem, attn_bias)
            query = layer.cross_ln(query + y)
            y = layer.self_attn(self.heads, query + qpos, query + qpos, query)
            query = layer.self_ln(query + y)
            query = layer.ffn_ln(query + layer.ffn(query))
            cls, mask, attn_bias = self._predict(query, mask_features, shapes[(li + 1) % 3])
            all_cls.append(cls)
            all_masks.append(mask)
        return torch.stack(all_cls), torch.stack(all_masks)


def semantic_inference(cls_logits: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """The final layer's (B, Q, C+1) and (B, Q, H, W) -> (B, H, W, C)
    semantic scores: sum_q p(q, c) * sigmoid(mask_q), in fp32."""
    probs = torch.softmax(cls_logits.float(), -1)[..., :-1]
    return torch.einsum("bqc,bqhw->bhwc", probs, torch.sigmoid(mask_logits.float()))
