"""ViT-Adapter interaction modules for dense prediction (counterpart of
``one_peace_tpu/vision/adapter.py``).

``SpatialPriorModule`` (a conv stem giving 1/4..1/32 priors), ``Injector``
(deformable attention from the multi-scale priors into the ViT tokens,
LayerScale-gated), ``Extractor`` (the reverse, plus a ConvFFN with a
depthwise conv), and ``OnePeaceAdapterBackbone``, which interleaves them
with the encoder's image layers in four interaction groups and emits a
{1/4, 1/8, 1/16, 1/32} NHWC pyramid.  NHWC convs and GroupNorm, as the JAX
package has them.

The trunk runs the port's ``ImageAdapter`` (one rel-pos table per layer)
and ``FusionEncoder`` layers with the text and audio experts off, its
attention through kernels #1 and #2 (``ops/flash_attention.py``) on the
card.  Each layer's (H, L, L) bias is gathered from its own table inside the
group loop: at 896 px (L = 3137) the 40 tables gathered at once, as the JAX
package builds them, would take 37.8 GB.  With the encoder's
``checkpoint_activations`` and a gradient wanted, each layer runs under
``checkpoint_module`` with its bias gathered inside the recomputed region,
so that no layer's bias outlives its forward.  The trunk runs no drop path
and no dropout, as the JAX package's (``one_peace_tpu/vision/adapter.py``
passes rate 0 and ``deterministic=True``).
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.adapters.image import ImageAdapter
from ..models.components import (Conv, GroupNorm, LayerNorm, Linear, checkpoint_module, conv2d,
                                 conv_transpose2d, empty_param, gather_rel_bias, gelu, max_pool,
                                 resize_linear)
from ..models.encoder import FusionEncoder
from .ms_deform_attn import MSDeformAttn


def get_reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(1, sum(H*W), 1, 2) pixel-center reference points in [0, 1]
    (ref adapter_modules.py:10-22)."""
    pts = []
    for (h, w) in spatial_shapes:
        ys, xs = np.meshgrid(
            (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        pts.append(np.stack([xs.reshape(-1), ys.reshape(-1)], -1))
    ref = np.concatenate(pts, 0)[None, :, None, :]
    return ref.astype(np.float32)


def reference_points(shapes: Sequence[Tuple[int, int]], b: int, device) -> torch.Tensor:
    """``get_reference_points`` tiled over the batch, on ``device``."""
    return torch.from_numpy(get_reference_points(shapes)).to(device).expand(b, -1, -1, -1)


class ConvGN(nn.Module):
    """A conv (bias-free unless asked) and its GroupNorm (``{"conv", "gn"}``
    in the JAX tree) at "SAME" padding; ``forward`` adds the ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = False, device=None,
                 dtype=None):
        super().__init__()
        self.conv = Conv(cin, cout, (kernel, kernel), bias=bias, device=device, dtype=dtype)
        self.gn = GroupNorm(cout, device=device, dtype=dtype)

    def conv_gn(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return self.gn(conv2d(x, self.conv.weight, self.conv.bias, stride, "SAME"))

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return torch.relu(self.conv_gn(x, stride))


class SpatialPriorModule(nn.Module):
    """Conv stem -> c1 (1/4, NHWC) and c2, c3, c4 (1/8..1/32, flattened
    tokens) (ref adapter_modules.py:234-295)."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 384, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cp = inplanes
        self.embed_dim = embed_dim
        self.stem1 = ConvGN(3, cp, 3, **kw)
        self.stem2 = ConvGN(cp, cp, 3, **kw)
        self.stem3 = ConvGN(cp, cp, 3, **kw)
        self.conv2 = ConvGN(cp, 2 * cp, 3, **kw)
        self.conv3 = ConvGN(2 * cp, 4 * cp, 3, **kw)
        self.conv4 = ConvGN(4 * cp, 4 * cp, 3, **kw)
        self.fc1 = Conv(cp, embed_dim, (1, 1), **kw)
        self.fc2 = Conv(2 * cp, embed_dim, (1, 1), **kw)
        self.fc3 = Conv(4 * cp, embed_dim, (1, 1), **kw)
        self.fc4 = Conv(4 * cp, embed_dim, (1, 1), **kw)

    def forward(self, images_nhwc: torch.Tensor):
        c1 = self.stem3(self.stem2(self.stem1(images_nhwc, 2)))
        c1 = max_pool(c1, 3, 2, "SAME")  # 1/4
        c2 = self.conv2(c1, 2)   # 1/8
        c3 = self.conv3(c2, 2)   # 1/16
        c4 = self.conv4(c3, 2)   # 1/32
        c1, c2, c3, c4 = (conv2d(c, fc.weight, fc.bias, 1) for c, fc in
                          ((c1, self.fc1), (c2, self.fc2), (c3, self.fc3), (c4, self.fc4)))
        b = c1.shape[0]
        return c1, *(c.reshape(b, -1, self.embed_dim) for c in (c2, c3, c4))


class ConvFFN(nn.Module):
    """fc1 -> a depthwise 3x3 conv per level -> GELU -> fc2
    (ref adapter_modules.py:47-84)."""

    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.hidden = hidden
        self.fc1 = Linear(dim, hidden, **kw)
        self.dw = Conv(hidden, hidden, (3, 3), groups=hidden, **kw)
        self.fc2 = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor, shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """x (B, sum(H*W), dim) multi-level tokens; the depthwise conv runs on
        each level in its 2-D shape."""
        y = self.fc1(x)
        b = y.shape[0]
        pieces = []
        off = 0
        for (h, w) in shapes:
            seg = y[:, off:off + h * w].reshape(b, h, w, self.hidden).permute(0, 3, 1, 2)
            seg = F.conv2d(seg, self.dw.weight.to(seg.dtype), self.dw.bias.to(seg.dtype),
                           padding=1, groups=self.hidden)
            pieces.append(seg.permute(0, 2, 3, 1).reshape(b, h * w, self.hidden))
            off += h * w
        return self.fc2(gelu(torch.cat(pieces, dim=1)))


def _ln6(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The interaction modules' LayerNorms, at eps 1e-6."""
    return F.layer_norm(x.float(), x.shape[-1:], norm.weight.float(), norm.bias.float(),
                        1e-6).to(x.dtype)


class Injector(nn.Module):
    """priors -> ViT tokens, gated by LayerScale ``gamma`` (ref :124-150),
    which a fresh model starts at ``init_values``."""

    def __init__(self, dim: int, num_heads: int = 6, n_points: int = 4, n_levels: int = 3,
                 deform_ratio: float = 1.0, init_values: float = 0.0, device=None, dtype=None):
        super().__init__()
        self.init_values = init_values
        kw = dict(device=device, dtype=dtype)
        self.query_norm = LayerNorm(dim, **kw)
        self.feat_norm = LayerNorm(dim, **kw)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points, deform_ratio, **kw)
        self.gamma = empty_param(dim, **kw)

    def forward(self, query, reference_points, feat, spatial_shapes):
        attn = self.attn(_ln6(self.query_norm, query), reference_points,
                         _ln6(self.feat_norm, feat), spatial_shapes)
        return query + self.gamma * attn


class Extractor(nn.Module):
    """ViT tokens -> priors, then a ConvFFN (ref :87-121)."""

    def __init__(self, dim: int, num_heads: int = 6, n_points: int = 4, n_levels: int = 1,
                 deform_ratio: float = 1.0, cffn_ratio: float = 0.25, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.query_norm = LayerNorm(dim, **kw)
        self.feat_norm = LayerNorm(dim, **kw)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points, deform_ratio, **kw)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio), **kw)
        self.ffn_norm = LayerNorm(dim, **kw)

    def forward(self, query, reference_points, feat, spatial_shapes, prior_shapes):
        query = query + self.attn(_ln6(self.query_norm, query), reference_points,
                                  _ln6(self.feat_norm, feat), spatial_shapes)
        return query + self.ffn(_ln6(self.ffn_norm, query), prior_shapes)


class OnePeaceAdapterBackbone(nn.Module):
    """The ViT-Adapter backbone (ref seg/mmseg_custom/models/backbones/
    onepeace_adapter.py:19-140): spatial priors and interaction blocks
    around the image layers of the encoder, four groups of equal depth (the
    last with two extra extractors), a {1/4, 1/8, 1/16, 1/32} NHWC pyramid
    out, each level with its own group's tokens added."""

    def __init__(self, enc_cfg, conv_inplane: int = 64, n_points: int = 4,
                 deform_num_heads: int = 6, init_values: float = 0.0, cffn_ratio: float = 0.25,
                 deform_ratio: float = 1.0,
                 interaction_indexes=None, add_vit_feature: bool = True, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        enc_cfg = copy.deepcopy(enc_cfg)
        enc_cfg.use_text_moe = False
        enc_cfg.use_audio_moe = False
        self.cfg = enc_cfg
        self.dim = d = enc_cfg.embed_dim
        if interaction_indexes is None:  # 4 equal groups
            step = enc_cfg.layers // 4
            interaction_indexes = [[i * step, (i + 1) * step - 1] for i in range(4)]
        self.interaction_indexes = interaction_indexes
        self.add_vit_feature = add_vit_feature
        if add_vit_feature:  # ref :124 unpacks exactly four block outputs onto the levels
            assert len(interaction_indexes) == 4, interaction_indexes
        self.image_adapter = ImageAdapter(enc_cfg.image_adapter, d, enc_cfg.attention_heads,
                                          num_rel_tables=enc_cfg.layers, **kw)
        self.encoder = FusionEncoder(enc_cfg, use_text_norm=False, use_image_norm=True,
                                     use_audio_norm=False, **kw)
        self.spm = SpatialPriorModule(conv_inplane, d, **kw)
        self.level_embed = empty_param(3, d, **kw)
        self.up = Conv(d, d, (2, 2), **kw)
        heads, pts = deform_num_heads, n_points
        self.injectors = nn.ModuleList(
            Injector(d, heads, pts, 3, deform_ratio, init_values, **kw)
            for _ in interaction_indexes)
        self.extractors = nn.ModuleList(
            Extractor(d, heads, pts, 1, deform_ratio, cffn_ratio, **kw)
            for _ in interaction_indexes)
        # the last interaction block's two extra extractor passes (ref
        # adapter_modules.py:164-170, extra_extractor=True)
        self.extra_extractors = nn.ModuleList(
            Extractor(d, heads, pts, 1, deform_ratio, cffn_ratio, **kw) for _ in range(2))
        self.norm1, self.norm2, self.norm3, self.norm4 = (LayerNorm(d, **kw) for _ in range(4))

    def _run_layers(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Encoder layers lo..hi on the image tokens (CLS first), each with
        its own table's bias; no key is padded, so no key bias.  Under remat
        the bias is gathered again in the recompute: ``kwargs`` reads the
        table now (the compute copy under ``functional_call``) and gathers
        inside the checkpointed region."""
        adapter = self.image_adapter
        tables = adapter.rel_pos_table
        remat = self.cfg.checkpoint_activations and torch.is_grad_enabled()
        split_lens = (0, x.shape[1], 0)
        for i in range(lo, hi + 1):
            j = i if tables is not None and tables.shape[0] > 1 else 0

            def kwargs(j=j):
                bias = None if tables is None else gather_rel_bias(
                    tables[j:j + 1], adapter.rp_bucket, adapter.rp_sums)[0]
                return dict(rel_bias=bias, encoder_type="image", split_lens=split_lens)

            layer = self.encoder.layers[i]
            x = checkpoint_module(layer, x, None, make_kwargs=kwargs) if remat else layer(
                x, None, **kwargs())
        return x

    def forward(self, images_nchw: torch.Tensor) -> List[torch.Tensor]:
        """images (B, 3, H, W) -> [f4, f8, f16, f32] NHWC maps."""
        b, d = images_nchw.shape[0], self.dim
        grid = images_nchw.shape[2] // 16
        images_nchw = images_nchw.to(self.level_embed.dtype)
        c1, c2, c3, c4 = self.spm(images_nchw.permute(0, 2, 3, 1))
        le = self.level_embed
        c = torch.cat([c2 + le[0], c3 + le[1], c4 + le[2]], dim=1)
        prior_shapes = [(grid * 2, grid * 2), (grid, grid), (grid // 2, grid // 2)]

        x, _, _ = self.image_adapter(images_nchw, gather_bias=False)
        cls_tok, tokens = x[:, :1], x[:, 1:]
        ref_vit = reference_points([(grid, grid)], b, x.device)
        ref_priors = reference_points(prior_shapes, b, x.device)

        outs = []
        last = len(self.interaction_indexes) - 1
        for i, (lo, hi) in enumerate(self.interaction_indexes):
            tokens = self.injectors[i](tokens, ref_vit, c, prior_shapes)
            full = self._run_layers(torch.cat([cls_tok, tokens], dim=1), lo, hi)
            cls_tok, tokens = full[:, :1], full[:, 1:]
            c = self.extractors[i](c, ref_priors, tokens, [(grid, grid)], prior_shapes)
            if i == last:
                for ext in self.extra_extractors:
                    c = ext(c, ref_priors, tokens, [(grid, grid)], prior_shapes)
            outs.append(tokens.reshape(b, grid, grid, d))

        n2, n3 = (h * w for h, w in prior_shapes[:2])
        c2 = c[:, :n2].reshape(b, grid * 2, grid * 2, d)
        c3 = c[:, n2:n2 + n3].reshape(b, grid, grid, d)
        c4 = c[:, n2 + n3:].reshape(b, grid // 2, grid // 2, d)
        # c1 (1/4) refined with the transposed-conv upsample of c2 (ref :121)
        c1 = c1 + conv_transpose2d(c2, self.up.weight, self.up.bias, 2, "SAME")
        if self.add_vit_feature:
            # each level gets its own interaction group's tokens (ref
            # onepeace_adapter.py:124-128: bilinear 4x / 2x / identity / 0.5x)
            x1, x2, x3, x4 = outs
            c1 = c1 + resize_linear(x1, c1.shape[1:3], (1, 2))
            c2 = c2 + resize_linear(x2, c2.shape[1:3], (1, 2))
            c3 = c3 + x3
            c4 = c4 + resize_linear(x4, c4.shape[1:3], (1, 2))
        return [self.norm1(c1), self.norm2(c2), self.norm3(c3), self.norm4(c4)]
