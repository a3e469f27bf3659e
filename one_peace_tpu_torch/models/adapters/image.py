"""Image modality adapter (counterpart of ``one_peace_tpu/models/adapters/image.py``).

hMLP patch embedding (conv4 -> LN -> GELU -> conv2 -> LN -> GELU -> conv2;
overall stride 16) + CLS + learned 2-D absolute positions (bicubic-resized
for other resolutions, through ``utils.interpolate``) + the
2-D relative-position bias.  Images arrive NCHW and run NHWC.

The masked-pretraining paths, as in the text adapter: a student pass
(``preserve_ids``) keeps the preserved patches (CLS is position 0), their
positions and their per-sample rel-pos bias; the decoder pass
(``preserve_embed``) puts the student's features back over ``mask_token``.
The decoder's adapter has no stem (``vision_encoder_type: "none"``): it
only runs that path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.config import ImageAdapterConfig
from ...utils.interpolate import bicubic_resize_matrix

from ..components import (Conv, LayerNorm, bucket_order, conv2d, dropout, empty_param,
                          gather_rel_bias, gather_rows, gelu, generator_on, scatter_preserved,
                          shrink, student_positions)
from ..rel_pos import make_image_bucket_position


class HMLP(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv(3, d // 4, (4, 4), **kw)
        self.ln1 = LayerNorm(d // 4, **kw)
        self.conv2 = Conv(d // 4, d // 4, (2, 2), **kw)
        self.ln2 = LayerNorm(d // 4, **kw)
        self.conv3 = Conv(d // 4, d, (2, 2), **kw)

    def forward(self, x):
        y = gelu(self.ln1(conv2d(x, self.conv1.weight, self.conv1.bias, stride=4)))
        y = gelu(self.ln2(conv2d(y, self.conv2.weight, self.conv2.bias, stride=2)))
        return conv2d(y, self.conv3.weight, self.conv3.bias, stride=2)


class ImageAdapter(nn.Module):
    def __init__(self, cfg: ImageAdapterConfig, embed_dim: int, attention_heads: int,
                 num_rel_tables: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed_dim = embed_dim
        d = embed_dim
        kw = dict(device=device, dtype=dtype)
        self.hmlp = self.patch_conv = None
        if cfg.vision_encoder_type == "hmlp":
            self.hmlp = HMLP(d, **kw)
        elif cfg.vision_encoder_type == "mlp":
            self.patch_conv = Conv(3, d, (16, 16), bias=False, **kw)
        self.cls_embedding = empty_param(1, 1, d, **kw)
        self.pos_embed = empty_param(cfg.bucket_size**2 + 1, d, **kw)
        self.layernorm_embedding = LayerNorm(d, **kw) if cfg.layernorm_embedding else None
        self.type_embedding = empty_param(1, 1, d, **kw) if cfg.add_type_embedding else None
        self.type_embedding_2 = empty_param(1, 1, d, **kw) if cfg.add_type_embedding else None
        self.tp = None  # this rank's heads under tensor parallelism
        self.rel_pos_table = None
        if cfg.use_attn_bias:
            num_rel_dis = (2 * cfg.rel_bucket_size - 1) ** 2 + 3
            self.rel_pos_table = empty_param(num_rel_tables or 1, num_rel_dis,
                                             attention_heads, **kw)
            bucket = torch.from_numpy(make_image_bucket_position(cfg.rel_bucket_size))
            self.register_buffer("rp_bucket", bucket.to(device), persistent=False)
            # the bucket-sorted positions and counts of the bias gather's
            # backward, sorted on the host (also for a model built on "meta")
            order, counts = bucket_order(bucket, num_rel_dis)
            self.register_buffer("rp_order", order.to(device), persistent=False)
            self.register_buffer("rp_counts", counts.to(device), persistent=False)

    @property
    def rp_sums(self):
        """``gather_rel_bias``'s per-bucket backward for ``rp_bucket``."""
        return self.rp_order, self.rp_counts

    def embed_patches(self, images_nhwc: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, (H/16)*(W/16), D)."""
        x = images_nhwc.to(self.cls_embedding.dtype)
        if self.hmlp is not None:
            y = self.hmlp(x)
        elif self.patch_conv is not None:
            y = conv2d(x, self.patch_conv.weight, None, stride=16)
        else:
            raise ValueError(f"no patch embed for {self.cfg.vision_encoder_type!r}")
        b, h, w, d = y.shape
        return y.reshape(b, h * w, d)

    def get_pos_embed(self, window_size: int) -> torch.Tensor:
        """(1, window**2+1, D); bicubic-resized when the grid differs from
        the native bucket grid."""
        cfg = self.cfg
        pos = self.pos_embed
        if window_size != cfg.bucket_size:
            d = pos.shape[-1]
            m = torch.from_numpy(bicubic_resize_matrix(cfg.bucket_size, window_size)).to(pos.device)
            grid = pos[1:].reshape(cfg.bucket_size, cfg.bucket_size, d).float()
            out = torch.einsum("oi,ijd->ojd", m, grid)
            out = torch.einsum("pj,ojd->opd", m, out)
            pos = torch.cat([pos[:1], out.reshape(window_size**2, d).to(pos.dtype)])
        return pos[None]

    def rel_pos_bias(self, table: Optional[int] = None) -> Optional[torch.Tensor]:
        """Every table's bias (tables, H, L, L), or with ``table`` that one
        table's (H, L, L) alone: at 896 px (L = 3137) the 40 tables of the
        segmentation trunk would take 37.8 GB gathered at once, one 0.94 GB."""
        if self.rel_pos_table is None:
            return None
        if table is not None:
            return gather_rel_bias(self.rel_pos_table[table:table + 1], self.rp_bucket,
                                   self.rp_sums, tp=self.tp)[0]
        return gather_rel_bias(self.rel_pos_table, self.rp_bucket, self.rp_sums, tp=self.tp)

    def forward(self, src_images: torch.Tensor, preserve_ids: Optional[torch.Tensor] = None,
                preserve_embed: Optional[torch.Tensor] = None,
                mask_token: Optional[torch.Tensor] = None, is_second_image: bool = False,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                gather_bias: bool = True):
        """src_images: (B, 3, H, W).  Returns (x (B, win**2+1, D), an
        all-False padding mask, rel_bias (tables, H, L, L) or None); a
        student pass (``preserve_ids`` (B, P), -1 padded) gives (B, P, D), the
        -1s as pads, and (tables, B, H, P, P); the decoder pass
        (``preserve_embed`` and ``mask_token`` too) reads only the images'
        shape.  ``cfg.dropout`` applies to x unless deterministic.  Without
        ``gather_bias`` the full pass returns None for the bias, and the
        caller gathers each layer's table with ``rel_pos_bias(i)``."""
        cfg = self.cfg
        bsz = src_images.shape[0]
        window_size = src_images.shape[2] // 16
        seq_len = window_size**2 + 1
        if cfg.use_attn_bias and window_size != cfg.rel_bucket_size:
            raise ValueError(
                f"image {src_images.shape[2]}px gives a {window_size}x{window_size} "
                f"patch grid but rel_bucket_size is {cfg.rel_bucket_size}; set "
                f"image_adapter.rel_bucket_size = patch_image_size // 16")
        padding_mask = torch.zeros(bsz, seq_len, dtype=torch.bool, device=src_images.device)
        pos_embed = self.get_pos_embed(window_size).expand(bsz, -1, -1)
        if preserve_embed is not None:
            x = scatter_preserved(mask_token, preserve_ids, preserve_embed, seq_len)
            rel_bias = self.rel_pos_bias()
        else:
            patches = self.embed_patches(src_images.permute(0, 2, 3, 1))
            cls = self.cls_embedding.expand(bsz, 1, self.embed_dim)
            x = torch.cat([cls, patches], dim=1)
            if preserve_ids is None:
                rel_bias = self.rel_pos_bias() if gather_bias else None
            else:
                padding_mask, pos, idx = student_positions(
                    preserve_ids, None if self.rel_pos_table is None else self.rp_bucket)
                x, pos_embed = gather_rows(x, pos), gather_rows(pos_embed, pos)
                rel_bias = None if idx is None else gather_rel_bias(
                    self.rel_pos_table, idx, tp=self.tp)
            if self.layernorm_embedding is not None:
                x = self.layernorm_embedding(x)
            x = shrink(x, cfg.shrink_alpha)
        x = x + pos_embed.to(x.dtype)
        if self.type_embedding is not None:
            x = x + self.type_embedding
            if is_second_image:
                x = x + self.type_embedding_2
        x = dropout(x, cfg.dropout, deterministic, generator_on(generator, x.device))
        return x, padding_mask, rel_bias
