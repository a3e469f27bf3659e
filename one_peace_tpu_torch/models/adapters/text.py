"""Text modality adapter (counterpart of ``one_peace_tpu/models/adapters/text.py``).

Token embedding + prepended CLS + learned absolute positions + the
relative-position bias from log-bucketed distances, returned
batch-independent as (tables, H, L, L).

The masked-pretraining paths: a student pass (``preserve_ids``) keeps the
preserved positions of the embedded sequence, their absolute positions and
their rel-pos bias, which becomes per-sample (tables, B, H, P, P); the
decoder pass (``preserve_embed``) puts the student's projected features
back at their positions over ``mask_token`` and adds the absolute
positions (no token embedding, no LayerNorm).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import TextAdapterConfig

from ..components import (LayerNorm, dropout, empty_param, gather_rel_bias, gather_rows,
                          generator_on, scatter_preserved, shrink, student_positions)
from ..rel_pos import make_token_bucket_position_with_cls


class TextAdapter(nn.Module):
    def __init__(self, cfg: TextAdapterConfig, embed_dim: int, attention_heads: int,
                 num_rel_tables: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed_dim = embed_dim
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = empty_param(cfg.vocab_size, embed_dim, **kw)
        self.embed_positions = empty_param(cfg.max_positions, embed_dim, **kw)
        self.cls_embedding = empty_param(1, 1, embed_dim, **kw)
        self.layernorm_embedding = (LayerNorm(embed_dim, **kw)
                                    if cfg.layernorm_embedding else None)
        self.type_embedding = (empty_param(1, 1, embed_dim, **kw)
                               if cfg.add_type_embedding else None)
        self.tp = None  # this rank's heads under tensor parallelism
        self.rel_pos_table = None
        if cfg.use_attn_bias:
            num_rel_dis = 2 * cfg.bucket_size - 1 + 3
            self.rel_pos_table = empty_param(num_rel_tables or 1, num_rel_dis,
                                             attention_heads, **kw)
            self.register_buffer("rp_bucket", torch.from_numpy(
                make_token_bucket_position_with_cls(cfg.bucket_size, 1024)).to(device),
                persistent=False)

    def rel_pos_bias(self, seq_len: int) -> Optional[torch.Tensor]:
        """(tables, H, L, L) fp32, or None."""
        if self.rel_pos_table is None:
            return None
        return gather_rel_bias(self.rel_pos_table, self.rp_bucket[:seq_len, :seq_len], tp=self.tp)

    def forward(self, src_tokens: torch.Tensor, preserve_ids: Optional[torch.Tensor] = None,
                preserve_embed: Optional[torch.Tensor] = None,
                mask_token: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Returns (x, padding_mask True at pads, rel_bias or None).  By
        default x is (B, Lt+1, D) and rel_bias (tables, H, Lt+1, Lt+1); a
        student pass (``preserve_ids`` (B, P), -1 padded) gives (B, P, D), the
        -1s as pads, and (tables, B, H, P, P); the decoder pass
        (``preserve_embed`` (B, P, D) and ``mask_token`` (1, D) too) gives
        (B, Lt+1, D).  ``cfg.dropout`` applies to x unless deterministic."""
        bsz, tok_len = src_tokens.shape
        seq_len = tok_len + 1  # CLS prepended
        padding_mask = torch.cat(
            [torch.zeros(bsz, 1, dtype=torch.bool, device=src_tokens.device),
             src_tokens == self.cfg.padding_idx], dim=1)
        pos_embed = self.embed_positions[:seq_len][None].expand(bsz, -1, -1)
        if preserve_embed is not None:
            x = scatter_preserved(mask_token, preserve_ids, preserve_embed, seq_len)
            rel_bias = self.rel_pos_bias(seq_len)
        else:
            tok = F.embedding(src_tokens, self.embed_tokens)
            cls = self.cls_embedding.expand(bsz, 1, self.embed_dim)
            x = torch.cat([cls, tok], dim=1)
            if preserve_ids is None:
                rel_bias = self.rel_pos_bias(seq_len)
            else:
                padding_mask, pos, idx = student_positions(
                    preserve_ids, None if self.rel_pos_table is None else self.rp_bucket)
                x, pos_embed = gather_rows(x, pos), gather_rows(pos_embed, pos)
                rel_bias = None if idx is None else gather_rel_bias(
                    self.rel_pos_table, idx, tp=self.tp)
            if self.layernorm_embedding is not None:
                x = self.layernorm_embedding(x)
            x = shrink(x, self.cfg.shrink_alpha)
        x = x + pos_embed.to(x.dtype)
        if self.type_embedding is not None:
            x = x + self.type_embedding
        x = dropout(x, self.cfg.dropout, deterministic, generator_on(generator, x.device))
        return x, padding_mask, rel_bias
