"""Text modality adapter (counterpart of ``one_peace_tpu/models/adapters/text.py``).

Token embedding + prepended CLS + learned absolute positions + the
relative-position bias from log-bucketed distances, returned
batch-independent as (tables, H, L, L).  The masked-pretraining preserve-id
paths are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from one_peace_tpu.core.config import TextAdapterConfig

from ..components import LayerNorm, dropout, empty_param, gather_rel_bias, generator_on
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
        return gather_rel_bias(self.rel_pos_table, self.rp_bucket[:seq_len, :seq_len])

    def forward(self, src_tokens: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Returns (x (B, Lt+1, D), padding_mask (B, Lt+1) True at pads,
        rel_bias (tables, H, Lt+1, Lt+1) or None).  ``cfg.dropout`` applies
        to x unless deterministic."""
        bsz, tok_len = src_tokens.shape
        seq_len = tok_len + 1  # CLS prepended
        padding_mask = torch.cat(
            [torch.zeros(bsz, 1, dtype=torch.bool, device=src_tokens.device),
             src_tokens == self.cfg.padding_idx], dim=1)
        tok = F.embedding(src_tokens, self.embed_tokens)
        cls = self.cls_embedding.expand(bsz, 1, self.embed_dim)
        x = torch.cat([cls, tok], dim=1)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = x + self.embed_positions[:seq_len][None]
        if self.type_embedding is not None:
            x = x + self.type_embedding
        x = dropout(x, self.cfg.dropout, deterministic, generator_on(generator, x.device))
        return x, padding_mask, self.rel_pos_bias(seq_len)
