"""Audio modality adapter (counterpart of ``one_peace_tpu/models/adapters/audio.py``).

wav2vec2-style 1-D conv feature extractor on the raw 16 kHz waveform ->
LN -> Linear(512 -> embed_dim), or with ``frontend="fbank"`` the log-mel
filterbank -> LN -> Linear(n_mels -> embed_dim); then the convolutional
positional embedding (grouped convs, SamePad, LN without affine, GELU), CLS,
and the log-bucketed relative-position bias.  The fixed absolute positions
and the preserve-id paths are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from one_peace_tpu.core.config import AudioAdapterConfig

from ...ops.preprocess import LogMelFbank
from ..components import (Conv, LayerNorm, Linear, conv1d, dropout, empty_param,
                          gather_rel_bias, gelu, generator_on, layer_norm)
from ..rel_pos import make_token_bucket_position_with_cls

# the rel-pos table's extent: waveform conv frames stay within 1024; fbank
# frames run to ~1500 for 15 s at a 10 ms hop
MAX_POSITIONS = 1024
FBANK_MAX_POSITIONS = 2048


def conv_output_length(length: int, spec) -> int:
    """Conv length recurrence driving the audio padding mask."""
    for (_, kernel, stride) in spec:
        length = (length - kernel) // stride + 1
    return length


class FeatureBlock(nn.Module):
    """conv -> LN (affine) -> GELU, one layer of the feature extractor."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, bias: bool,
                 device=None, dtype=None):
        super().__init__()
        self.stride = stride
        self.conv = Conv(in_ch, out_ch, (kernel,), bias=bias, device=device, dtype=dtype)
        self.ln = LayerNorm(out_ch, device=device, dtype=dtype)

    def forward(self, x):
        return gelu(self.ln(conv1d(x, self.conv.weight, self.conv.bias, stride=self.stride)))


class AudioAdapter(nn.Module):
    def __init__(self, cfg: AudioAdapterConfig, embed_dim: int, attention_heads: int,
                 num_rel_tables: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        if cfg.frontend not in ("waveform", "fbank") or cfg.abs_pos_type != "conv":
            raise NotImplementedError(
                f"audio frontend {cfg.frontend!r} with abs_pos_type {cfg.abs_pos_type!r}: "
                f"only the waveform and fbank frontends with conv positions are ported")
        self.fbank = None
        if cfg.frontend == "fbank":
            self.fbank = LogMelFbank(n_fft=cfg.fbank_n_fft, hop=cfg.fbank_hop,
                                     n_mels=cfg.fbank_n_mels)
        elif not cfg.feature_encoder_spec:
            raise NotImplementedError("an audio adapter without a conv frontend "
                                      "(the pretrain decoder's) is not ported")
        self.cfg = cfg
        self.embed_dim = d = embed_dim
        kw = dict(device=device, dtype=dtype)
        self.feature_extractor = self.post_extract_ln = self.post_extract_proj = None
        self.fbank_ln = self.fbank_proj = None
        if self.fbank is not None:
            self.fbank_ln = LayerNorm(cfg.fbank_n_mels, **kw)
            self.fbank_proj = Linear(cfg.fbank_n_mels, d, **kw)
        else:
            blocks, in_ch = [], 1
            for out_ch, k, s in cfg.feature_encoder_spec:
                blocks.append(FeatureBlock(in_ch, out_ch, k, s, cfg.conv_bias, **kw))
                in_ch = out_ch
            self.feature_extractor = nn.ModuleList(blocks)
            self.post_extract_ln = LayerNorm(in_ch, **kw)
            self.post_extract_proj = Linear(in_ch, d, **kw)
        # conv positional embedding: k = max(3, width // depth) (19 for 4B)
        self.pos_conv_kernel = max(3, cfg.conv_pos_width // cfg.conv_pos_depth)
        self.pos_convs = nn.ModuleList(
            Conv(d, d, (self.pos_conv_kernel,), groups=cfg.conv_pos_groups, **kw)
            for _ in range(cfg.conv_pos_depth))
        self.pos_pre_ln = LayerNorm(d, **kw) if cfg.conv_pos_pre_ln else None
        self.cls_pos_embed = empty_param(1, 1, d, **kw)
        self.layernorm_embedding = LayerNorm(d, **kw) if cfg.layernorm_embedding else None
        self.cls_embedding = empty_param(1, 1, d, **kw)
        self.type_embedding = empty_param(1, 1, d, **kw) if cfg.add_type_embedding else None
        self.rel_pos_table = None
        if cfg.use_attn_bias:
            num_rel_dis = 2 * cfg.bucket_size - 1 + 3
            self.rel_pos_table = empty_param(num_rel_tables or 1, num_rel_dis,
                                             attention_heads, **kw)
            self.register_buffer("rp_bucket", torch.from_numpy(
                make_token_bucket_position_with_cls(
                    cfg.bucket_size, MAX_POSITIONS if self.fbank is None else FBANK_MAX_POSITIONS)
            ).to(device), persistent=False)
        self.mask_embedding = empty_param(1, d, **kw)  # carried for the pretrain paths

    def output_length(self, length: int) -> int:
        """Waveform samples -> frontend frames (drives the padding mask)."""
        if self.fbank is not None:
            return self.fbank.num_frames(length)
        return conv_output_length(length, self.cfg.feature_encoder_spec)

    def extract_features(self, src_audios: torch.Tensor) -> torch.Tensor:
        """(B, T) raw waveform -> (B, T', embed_dim), in the params' dtype."""
        dtype = self.cls_embedding.dtype
        if self.fbank is not None:  # fp32 mel, LN and projection, then the cast
            x = layer_norm(self.fbank(src_audios.float()), self.fbank_ln.weight,
                           self.fbank_ln.bias)
            b = self.fbank_proj.bias
            return torch.nn.functional.linear(x, self.fbank_proj.weight.float(),
                                              None if b is None else b.float()).to(dtype)
        x = src_audios.to(dtype)[..., None]  # (B, T, 1) NWC
        for block in self.feature_extractor:
            x = block(x)
        return self.post_extract_proj(self.post_extract_ln(x))

    def conv_pos_embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T', D) -> (B, T', D): (conv -> SamePad -> LN -> GELU) x depth."""
        y = x if self.pos_pre_ln is None else self.pos_pre_ln(x)
        k = self.pos_conv_kernel
        for conv in self.pos_convs:
            y = conv1d(y, conv.weight, conv.bias, stride=1, padding=k // 2,
                       groups=self.cfg.conv_pos_groups)
            if k % 2 == 0:  # SamePad trims one frame for even kernels
                y = y[:, :-1]
            y = gelu(layer_norm(y))
        return y

    def rel_pos_bias(self, seq_len: int) -> Optional[torch.Tensor]:
        if self.rel_pos_table is None:
            return None
        if seq_len > self.rp_bucket.shape[0]:
            raise ValueError(
                f"audio sequence of {seq_len} frames exceeds the rel-pos table "
                f"({self.rp_bucket.shape[0]} positions)")
        return gather_rel_bias(self.rel_pos_table, self.rp_bucket[:seq_len, :seq_len])

    def forward(self, src_audios: torch.Tensor, padding_mask: torch.Tensor,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """src_audios: (B, T) waveform; padding_mask: (B, T'+1) True at pads,
        T' = conv_output_length(T).  Returns (x (B, T'+1, D), padding_mask,
        rel_bias (tables, H, T'+1, T'+1) or None).  ``cfg.dropout`` applies
        to x unless deterministic."""
        bsz, seq_len = padding_mask.shape
        feats = self.extract_features(src_audios)
        pos = torch.cat([self.cls_pos_embed.expand(bsz, 1, self.embed_dim),
                         self.conv_pos_embed(feats)], dim=1)
        x = torch.cat([self.cls_embedding.expand(bsz, 1, self.embed_dim), feats], dim=1)
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x)
        x = x + pos
        if self.type_embedding is not None:
            x = x + self.type_embedding
        x = dropout(x, self.cfg.dropout, deterministic, generator_on(generator, x.device))
        return x, padding_mask, self.rel_pos_bias(seq_len)
