"""Fusion transformer encoder (counterpart of ``one_peace_tpu/models/encoder.py``).

Each layer: sub-LN attention (Magneto LN before out_proj; optional post-
attention LN and per-head gains), the GeGLU FFN of the token's modality,
LayerScale.  The relative-position bias stays (H, L, L) or (B, H, L, L) and
the key mask (B, L); the attention op combines them.

The JAX package stacks the layers and runs them under ``lax.scan``; here
they are an ``nn.ModuleList`` walked by a loop.  With ``deterministic=False``
and a generator the training path runs: dropout and activation dropout,
drop path on the ``linspace(0, drop_path_rate, layers)`` schedule, and
LayerDrop.  ``checkpoint_activations`` (remat policy ``full``) recomputes
each layer in the backward pass through ``torch.utils.checkpoint``.  Each
layer's random masks come from a generator rebuilt from a seed drawn before
the layer runs, so the recompute draws the same masks.  The ``qkv`` and
``offload_qkv`` remat policies and pipelining are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from one_peace_tpu.core.config import EncoderConfig

from ..ops.attention import multihead_attention
from ..ops.quant import shared_input_linears
from .components import LayerNorm, Linear, drop_path, dropout, empty_param, gelu

MODALITIES = ("text", "image", "audio")


class Attention(nn.Module):
    """q/k/v projections (k_proj has no bias), optional per-head gains
    ``c_attn``, Magneto ``ln``, ``out_proj`` (``_attention``).  Any
    projection may be a ``QuantizedLinear`` (``ops.quant.quantize_ffn_``);
    q/k/v then share one row quantize of x."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.q_proj = Linear(d, d, device=device, dtype=dtype)
        self.k_proj = Linear(d, d, bias=False, device=device, dtype=dtype)
        self.v_proj = Linear(d, d, device=device, dtype=dtype)
        self.out_proj = Linear(d, d, device=device, dtype=dtype)
        self.c_attn = (empty_param(cfg.attention_heads, device=device, dtype=dtype)
                       if cfg.scale_heads else None)
        self.ln = LayerNorm(d, device=device, dtype=dtype) if cfg.magneto_scale_attn else None

    def forward(self, x, rel_bias, key_padding_mask):
        b, l, d = x.shape
        h = self.cfg.attention_heads
        hd = d // h
        q, k, v = (y.reshape(b, l, h, hd) for y in
                   shared_input_linears(x, self.q_proj, self.k_proj, self.v_proj))
        attn = multihead_attention(q, k, v, rel_bias, key_padding_mask,
                                   scaling=hd**-0.5, impl=self.cfg.attn_impl)
        if self.c_attn is not None:
            attn = attn * self.c_attn[:, None]
        attn = attn.reshape(b, l, d)
        if self.ln is not None:
            attn = self.ln(attn)
        return self.out_proj(attn)


class GeGLU(nn.Module):
    """``wo(ffn_ln(dropout(gelu(wi_0 x) * wi_1 x)))`` (``_geglu_ffn``), the
    dropout at ``activation_dropout``.  Quantized ``wi_0`` and ``wi_1``
    share one row quantize of x."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        d, f = cfg.embed_dim, cfg.ffn_embed_dim
        self.wi_0 = Linear(d, f, bias=False, device=device, dtype=dtype)
        self.wi_1 = Linear(d, f, bias=False, device=device, dtype=dtype)
        self.wo = Linear(f, d, device=device, dtype=dtype)
        self.ffn_ln = LayerNorm(f, device=device, dtype=dtype) if cfg.scale_fc else None
        self.activation_dropout = cfg.activation_dropout

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        a, g = shared_input_linears(x, self.wi_0, self.wi_1)
        y = gelu(a) * g
        y = dropout(y, self.activation_dropout, deterministic, generator)
        if self.ffn_ln is not None:
            y = self.ffn_ln(y)
        return self.wo(y)


def split_by_modality(x: torch.Tensor, encoder_type: str,
                      split_lens: Tuple[int, int, int]):
    """[(modality, segment)] of the concatenated sequence, in order."""
    if encoder_type in MODALITIES:
        return [(encoder_type, x)]
    text_len, image_len, _ = split_lens
    if encoder_type == "vl":
        return [("text", x[:, :text_len]), ("image", x[:, text_len:])]
    if encoder_type == "al":
        return [("text", x[:, :text_len]), ("audio", x[:, text_len:])]
    if encoder_type == "val":
        return [("text", x[:, :text_len]),
                ("image", x[:, text_len:text_len + image_len]),
                ("audio", x[:, text_len + image_len:])]
    raise NotImplementedError(encoder_type)


class EncoderLayer(nn.Module):
    """One transformer layer (``encoder_layer``).  Dropout, activation
    dropout and drop path draw, in that order, from one generator on x's
    device."""

    def __init__(self, cfg: EncoderConfig, device=None, dtype=None):
        super().__init__()
        d = cfg.embed_dim
        kw = dict(device=device, dtype=dtype)
        self.dropout_rate = cfg.dropout
        self.self_attn = Attention(cfg, **kw)
        self.self_attn_layer_norm = LayerNorm(d, **kw)
        self.final_layer_norm = LayerNorm(d, **kw)
        self.attn_ln = LayerNorm(d, **kw) if cfg.scale_attn else None
        self.text_ffn = GeGLU(cfg, **kw) if cfg.use_text_moe else None
        self.image_ffn = GeGLU(cfg, **kw) if cfg.use_image_moe else None
        self.audio_ffn = GeGLU(cfg, **kw) if cfg.use_audio_moe else None
        self.gamma_1 = empty_param(d, **kw) if cfg.use_layer_scale else None
        self.gamma_2 = empty_param(d, **kw) if cfg.use_layer_scale else None
        # under remat these enter the checkpoint as inputs (see _run_layer)
        self.param_names = [name for name, _ in self.named_parameters()]

    def forward(self, x, key_padding_mask, rel_bias, encoder_type: str,
                split_lens: Tuple[int, int, int], drop_path_rate: float = 0.0,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        rate = self.dropout_rate
        y = self.self_attn(self.self_attn_layer_norm(x), rel_bias, key_padding_mask)
        if self.attn_ln is not None:
            y = self.attn_ln(y)
        y = dropout(y, rate, deterministic, generator)
        if self.gamma_1 is not None:
            y = y * self.gamma_1
        x = x + drop_path(y, drop_path_rate, deterministic, generator)

        y = self.final_layer_norm(x)
        segs = [getattr(self, f"{mod}_ffn")(seg, deterministic, generator)
                for mod, seg in split_by_modality(y, encoder_type, split_lens)]
        y = segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)
        y = dropout(y, rate, deterministic, generator)
        if self.gamma_2 is not None:
            y = y * self.gamma_2
        return x + drop_path(y, drop_path_rate, deterministic, generator)


def _run_layer(layer: EncoderLayer, x, key_mask, bias, encoder_type, split_lens,
               rate: float, deterministic: bool, seed: Optional[int], remat: bool):
    """One layer, its masks drawn from a generator seeded with ``seed``.
    Under remat the layer's parameters enter ``checkpoint`` as inputs: the
    recompute then sees the tensors the forward saw, also when they were
    swapped in by ``torch.func.functional_call`` (the trainer's bf16
    copies), which no longer holds when the backward pass runs."""

    def run(x, bias, *params):
        gen = None if seed is None else torch.Generator(device=x.device).manual_seed(seed)
        args = (x, key_mask, bias, encoder_type, split_lens, rate, deterministic, gen)
        if not params:
            return layer(*args)
        return torch.func.functional_call(layer, dict(zip(layer.param_names, params)), args)

    if not remat:
        return run(x, bias)
    params = [functools.reduce(getattr, name.split("."), layer) for name in layer.param_names]
    return checkpoint(run, x, bias, *params, use_reentrant=False, preserve_rng_state=False)


class FusionEncoder(nn.Module):
    """The shared multi-modal transformer (``FusionEncoder``)."""

    def __init__(self, cfg: EncoderConfig, use_text_norm=True, use_image_norm=True,
                 use_audio_norm=True, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw) for _ in range(cfg.layers))
        self.text_layer_norm = (LayerNorm(d, **kw)
                                if cfg.use_text_moe and use_text_norm else None)
        self.image_layer_norm = (LayerNorm(d, **kw)
                                 if cfg.use_image_moe and use_image_norm else None)
        self.audio_layer_norm = (LayerNorm(d, **kw)
                                 if cfg.use_audio_moe and use_audio_norm else None)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor],
        rel_bias: Optional[torch.Tensor],
        encoder_type: str,
        split_lens: Tuple[int, int, int],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x: (B, L, D) concatenated modality sequence; padding_mask: (B, L)
        True at pads; rel_bias: (tables, H, L, L) or (tables, B, H, L, L) with
        tables in {1, layers}, or None.  ``generator`` (CPU) draws each
        layer's seed and LayerDrop decision; without one, or when
        deterministic, nothing is random.  Returns the output after the final
        LayerNorm of each modality."""
        cfg = self.cfg
        remat = cfg.checkpoint_activations
        if remat and cfg.remat_policy != "full":
            raise NotImplementedError(f"remat_policy={cfg.remat_policy!r} is not ported "
                                      f"yet: only 'full'")
        remat = remat and torch.is_grad_enabled()
        use_rng = not deterministic and generator is not None
        seeds = [None] * cfg.layers
        keep = [True] * cfg.layers
        if use_rng:
            seeds = torch.randint(0, 2**62, (cfg.layers,), generator=generator,
                                  device=generator.device).tolist()
            if cfg.layerdrop > 0.0:
                keep = (torch.rand(cfg.layers, generator=generator, device=generator.device)
                        < 1.0 - cfg.layerdrop).tolist()
        rates = np.linspace(0, cfg.drop_path_rate, cfg.layers, dtype=np.float32)
        key_mask = None
        if padding_mask is not None:
            # zero padded positions before the stack (ref encoder:139-142)
            x = x * (1.0 - padding_mask[..., None].to(x.dtype))
            # a mask with no padded key changes no output: skip its (B, L)
            # bias row (one host sync per forward)
            if bool(padding_mask.any()):
                key_mask = padding_mask

        per_layer_bias = rel_bias is not None and rel_bias.shape[0] == self.cfg.layers
        for i, layer in enumerate(self.layers):
            if not keep[i]:  # LayerDrop skips the whole layer
                continue
            bias = None if rel_bias is None else rel_bias[i if per_layer_bias else 0]
            x = _run_layer(layer, x, key_mask, bias, encoder_type, split_lens,
                           float(rates[i]), deterministic, seeds[i], remat)

        segs = []
        for mod, seg in split_by_modality(x, encoder_type, split_lens):
            norm = getattr(self, f"{mod}_layer_norm")
            segs.append(seg if norm is None else norm(seg))
        return segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)
