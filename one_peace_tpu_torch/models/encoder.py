"""Fusion transformer encoder (counterpart of ``one_peace_tpu/models/encoder.py``).

Each layer: sub-LN attention (Magneto LN before out_proj; optional post-
attention LN and per-head gains), the GeGLU FFN of the token's modality,
LayerScale.  The relative-position bias stays (H, L, L) or (B, H, L, L) and
the key mask (B, L); the attention op combines them.

The JAX package stacks the layers and runs them under ``lax.scan``; here
they are an ``nn.ModuleList`` walked by a loop.  With ``deterministic=False``
and a generator the training path runs: dropout and activation dropout,
drop path on the ``linspace(0, drop_path_rate, layers)`` schedule, and
LayerDrop.  ``checkpoint_activations`` recomputes each layer in the backward
pass through ``torch.utils.checkpoint``; under ``remat_policy`` ``qkv`` the
q/k/v projections' outputs stay on the card across the checkpoint and the
recompute runs no q/k/v GEMM, under ``offload_qkv`` they wait in pinned host
memory (``components.checkpoint_module``); the attention is recomputed in
every policy.  Each layer's random masks come from a generator rebuilt from
a seed drawn before the layer runs, so the recompute draws the same masks.

Model parallelism (``parallel/``):

- under tensor parallelism (``tensor_parallel.shard_model_`` sets each
  ``Attention``'s and ``GeGLU``'s ``tp``) the attention runs on this rank's
  H/tp heads: q/k/v column-parallel, ``out_proj`` row-parallel, ``c_attn``
  and the q/v biases cut from their replicated leaves; the Magneto ``ln``,
  which normalises over the heads' outputs, is a distributed LayerNorm.
  The FFN's ``wi_0``/``wi_1`` are column-parallel and ``wo`` row-parallel;
  ``ffn_ln`` normalises over the FFN width the ranks split, with its own
  slices of scale and bias;
- ``FusionEncoder.enable_pipeline`` keeps this pipeline stage's layers only
  and routes the stack through GPipe (``parallel/pipeline.py``), under the
  JAX package's conditions; a per-layer per-sample bias, which JAX runs
  serially on every stage, is refused (a stage holds its own layers only),
  and a batch the micro-batch count does not divide runs in uneven
  micro-batches.  Each stage
  runs its layers whole under the stage's remat (``checkpoint_activations``
  recomputes the stage, not each layer), and each micro-batch draws its rows'
  masks of the whole batch (``parallel.data.Rows.micro``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import EncoderConfig

from ..ops.attention import multihead_attention
from ..ops.quant import shared_input_linears
from ..parallel import tensor_parallel as tpar
from ..parallel.data import Rows, batch_rows, current_rows
from .components import (LayerNorm, Linear, checkpoint_module, drop_path, dropout, empty_param,
                         gelu, saved_projections)

MODALITIES = ("text", "image", "audio")


class Attention(nn.Module):
    """q/k/v projections (k_proj has no bias), optional per-head gains
    ``c_attn``, Magneto ``ln``, ``out_proj`` (``_attention``).  Any
    projection may be a ``QuantizedLinear`` (``ops.quant.quantize_ffn_``);
    q/k/v then share one row quantize of x.  The q/k/v GEMMs run in a
    ``saved_projections`` scope: the ``qkv`` remat policies keep them."""

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
        self.tp = None  # a tensor_parallel.Shard: this rank's heads

    def forward(self, x, rel_bias, key_padding_mask):
        b, l, d = x.shape
        hd = d // self.cfg.attention_heads
        tp = self.tp
        if tp is None or tp.size == 1:
            with saved_projections():
                q, k, v = shared_input_linears(x, self.q_proj, self.k_proj, self.v_proj)
        else:
            x = tpar.copy_to(x, tp)
            with saved_projections():
                q, k, v = (F.linear(x, lin.weight, tpar.slice_from(lin.bias, 0, tp))
                           for lin in (self.q_proj, self.k_proj, self.v_proj))
        h = q.shape[-1] // hd  # this rank's heads
        q, k, v = (y.reshape(b, l, h, hd) for y in (q, k, v))
        attn = multihead_attention(q, k, v, rel_bias, key_padding_mask,
                                   scaling=hd**-0.5, impl=self.cfg.attn_impl)
        if self.c_attn is not None:
            attn = attn * tpar.slice_from(self.c_attn, 0, tp)[:, None]
        attn = attn.reshape(b, l, h * hd)
        if self.ln is not None:
            attn = tpar.layer_norm(attn, tpar.slice_from(self.ln.weight, 0, tp),
                                   tpar.slice_from(self.ln.bias, 0, tp), tp)
        return tpar.row_linear(attn, self.out_proj, tp)


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
        self.tp = None  # a tensor_parallel.Shard: this rank's FFN columns

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        tp = self.tp
        if tp is None or tp.size == 1:
            a, g = shared_input_linears(x, self.wi_0, self.wi_1)
        else:
            x = tpar.copy_to(x, tp)
            a, g = F.linear(x, self.wi_0.weight), F.linear(x, self.wi_1.weight)
        y = gelu(a) * g
        y = dropout(y, self.activation_dropout, deterministic, generator, shard=tp)
        if self.ffn_ln is not None:
            y = tpar.layer_norm(y, self.ffn_ln.weight, self.ffn_ln.bias, tp)
        return tpar.row_linear(y, self.wo, tp)


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
               rate: float, deterministic: bool, seed: Optional[int], remat: Optional[str]):
    """One layer, its masks drawn from a generator seeded with ``seed``;
    under remat (the policy's name) through ``checkpoint_module``."""

    def kwargs():
        return dict(generator=None if seed is None
                    else torch.Generator(device=x.device).manual_seed(seed))

    args = (x, key_mask, bias, encoder_type, split_lens, rate, deterministic)
    if not remat:
        return layer(*args, **kwargs())
    return checkpoint_module(layer, *args, make_kwargs=kwargs, policy=remat)


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
        self.pipeline = None  # (pp Shard, its global ranks, micro-batches, this stage's layers)

    def enable_pipeline(self, shard: "tpar.Shard", ranks, num_micro_batches: int) -> None:
        """Route the stack through GPipe over ``shard`` (the ``pp`` group,
        ``ranks`` its global ranks in stage order) with ``num_micro_batches``
        micro-batches, keeping this stage's layers only: the others become
        empty modules, so that the parameters this rank holds keep their
        names."""
        n = self.cfg.layers
        if n % shard.size:
            raise ValueError(f"distributed.pp={shard.size} does not divide the encoder's {n} "
                             f"layers: each pipeline stage holds an equal share")
        per = n // shard.size
        owned = range(shard.rank * per, (shard.rank + 1) * per)
        for i in range(n):
            if i not in owned:
                self.layers[i] = nn.Module()
        self.pipeline = (shard, list(ranks), num_micro_batches, list(owned))

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
        remat = (cfg.remat_policy if cfg.checkpoint_activations and torch.is_grad_enabled()
                 else None)
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
        if self.pipeline is not None:
            if per_layer_bias and rel_bias.ndim == 5:
                raise NotImplementedError(
                    "distributed.pp > 1 with a per-layer per-sample rel-pos bias "
                    "(layers, B, H, L, L): JAX runs that stack serially on every stage, which "
                    "holds every layer there; a pipeline stage here holds its own layers only")
            x = self._pipelined(x, key_mask, rel_bias, per_layer_bias, encoder_type, split_lens,
                                rates, deterministic, seeds, keep)
        else:
            x = self._serial(x, key_mask, rel_bias, per_layer_bias, encoder_type, split_lens,
                             rates, deterministic, seeds, keep, remat)

        segs = []
        for mod, seg in split_by_modality(x, encoder_type, split_lens):
            norm = getattr(self, f"{mod}_layer_norm")
            segs.append(seg if norm is None else norm(seg))
        return segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)

    def _serial(self, x, key_mask, rel_bias, per_layer_bias, encoder_type, split_lens, rates,
                deterministic, seeds, keep, remat):
        for i, layer in enumerate(self.layers):
            if not keep[i]:  # LayerDrop skips the whole layer
                continue
            bias = None if rel_bias is None else rel_bias[i if per_layer_bias else 0]
            x = _run_layer(layer, x, key_mask, bias, encoder_type, split_lens,
                           float(rates[i]), deterministic, seeds[i], remat)
        return x

    def _pipelined(self, x, key_mask, rel_bias, per_layer_bias, encoder_type, split_lens,
                   rates, deterministic, seeds, keep):
        """The stack through ``parallel.pipeline.pipeline_forward``: the
        padding mask and a per-sample bias follow their micro-batch, a
        shared bias (or this stage's tables of a per-layer one) goes whole
        to every micro-batch."""
        from ..parallel.pipeline import pipeline_forward

        shard, ranks, num_micro, owned = self.pipeline
        bias = None if rel_bias is None else (rel_bias[owned[0]:owned[-1] + 1]
                                              if per_layer_bias else rel_bias[0])
        batched = bias is not None and not per_layer_bias and bias.ndim == 4
        stage = self.stage_fn(owned, num_micro, x.shape[0], per_layer_bias,
                              batched, encoder_type, split_lens, rates, deterministic, seeds,
                              keep)
        params = [p for i in owned for _, p in self.layers[i].named_parameters()]
        return pipeline_forward(stage, params, x, shard, ranks, num_micro,
                                batch_aux=(key_mask, bias if batched else None),
                                broadcast_aux=(None if batched else bias,),
                                checkpoint_stages=self.cfg.checkpoint_activations)

    def stage_fn(self, owned, num_micro: int, total: int, per_layer_bias: bool, batched: bool,
                 encoder_type: str, split_lens, rates, deterministic: bool, seeds, keep):
        """The pipeline's ``stage_fn`` for the layers ``owned``, on
        ``num_micro`` micro-batches (``parallel.pipeline.micro_batches``) of
        this rank's ``total`` rows: ``stage(m, x_m, (mask_m,
        batch_bias_m), (bias,), params)``, ``params`` the layers' parameters
        in ``named_parameters`` order, ``bias`` the stage's tables of a
        per-layer bias or a shared one.  Micro-batch ``m`` draws the masks of
        its rows of the whole batch."""
        from ..parallel.pipeline import micro_batches

        names = [[n for n, _ in self.layers[i].named_parameters()] for i in owned]
        bounds = micro_batches(total, num_micro)
        rows = current_rows()
        whole = Rows([total], 0) if rows is None else rows

        def stage(m, h, aux, bcast, flat):
            mask, batch_bias = aux
            shared = bcast[0]
            it = iter(flat)
            with batch_rows(whole.micro(*bounds[m])):
                for j, (i, layer_names) in enumerate(zip(owned, names)):
                    tensors = {n: next(it) for n in layer_names}
                    if not keep[i]:
                        continue
                    layer_bias = (batch_bias if batched else
                                  None if shared is None else
                                  shared[j] if per_layer_bias else shared)
                    gen = (None if seeds[i] is None
                           else torch.Generator(device=h.device).manual_seed(seeds[i]))
                    h = torch.func.functional_call(
                        self.layers[i], tensors,
                        (h, mask, layer_bias, encoder_type, split_lens, float(rates[i]),
                         deterministic), {"generator": gen})
            return h

        return stage
