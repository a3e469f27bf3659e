"""Detection backbone: the windowed ONE-PEACE vision trunk and the learned
pyramid (counterpart of ``one_peace_tpu/vision/det_backbone.py``).

The trunk is the ViTDet-style arrangement of the detection recipe: hMLP patch
embed without CLS plus learned absolute positions; layers windowed except
every ``global_period``-th, which attends over the whole stride-16 grid; each
attention adds the shared rel-pos bucket bias (the pretrain table bicubic-
resized to the grid) and the layer's decomposed rel pos from the unscaled q;
Magneto LN before out_proj, GeGLU FFN with its inner LN, LayerScale.  The
layers are plain modules in a Python loop (no scan, no stacking).

With ``deterministic=False`` and a generator the training path runs: drop
path on both branches of every layer, one keep draw per image, on the
``linspace(0, drop_path_rate, layers)`` schedule.  ``checkpoint_activations``
recomputes each layer in the backward pass through ``torch.utils.checkpoint``;
each layer's masks come from a generator rebuilt from a seed drawn before the
layer runs, so the recompute draws the same masks.  (The JAX package's
``detector_training_loss`` never passes ``deterministic=False`` to the trunk,
and its ``drop_path`` draws a (B, 1, 1) mask that does not fit the trunk's
(B, h, w, C) maps; the port applies the recipe's drop path per image.)

``attn_impl="pallas"`` sends the attention of every layer through
``ops.det_attention.det_flash_attention`` (the CUDA kernel on the card, its
plain version on the CPU), with the shared bias as its Toeplitz factor; ``"xla"`` is the plain path, which materialises the (H, L, L) and
(B, H, L, L) biases as the JAX package's XLA path does.

``SimpleFeaturePyramid`` is detectron2's: transposed convs up and a max pool
down from the stride-16 map, each level's 1x1 and 3x3 convs with LN, and a
stride-2 subsample of p32 as p64.  Everything is NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.adapters.image import HMLP
from ..models.components import (Conv, LayerNorm, Linear, checkpoint_module, conv2d,
                                 conv_transpose2d, drop_path, empty_param, gelu,
                                 linear_resize_matrix, max_pool)
from ..models.rel_pos import make_image_bucket_position
from ..ops.det_attention import det_flash_attention, interpolate_rel_table, toeplitz_tables
from ..ops.quant import shared_input_linears


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C), padding H/W up to ws multiples."""
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def shared_bias_from_table(table: torch.Tensor, src_bucket: int, dst_bucket: int) -> torch.Tensor:
    """(heads, L, L) additive bias over the CLS-stripped dst grid."""
    rp = torch.from_numpy(make_image_bucket_position(dst_bucket)[1:, 1:]).to(table.device)
    values = interpolate_rel_table(table, src_bucket, dst_bucket)[rp]  # (L, L, heads)
    return values.permute(2, 0, 1)


def resize_rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """detectron2 ``get_rel_pos`` with the JAX package's resize: a (2S-1, dh)
    table linearly resized to (2*size-1, dh) when the grid differs from the
    table's.  ``jax.image.resize`` antialiases when it downsizes, where
    detectron2's ``F.interpolate`` does not; the port keeps the JAX
    semantics."""
    dst = 2 * size - 1
    if table.shape[0] == dst:
        return table
    w = torch.from_numpy(linear_resize_matrix(table.shape[0], dst)).to(table.device)
    return (w @ table.float()).to(table.dtype)


def decomposed_rel_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                        hw: Tuple[int, int]) -> torch.Tensor:
    """detectron2 ``add_decomposed_rel_pos``: q (B, L, heads, dh) unscaled,
    rel_h (2H-1, dh), rel_w (2W-1, dh) -> (B, heads, L, L) additive, in q's
    dtype (the tables resized to the grid first)."""
    h, w = hw
    rel_h = resize_rel_pos(rel_h, h)
    rel_w = resize_rel_pos(rel_w, w)
    b, _, heads, dh = q.shape
    pos_h = torch.arange(h, device=q.device)
    pos_w = torch.arange(w, device=q.device)
    rh = rel_h[pos_h[:, None] - pos_h[None, :] + h - 1].to(q.dtype)  # (H, H, dh)
    rw = rel_w[pos_w[:, None] - pos_w[None, :] + w - 1].to(q.dtype)  # (W, W, dh)
    qg = q.reshape(b, h, w, heads, dh)
    bias_h = torch.einsum("bhwnc,hkc->bnhwk", qg, rh)
    bias_w = torch.einsum("bhwnc,wkc->bnhwk", qg, rw)
    bias = bias_h[..., :, None] + bias_w[..., None, :]  # (b, n, h, w, kh, kw)
    return bias.reshape(b, heads, h * w, h * w)


class DetImageAdapter(nn.Module):
    """hMLP embed + abs pos, no CLS."""

    def __init__(self, embed_dim: int, bucket_size: int, device=None, dtype=None):
        super().__init__()
        self.bucket_size = bucket_size
        self.hmlp = HMLP(embed_dim, device=device, dtype=dtype)
        self.pos_embed = empty_param(bucket_size ** 2 + 1, embed_dim, device=device, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W), cast to the weights' dtype ->
        (B, H/16, W/16, D) with abs pos added."""
        x = self.hmlp(images.permute(0, 2, 3, 1).to(self.pos_embed.dtype))
        b, h, w, d = x.shape
        pos = self.pos_embed[1:].reshape(self.bucket_size, self.bucket_size, d)[:h, :w]
        return x + pos[None].to(x.dtype)


class DetAttention(nn.Module):
    """q/k/v (k without bias), fp32-softmax attention with the shared bucket
    bias and the decomposed rel pos, Magneto ``ln``, ``out_proj``
    (``_det_attention``)."""

    def __init__(self, d: int, heads: int, input_size: int, use_decomposed_rel_pos: bool,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = heads
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, bias=False, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)
        self.ln = LayerNorm(d, **kw)
        self.rel_pos_h = self.rel_pos_w = None
        if use_decomposed_rel_pos:
            self.rel_pos_h = empty_param(2 * input_size - 1, d // heads, **kw)
            self.rel_pos_w = empty_param(2 * input_size - 1, d // heads, **kw)

    def forward(self, x: torch.Tensor, shared_bias: Optional[torch.Tensor],
                toep: Optional[torch.Tensor], use_kernel: bool) -> torch.Tensor:
        """x (B', h, w, C).  The kernel path takes the shared bias as its
        Toeplitz factor ``toep``; the plain path as the (H, L, L)
        ``shared_bias``."""
        b, h, w, c = x.shape
        l, heads = h * w, self.heads
        dh = c // heads
        xt = x.reshape(b, l, c)
        q, k, v = (proj(xt).reshape(b, l, heads, dh)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        if use_kernel:
            rel_h = rel_w = None
            if self.rel_pos_h is not None:
                rel_h = resize_rel_pos(self.rel_pos_h, h)
                rel_w = resize_rel_pos(self.rel_pos_w, w)
            out = det_flash_attention(q, k, v, toep, rel_h, rel_w, (h, w), dh ** -0.5)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
            if shared_bias is not None:
                logits += shared_bias[None].float()
            if self.rel_pos_h is not None:
                logits += decomposed_rel_bias(q, self.rel_pos_h, self.rel_pos_w, (h, w)).float()
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out_proj(self.ln(out.reshape(b, l, c))).reshape(b, h, w, c)


class DetFFN(nn.Module):
    """``wo(ffn_ln(gelu(wi_0 x) * wi_1 x))``.  Quantized ``wi_0`` and ``wi_1``
    (``vision.zoo.quantize_serving_params``) share one row quantize of x."""

    def __init__(self, d: int, f: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wi_0 = Linear(d, f, bias=False, **kw)
        self.wi_1 = Linear(d, f, bias=False, **kw)
        self.ffn_ln = LayerNorm(f, **kw)
        self.wo = Linear(f, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = shared_input_linears(x, self.wi_0, self.wi_1)
        return self.wo(self.ffn_ln(gelu(a) * g))


class DetLayer(nn.Module):
    """One trunk layer (``det_layer``), windowed when ``window_size > 0``.
    Drop path acts on both branches, one keep draw per image, both drawn
    from ``generator`` (on x's device)."""

    def __init__(self, d: int, f: int, heads: int, input_size: int,
                 use_decomposed_rel_pos: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = DetAttention(d, heads, input_size, use_decomposed_rel_pos, **kw)
        self.self_attn_layer_norm = LayerNorm(d, **kw)
        self.final_layer_norm = LayerNorm(d, **kw)
        self.image_ffn = DetFFN(d, f, **kw)
        self.gamma_1 = empty_param(d, **kw)
        self.gamma_2 = empty_param(d, **kw)

    def forward(self, x: torch.Tensor, shared_bias, toep, window_size: int, use_kernel: bool,
                drop_path_rate: float = 0.0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.self_attn_layer_norm(x)
        hw = y.shape[1:3]
        if window_size > 0:
            y, pad_hw = window_partition(y, window_size)
        y = self.self_attn(y, shared_bias, toep, use_kernel)
        if window_size > 0:
            y = window_unpartition(y, window_size, pad_hw, hw)
        x = x + drop_path(y * self.gamma_1, drop_path_rate, deterministic, generator)
        y = self.image_ffn(self.final_layer_norm(x)) * self.gamma_2
        return x + drop_path(y, drop_path_rate, deterministic, generator)


def _run_layer(layer: DetLayer, x, bias, toep, static: dict, seed: Optional[int], remat: bool):
    """One layer, its masks drawn from a generator seeded with ``seed``;
    under remat through ``checkpoint_module``."""

    def kwargs():
        return dict(static, generator=None if seed is None
                    else torch.Generator(device=x.device).manual_seed(seed))

    if not remat:
        return layer(x, bias, toep, **kwargs())
    return checkpoint_module(layer, x, bias, toep, make_kwargs=kwargs)


class DetBackbone(nn.Module):
    """The windowed trunk: layer i attends over the whole grid when
    (i + 1) % global_period == 0 and over windows otherwise (the recipe:
    window 16, global at 3, 7, ..., 39), with drop path at
    ``linspace(0, drop_path_rate, layers)[i]`` and, with
    ``checkpoint_activations``, each layer recomputed in the backward pass."""

    def __init__(self, embed_dim=1536, ffn_embed_dim=6144, heads=24, layers=40,
                 bucket_size=64, pretrain_bucket_size=16, window_size=16, global_period=4,
                 drop_path_rate=0.0, shared_rp_bias=True, use_decomposed_rel_pos=True,
                 checkpoint_activations=True, attn_impl="pallas", device=None, dtype=None):
        super().__init__()
        assert layers % global_period == 0, (layers, global_period)
        kw = dict(device=device, dtype=dtype)
        self.d, self.f, self.heads = embed_dim, ffn_embed_dim, heads
        self.bucket_size = bucket_size
        self.pretrain_bucket_size = pretrain_bucket_size
        self.window_size = window_size
        self.global_period = global_period
        self.shared_rp_bias = shared_rp_bias
        self.use_decomposed = use_decomposed_rel_pos
        self.checkpoint_activations = checkpoint_activations
        self.attn_impl = attn_impl
        self.dpr = np.linspace(0, drop_path_rate, layers, dtype=np.float32)
        self.image_adapter = DetImageAdapter(embed_dim, bucket_size, **kw)
        self.layers = nn.ModuleList(
            DetLayer(embed_dim, ffn_embed_dim, heads,
                     bucket_size if self.is_global(i) else window_size,
                     use_decomposed_rel_pos, **kw)
            for i in range(layers))
        self.rel_pos_table = (empty_param((2 * pretrain_bucket_size - 1) ** 2 + 3, heads, **kw)
                              if shared_rp_bias else None)

    def is_global(self, i: int) -> bool:
        return (i + 1) % self.global_period == 0

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (B, 3, H, W) -> stride-16 map (B, H/16, W/16, D).
        ``generator`` (CPU) draws each layer's seed; without one, or when
        deterministic, nothing is random."""
        x = self.image_adapter(images)
        h, w = x.shape[1:3]
        assert h == w <= self.bucket_size, "square inputs up to bucket_size"
        ws = self.window_size
        use_kernel = self.attn_impl == "pallas"
        bias = bias_win = toep = toep_win = None
        if self.shared_rp_bias:
            table, src, bucket = self.rel_pos_table, self.pretrain_bucket_size, self.bucket_size
            if use_kernel:
                # the bias depends only on relative coords, so slicing the
                # bucket-sized factor to the (h, w) grid is exact
                off = bucket - h
                toep = toeplitz_tables(table, src, bucket)[:, off:off + 2 * h - 1, :w, :w]
                toep = toep.contiguous()
            else:
                full = shared_bias_from_table(table, src, bucket).reshape(
                    self.heads, bucket, bucket, bucket, bucket)
                bias = full[:, :h, :w, :h, :w].reshape(self.heads, h * w, h * w)
            if use_kernel:
                toep_win = toeplitz_tables(table, src, ws)
            else:
                bias_win = shared_bias_from_table(table, src, ws)
        n = len(self.layers)
        seeds = [None] * n
        if not deterministic and generator is not None:
            seeds = torch.randint(0, 2**62, (n,), generator=generator,
                                  device=generator.device).tolist()
        remat = self.checkpoint_activations and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            glob = self.is_global(i)
            static = dict(window_size=0 if glob else ws, use_kernel=use_kernel,
                          drop_path_rate=float(self.dpr[i]), deterministic=deterministic)
            x = _run_layer(layer, x, bias if glob else bias_win, toep if glob else toep_win,
                           static, seeds[i], remat)
        return x


class PyramidStage(nn.Module):
    """One pyramid level: its resampling, then the 1x1 lateral and 3x3
    output convs, each followed by LN."""

    def __init__(self, d: int, out: int, scale: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.scale = scale
        self.up1 = self.up1_ln = self.up2 = None
        if scale == 4.0:
            self.up1 = Conv(d, d // 2, (2, 2), **kw)
            self.up1_ln = LayerNorm(d // 2, **kw)
            self.up2 = Conv(d // 2, d // 4, (2, 2), **kw)
            cdim = d // 4
        elif scale == 2.0:
            self.up1 = Conv(d, d // 2, (2, 2), **kw)
            cdim = d // 2
        elif scale in (1.0, 0.5):
            cdim = d
        else:
            raise NotImplementedError(scale)
        self.lateral = Conv(cdim, out, (1, 1), bias=False, **kw)
        self.lateral_ln = LayerNorm(out, **kw)
        self.output = Conv(out, out, (3, 3), bias=False, **kw)
        self.output_ln = LayerNorm(out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up1 is not None:
            x = conv_transpose2d(x, self.up1.weight, self.up1.bias, 2)
        if self.up2 is not None:
            x = conv_transpose2d(gelu(self.up1_ln(x)), self.up2.weight, self.up2.bias, 2)
        if self.scale == 0.5:
            x = max_pool(x, 2, 2)
        x = self.lateral_ln(conv2d(x, self.lateral.weight, None, 1))
        return self.output_ln(conv2d(x, self.output.weight, None, 1, "SAME"))


class SimpleFeaturePyramid(nn.Module):
    """detectron2's SimpleFeaturePyramid from the stride-16 map: levels
    ``scale_4_0`` ... ``scale_0_5`` (``scale_4.0`` ... in the JAX tree) and,
    with ``top_block``, p64 as p32 subsampled by 2."""

    def __init__(self, in_dim: int, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5), top_block: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.scales = list(scale_factors)
        self.top_block = top_block
        for scale in self.scales:
            self.add_module(self.stage_name(scale),
                            PyramidStage(in_dim, out_channels, scale, device=device, dtype=dtype))

    @staticmethod
    def stage_name(scale: float) -> str:
        return f"scale_{scale}".replace(".", "_")

    def forward(self, f16: torch.Tensor) -> Dict[str, torch.Tensor]:
        """f16 (B, H, W, D) -> {p4, p8, p16, p32[, p64]} NHWC."""
        outs = {f"p{int(16 / scale)}": getattr(self, self.stage_name(scale))(f16)
                for scale in self.scales}
        if self.top_block:
            outs["p64"] = max_pool(outs["p32"], 1, 2)
        return outs
