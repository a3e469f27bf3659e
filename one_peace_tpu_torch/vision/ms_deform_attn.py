"""Multi-scale deformable attention (counterpart of
``one_peace_tpu/vision/ms_deform_attn.py``).

For each query, P sampling points per level per head are read from the
multi-scale value maps by bilinear interpolation (``grid_sample``'s
align_corners=False convention, zero outside the map) and blended by
softmaxed attention weights: the semantics of the reference's
``ms_deform_attn_core_pytorch``.  The JAX package gathers the four taps of
each point itself; here ``F.grid_sample`` (the JAX tests' own oracle) reads
them, one call per level, in fp32.  It is not a Pallas kernel in the JAX
package, and the plain version is the port: a hand-written sampling kernel
for the card is later work (ROADMAP queue 2).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.components import Linear


def ms_deform_attn_core(value: torch.Tensor, value_spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """value (N, S, M, D) flattened levels (S = sum H*W); sampling_locations
    (N, Lq, M, L, P, 2) in [0, 1] as (x, y); attention_weights (N, Lq, M, L,
    P), softmaxed over L*P.  Returns (N, Lq, M*D) in value's dtype; the
    sampling and the weighted sum run in fp32."""
    n, _, m, d = value.shape
    _, lq, _, levels, p, _ = sampling_locations.shape
    grids = (2.0 * sampling_locations.float() - 1.0).permute(0, 2, 1, 3, 4, 5)  # N M Lq L P 2
    grids = grids.reshape(n * m, lq, levels, p, 2)
    weights = attention_weights.float().permute(0, 2, 1, 3, 4).reshape(n * m, 1, lq, levels, p)
    out = None
    off = 0
    for lid, (h, w) in enumerate(value_spatial_shapes):
        vmap = value[:, off:off + h * w].float().permute(0, 2, 3, 1).reshape(n * m, d, h, w)
        off += h * w
        sampled = F.grid_sample(vmap, grids[:, :, lid], mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # (N*M, D, Lq, P)
        part = (sampled * weights[:, :, :, lid]).sum(-1)
        out = part if out is None else out + part
    out = out.reshape(n, m, d, lq).permute(0, 3, 1, 2).reshape(n, lq, m * d)
    return out.to(value.dtype)


def offset_ring(heads: int, levels: int, points: int) -> torch.Tensor:
    """The deformable-DETR init of ``sampling_offsets``' bias (``MSDeformAttnModule.init``):
    per head a direction on the unit square's ring, scaled by the point's
    index + 1; flattened (heads * levels * points * 2,)."""
    thetas = torch.arange(heads, dtype=torch.float64) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float64)[None, None, :, None]
    return grid.reshape(-1).float()


class MSDeformAttn(nn.Module):
    """The deformable-attention layer (``MSDeformAttnModule``): value, offset
    and weight projections around the sampling core, the value width
    ``d_model * ratio``."""

    def __init__(self, d_model: int, n_levels: int = 1, n_heads: int = 6, n_points: int = 4,
                 ratio: float = 1.0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.levels, self.heads, self.points = n_levels, n_heads, n_points
        self.dv = int(d_model * ratio)
        self.value_proj = Linear(d_model, self.dv, **kw)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2, **kw)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points, **kw)
        self.output_proj = Linear(self.dv, d_model, **kw)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (N, Lq, D); reference_points (N, Lq, 1, 2) in [0, 1]; value
        (N, S, D) flattened levels of ``spatial_shapes`` [(H, W)]."""
        n, lq, _ = query.shape
        s = value.shape[1]
        m, levels, p = self.heads, self.levels, self.points
        v = self.value_proj(value).reshape(n, s, m, self.dv // m)
        offsets = self.sampling_offsets(query).reshape(n, lq, m, levels, p, 2)
        weights = self.attention_weights(query).reshape(n, lq, m, levels * p)
        weights = torch.softmax(weights.float(), dim=-1).to(query.dtype)
        weights = weights.reshape(n, lq, m, levels, p)
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes], dtype=torch.float32,
                                  device=query.device)
        ref = reference_points[:, :, None, :, None, :]
        locs = ref + offsets / normalizer[None, None, None, :, None, :]
        return self.output_proj(ms_deform_attn_core(v, spatial_shapes, locs, weights))
