"""Shared building blocks (counterpart of ``one_peace_tpu/models/components.py``).

Numerics match the JAX package:

- ``layer_norm``: eps 1e-5, biased variance, statistics and the affine in
  fp32, result cast back to the input dtype.
- ``gelu``: exact (erf) GELU computed in fp32.
- ``conv2d``: NHWC; a stride == kernel conv runs as the exact patchify
  reshape plus one matmul, the patch flattened in (kh, kw, in) order.
- ``conv1d``: NWC, with groups.
- ``dropout`` / ``drop_path``: the JAX package's masks and scales, drawn
  from an explicit ``torch.Generator`` on the tensor's device (JAX's keys
  become generators; ``split_generator`` plays ``jax.random.split``).

Weights are kept in PyTorch's layouts: dense (out, in), conv2d
(out, in, kh, kw), conv1d (out, in / groups, k).  The large products go to
``F.linear`` / ``torch.matmul`` / ``F.conv*``, as the JAX package leaves them
to XLA.  Parameters are created uninitialised; they are filled by loading
weights (``utils.checkpoint``) or by ``utils.random_weights``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with weight (out, in)."""
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), x.shape[-1:], w, b, eps).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in fp32, cast back to x's dtype."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int) -> torch.Tensor:
    """NHWC 'VALID' conv with weight (out, in, kh, kw); returns NHWC."""
    cout, cin, kh, kw = weight.shape
    b, h, wd, c = x.shape
    w = weight.to(x.dtype)
    if kh == stride and kw == stride and h % stride == 0 and wd % stride == 0:
        ho, wo = h // stride, wd // stride
        patches = x.reshape(b, ho, stride, wo, stride, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, ho, wo, stride * stride * c)
        y = patches @ w.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NWC 1-D conv with weight (out, in / groups, k); returns NWC."""
    y = F.conv1d(x.transpose(1, 2), weight.to(x.dtype), stride=stride,
                 padding=padding, groups=groups).transpose(1, 2)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def gather_rel_bias(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A (tables, R, H) rel-pos table gathered at (L, L) bucket indices, as
    contiguous fp32 (tables, H, L, L): contiguous once here, so the kernel
    takes each layer's slice without a copy."""
    return table.float()[:, idx].permute(0, 3, 1, 2).contiguous()


def split_generator(generator: Optional[torch.Generator], n: int) -> List[Optional[torch.Generator]]:
    """n CPU generators seeded from draws of ``generator`` (the role of
    ``jax.random.split``); n Nones without one."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator().manual_seed(s) for s in seeds.tolist()]


def generator_on(generator: Optional[torch.Generator], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded from one draw of ``generator``."""
    if generator is None:
        return None
    seed = torch.randint(0, 2**62, (), generator=generator, device=generator.device).item()
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate, scale by 1 / keep.
    Identity when deterministic or at rate 0; otherwise ``generator`` (on
    x's device) draws the mask."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with rate > 0 needs a generator when not deterministic")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on (B, L, D): one keep draw per batch row, shared over
    the sequence, kept rows scaled by 1 / keep (in x's dtype).  Identity when
    deterministic, without a generator, or at rate 0."""
    if deterministic or generator is None or rate == 0.0:
        return x
    keep = np.float32(1.0) - np.float32(rate)
    mask = torch.rand((x.shape[0], 1, 1), generator=generator, device=x.device) < float(keep)
    scale = np.float32(1.0) / max(keep, np.float32(1e-8)) if keep > 0 else 0.0
    scaled = x * torch.tensor(float(scale), dtype=x.dtype, device=x.device)
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


def empty_param(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                        requires_grad=False)


class LayerNorm(nn.Module):
    """Affine LayerNorm (``scale``/``bias`` in the JAX tree)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = empty_param(dim, device=device, dtype=dtype)
        self.bias = empty_param(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class Linear(nn.Module):
    """Dense layer, weight (out, in) (``w`` (in, out) in the JAX tree)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.weight = empty_param(out_features, in_features, device=device, dtype=dtype)
        self.bias = empty_param(out_features, device=device, dtype=dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """Weights of one conv, in PyTorch's layout: (out, in / groups, *kernel)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple, groups: int = 1,
                 bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.weight = empty_param(out_ch, in_ch // groups, *kernel, device=device, dtype=dtype)
        self.bias = empty_param(out_ch, device=device, dtype=dtype) if bias else None
