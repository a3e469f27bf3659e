"""UperNet segmentation head (counterpart of ``one_peace_tpu/vision/upernet.py``).

mmseg's UPerHead over the ViT-Adapter pyramid: PSP pyramid pooling on the
deepest level (exact adaptive average pooling), FPN lateral fusion and a
1x1 classifier, NHWC, GroupNorm after every conv; ``seg_cross_entropy`` is
its training objective.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..models.components import Conv, conv2d, resize_linear
from ..parallel.data import global_mean
from .adapter import ConvGN


def _adaptive_pool_matrix(in_size: int, out_size: int):
    """(out, in) row-stochastic matrix reproducing torch's
    AdaptiveAvgPool2d bin rule: bin i averages rows
    [floor(i*in/out), ceil((i+1)*in/out))."""
    import numpy as np

    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        a = (i * in_size) // out_size
        b = -((-(i + 1) * in_size) // out_size)
        m[i, a:b] = 1.0 / (b - a)
    return m


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC exact adaptive average pooling (torch ``AdaptiveAvgPool2d``'s
    bins) as two products with ``_adaptive_pool_matrix``, in fp32."""
    h, w = x.shape[1:3]
    ph = torch.from_numpy(_adaptive_pool_matrix(h, out_h)).to(x.device)
    pw = torch.from_numpy(_adaptive_pool_matrix(w, out_w)).to(x.device)
    y = torch.einsum("ph,bhwc->bpwc", ph, x.float())
    return torch.einsum("qw,bpwc->bpqc", pw, y).to(x.dtype)


class UperNetHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], channels: int = 512, num_classes: int = 150,
                 pool_scales=(1, 2, 3, 6), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        in_channels = list(in_channels)
        self.pool_scales = tuple(pool_scales)
        self.psp = nn.ModuleList(ConvGN(in_channels[-1], channels, 1, **kw)
                                 for _ in self.pool_scales)
        self.psp_bottleneck = ConvGN(in_channels[-1] + len(self.pool_scales) * channels,
                                     channels, 3, **kw)
        self.laterals = nn.ModuleList(ConvGN(c, channels, 1, **kw) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(ConvGN(channels, channels, 3, **kw)
                                       for _ in in_channels[:-1])
        self.fuse = ConvGN(len(in_channels) * channels, channels, 3, **kw)
        self.classifier = Conv(channels, num_classes, (1, 1), **kw)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats: NHWC maps shallow -> deep (strides 4, 8, 16, 32).  Returns
        (B, H4, W4, num_classes) logits at the shallowest scale."""
        deep = feats[-1]
        h, w = deep.shape[1:3]
        psp_outs = [deep]
        for scale, conv in zip(self.pool_scales, self.psp):
            psp_outs.append(resize_linear(conv(adaptive_avg_pool(deep, scale, scale)), (h, w),
                                          (1, 2)))
        top = self.psp_bottleneck(torch.cat(psp_outs, dim=-1))
        laterals = [conv(f) for conv, f in zip(self.laterals, feats[:-1])] + [top]
        for i in range(len(laterals) - 1, 0, -1):  # top-down pathway
            laterals[i - 1] = laterals[i - 1] + resize_linear(
                laterals[i], laterals[i - 1].shape[1:3], (1, 2))
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals[:-1])] + [laterals[-1]]
        outs = [resize_linear(o, outs[0].shape[1:3], (1, 2)) for o in outs]
        fused = self.fuse(torch.cat(outs, dim=-1))
        return conv2d(fused, self.classifier.weight, self.classifier.bias, 1, "SAME")


def seg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """Pixel-wise CE with the ignore label, the logits (B, h, w, C) resized to
    the labels' (B, H, W) first (``resize_linear``: JAX's bilinear weights):
    the UperNet training objective (mmseg's decode-head loss), the mean over
    the counted pixels (of the global batch across data ranks).
    ``label_smoothing`` mixes in the mean of -log p over the classes, as the
    segmentation criterion does."""
    if tuple(logits.shape[1:3]) != tuple(labels.shape[1:3]):
        logits = resize_linear(logits, labels.shape[1:3], (1, 2))
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, safe[..., None])[..., 0]
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll + label_smoothing * -lp.mean(-1)
    vf = valid.float()
    return global_mean((nll * vf).sum(), vf.sum(), min_count=1.0)
