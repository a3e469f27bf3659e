"""Region Proposal Network (counterpart of ``one_peace_tpu/vision/rpn.py``):
the detection recipe's proposer, detectron2's StandardRPNHead with anchors of
8 * stride per level and aspect ratios {0.5, 1, 2}, Box2BoxTransform deltas,
the host-side proposal decode, and the training losses: the Matcher's
[0.3, 0.7] thresholds with low-quality force-matching, and detectron2's
256-anchor 1:1 subsample as static weight vectors (``sampler="subsample"``)
or the deterministic balanced weighting (``"balanced"``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.components import Conv, conv2d
from ..parallel.data import leading_rows
from .detection import empty_result, nms

# detectron2's Box2BoxTransform scale clamp: log(1000/16)
_DELTA_CLAMP = float(np.log(1000.0 / 16.0))


def cell_anchors(stride: int, ratios: Sequence[float], scale: float) -> np.ndarray:
    """(A, 4) anchors centred at the origin (detectron2
    generate_cell_anchors): area (scale*stride)^2, w = sqrt(area/r), h = r*w."""
    size = scale * stride
    out = []
    for r in ratios:
        w = np.sqrt(size * size / r)
        h = r * w
        out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float64)


def level_anchors(h: int, w: int, stride: int, ratios: Sequence[float],
                  scale: float) -> np.ndarray:
    """(h*w*A, 4) xyxy anchors for one pyramid level."""
    cell = cell_anchors(stride, ratios, scale)
    xs = (np.arange(w) + 0.5) * stride
    ys = (np.arange(h) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)
    centers = np.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
    return (centers + cell[None]).reshape(-1, 4).astype(np.float32)


def apply_deltas(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas (weights 1): anchors (..., 4) xyxy +
    deltas (..., 4) -> boxes (..., 4)."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    dx, dy, dw, dh = deltas.unbind(-1)
    x = xa + dx * wa
    y = ya + dy * ha
    w = wa * torch.exp(dw.clamp(max=_DELTA_CLAMP))
    h = ha * torch.exp(dh.clamp(max=_DELTA_CLAMP))
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


def boxes_to_deltas(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """The inverse transform (regression targets) of ``apply_deltas``."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    wg = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)
    hg = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)
    xg = boxes[..., 0] + 0.5 * wg
    yg = boxes[..., 1] + 0.5 * hg
    return torch.stack([(xg - xa) / wa, (yg - ya) / ha, torch.log(wg / wa),
                        torch.log(hg / ha)], -1)


class RPNHead(nn.Module):
    """Shared 3x3 conv tower + objectness / delta 1x1 convs over the pyramid
    (the ViTDet recipe's conv_dims=(-1, -1): two 3x3 convs)."""

    def __init__(self, in_channels: int, channels: int = 256, num_convs: int = 2,
                 strides: Sequence[int] = (4, 8, 16, 32),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0), anchor_scale: float = 8.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.strides = list(strides)
        self.ratios = list(anchor_ratios)
        self.scale = anchor_scale
        self.num_anchors = len(anchor_ratios)
        self.convs = nn.ModuleList(
            Conv(in_channels if i == 0 else channels, channels, (3, 3), **kw)
            for i in range(num_convs))
        self.obj = Conv(channels, self.num_anchors, (1, 1), **kw)
        self.deltas = Conv(channels, 4 * self.num_anchors, (1, 1), **kw)

    def forward(self, feats: List[torch.Tensor]):
        """feats: NHWC maps per stride.  Returns per level (objectness
        (B, H, W, A), deltas (B, H, W, A, 4))."""
        outs = []
        for x in feats:
            for c in self.convs:
                x = torch.relu(conv2d(x, c.weight, c.bias, 1, "SAME"))
            obj = conv2d(x, self.obj.weight, self.obj.bias, 1, "SAME")
            d = conv2d(x, self.deltas.weight, self.deltas.bias, 1, "SAME")
            b, h, w, _ = d.shape
            outs.append((obj, d.reshape(b, h, w, self.num_anchors, 4)))
        return outs

    def all_anchors(self, level_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
        """(sum_l h_l*w_l*A, 4) anchors over all levels."""
        return np.concatenate([level_anchors(h, w, s, self.ratios, self.scale)
                               for (h, w), s in zip(level_shapes, self.strides)], axis=0)

    def decode(self, outputs, score_thresh: float = 0.0, max_dets: int = 1000,
               nms_thresh: float = 0.7, pre_nms_topk: int = 1000) -> List[Dict[str, np.ndarray]]:
        """Proposals per image (FCOSHead.decode's contract; labels all 0).
        The boxes and sigmoid scores are computed on the device in fp32, the
        top-k and NMS on the host."""
        batch = outputs[0][0].shape[0]
        host_levels = []
        for (obj, deltas), stride in zip(outputs, self.strides):
            b, h, w = obj.shape[:3]
            anchors = torch.from_numpy(level_anchors(h, w, stride, self.ratios, self.scale))
            boxes = apply_deltas(anchors.to(deltas.device), deltas.float().reshape(b, -1, 4))
            host_levels.append((torch.sigmoid(obj).float().reshape(b, -1).cpu().numpy(),
                                boxes.cpu().numpy()))
        results = []
        for bi in range(batch):
            boxes_all, scores_all = [], []
            for scores, boxes in host_levels:
                s, bx = scores[bi], boxes[bi]
                k = min(pre_nms_topk, len(s))
                top = np.argpartition(-s, k - 1)[:k] if k < len(s) else np.arange(len(s))
                keep = s[top] > score_thresh
                boxes_all.append(bx[top][keep])
                scores_all.append(s[top][keep])
            bx = np.concatenate(boxes_all)
            sc = np.concatenate(scores_all)
            if len(bx) == 0:
                results.append(empty_result())
                continue
            keep = nms(bx, sc, nms_thresh)[:max_dets]
            results.append({"boxes": bx[keep], "scores": sc[keep],
                            "labels": np.zeros((len(keep),), np.int64)})
        return results


def _box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-6)


def _uniforms(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """The sampler's random numbers for one image: (2, n) uniforms, the
    positives' then the negatives'."""
    return torch.rand(2, n, generator=generator, device=device)


def _sample_weights(pos: torch.Tensor, neg: torch.Tensor, generator: torch.Generator,
                    batch_size: int = 256, pos_fraction: float = 0.5):
    """detectron2's subsample_labels as static weight vectors: min(#pos, 128)
    random positives, filled to 256 with random negatives, weight 1 each.
    The draws come from ``generator`` on the masks' device."""
    u_pos, u_neg = _uniforms(generator, pos.shape[0], pos.device)

    def ranks(mask, u):  # rank of each masked anchor in a random order of the masked set
        key = u + (~mask).float() * 10.0
        return torch.argsort(torch.argsort(key, stable=True), stable=True)

    n_pos = pos.sum().clamp(max=int(batch_size * pos_fraction))
    sel_pos = pos & (ranks(pos, u_pos) < n_pos)
    n_neg = torch.minimum(neg.sum(), batch_size - n_pos)
    sel_neg = neg & (ranks(neg, u_neg) < n_neg)
    return sel_pos.float(), sel_neg.float()


def rpn_loss(head: RPNHead, feats: List[torch.Tensor], gt_boxes, gt_labels, gt_valid,
             sampler: str = "subsample", generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Objectness and box losses (detectron2 rpn.py losses), per image, then
    the mean over images.  feats: per-level NHWC maps; gt_boxes (B, M, 4);
    gt_valid (B, M) bool; gt_labels is unused (the RPN is class-agnostic).
    ``sampler="subsample"`` needs ``generator`` (on the maps' device): without
    one it raises, as the JAX package does, rather than draw the same sample
    every step."""
    outs = head(feats)
    device = outs[0][0].device
    anchors = torch.from_numpy(head.all_anchors([o.shape[1:3] for o, _ in outs])).to(device)
    b = outs[0][0].shape[0]
    obj_flat = torch.cat([o.reshape(b, -1) for o, _ in outs], 1)  # (B, N)
    delta_flat = torch.cat([d.reshape(b, -1, 4) for _, d in outs], 1)  # (B, N, 4)
    if sampler == "subsample" and generator is None:
        raise ValueError("rpn_loss(sampler='subsample') needs a generator; pass one through "
                         "detector_training_loss, or set criterion.rpn_sampler='balanced'")

    if sampler == "subsample":  # the draws of the global batch's earlier images
        for _ in range(leading_rows()[0]):
            _uniforms(generator, anchors.shape[0], device)
    obj_losses, box_losses, n_pos = [], [], []
    for i in range(b):
        gtb, gtv = gt_boxes[i].float(), gt_valid[i].bool()
        with torch.no_grad():  # the matching: targets only
            iou = torch.where(gtv[None, :], _box_iou(anchors, gtb), -1.0)
            best_iou, best_gt = iou.max(-1)
            pos = best_iou >= 0.7
            neg = (best_iou < 0.3) & (best_iou > -0.5)  # all-invalid rows stay negative
            if not bool(gtv.any()):
                neg = torch.ones_like(neg)
            # low-quality force-match: an anchor at a valid GT's best IoU is positive
            gt_best = iou.max(0).values
            pos |= ((iou == gt_best[None, :]) & gtv[None, :] & (gt_best[None, :] > 0)).any(-1)
            neg &= ~pos
            tgt = boxes_to_deltas(anchors, gtb[best_gt])
        posf = pos.float()
        logits = obj_flat[i].float()
        bce = logits.clamp(min=0) - logits * posf + torch.log1p(torch.exp(-logits.abs()))
        if sampler == "subsample":  # 256 anchors, <= 128 positive, normalised by 256
            w_pos, w_neg = _sample_weights(pos, neg, generator)
            obj_losses.append((bce * (w_pos + w_neg)).sum() / 256.0)
            box_w, box_n = w_pos, 256.0
        else:  # balanced: positives and negatives each carry half the weight
            negf = neg.float()
            obj_losses.append(0.5 * (bce * posf).sum() / posf.sum().clamp(min=1.0)
                              + 0.5 * (bce * negf).sum() / negf.sum().clamp(min=1.0))
            box_w, box_n = posf, posf.sum().clamp(min=1.0)
        box_losses.append(((delta_flat[i].float() - tgt).abs().sum(-1) * box_w).sum() / box_n)
        n_pos.append(posf.sum())
    obj_l, box_l = torch.stack(obj_losses).mean(), torch.stack(box_losses).mean()
    return obj_l + box_l, {"rpn_obj": obj_l, "rpn_box": box_l,
                           "rpn_pos": torch.stack(n_pos).mean()}
