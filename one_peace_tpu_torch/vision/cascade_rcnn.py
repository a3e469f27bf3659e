"""Cascade R-CNN box heads and the mask head (counterpart of
``one_peace_tpu/vision/cascade_rcnn.py``): proposals are RoIAligned from the
pyramid, passed through each stage's two-FC box head and refined by its
class-agnostic deltas; the class scores are the mean of the stages' softmax.
The RoI features flatten in NHWC order, so ``fc1`` takes the JAX weights as
they are.  Training (``cascade_box_loss``): per-stage IoU assignment on the
0.5 / 0.6 / 0.7 schedule, CE and smooth-L1 losses, proposals refined from
stage to stage without gradient."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.components import Conv, Linear, conv2d, conv_transpose2d
from .detection import batched_nms
from .roi_align import multi_level_roi_align, roi_align

# the standard Faster R-CNN box-delta weights of each cascade stage
STAGE_DELTA_WEIGHTS = ((10.0, 10.0, 5.0, 5.0),
                       (20.0, 20.0, 10.0, 10.0),
                       (30.0, 30.0, 15.0, 15.0))


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor,
                 weights: Tuple[float, float, float, float], clip: float = 4.135) -> torch.Tensor:
    """(N, 4) boxes (x0, y0, x1, y1) + (N, 4) deltas -> refined boxes."""
    wx, wy, ww, wh = weights
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = (deltas[:, 2] / ww).clamp(-clip, clip)
    dh = (deltas[:, 3] / wh).clamp(-clip, clip)
    ncx = cx + dx * w
    ncy = cy + dy * h
    nw = w * torch.exp(dw)
    nh = h * torch.exp(dh)
    return torch.stack([ncx - 0.5 * nw, ncy - 0.5 * nh, ncx + 0.5 * nw, ncy + 0.5 * nh], dim=1)


def _pool(features, strides, boxes, batch_indices, output_size: int, spatial_scale: float):
    """A list of per-stride maps -> detectron2's multi-level ROIPooler; one
    (B, H, W, C) map -> RoIAlign at ``spatial_scale``."""
    if isinstance(features, (list, tuple)):
        return multi_level_roi_align(features, strides, boxes, batch_indices,
                                     output_size=output_size)
    return roi_align(features, boxes, batch_indices, output_size=output_size,
                     spatial_scale=spatial_scale)


class CascadeStage(nn.Module):
    def __init__(self, flat: int, fc_dim: int, num_classes: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Linear(flat, fc_dim, **kw)
        self.fc2 = Linear(fc_dim, fc_dim, **kw)
        self.box = Linear(fc_dim, 4, **kw)  # class-agnostic regression
        self.cls = Linear(fc_dim, num_classes + 1, **kw)

    def forward(self, pooled: torch.Tensor):
        x = torch.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        x = torch.relu(self.fc2(x))
        return self.cls(x), self.box(x)


class CascadeBoxHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, pooled_size: int = 7,
                 fc_dim: int = 1024, num_stages: int = 3, spatial_scale: float = 1 / 16,
                 feature_strides: Sequence[int] = (4, 8, 16, 32), device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.pooled = pooled_size
        self.spatial_scale = spatial_scale
        self.feature_strides = list(feature_strides)
        self.stages = nn.ModuleList(
            CascadeStage(in_channels * pooled_size ** 2, fc_dim, num_classes,
                         device=device, dtype=dtype) for _ in range(num_stages))

    def forward(self, features, proposals: torch.Tensor, batch_indices: torch.Tensor):
        """features: one (B, H, W, C) map or the per-stride pyramid maps;
        proposals (N, 4) in input pixels.  Returns (scores (N, classes+1)
        fp32, the mean over stages, and the refined boxes (N, 4) fp32)."""
        boxes = proposals.float()
        all_scores = []
        for s, stage in enumerate(self.stages):
            pooled = _pool(features, self.feature_strides, boxes, batch_indices,
                           self.pooled, self.spatial_scale)
            cls_logits, deltas = stage(pooled)
            all_scores.append(torch.softmax(cls_logits.float(), -1))
            boxes = apply_deltas(boxes, deltas.float(), STAGE_DELTA_WEIGHTS[s])
        return torch.stack(all_scores).mean(0), boxes

    @staticmethod
    def decode(scores, boxes, score_thresh: float = 0.05, iou_thresh: float = 0.6,
               max_dets: int = 100) -> Dict[str, np.ndarray]:
        """Host-side: drop the background column, class-wise NMS."""
        scores = np.asarray(scores, np.float32)[:, :-1]  # last column = background
        boxes = np.asarray(boxes, np.float32)
        n, c = scores.shape
        flat = scores.reshape(-1)
        keep = flat > score_thresh
        box_idx, labels = np.divmod(np.nonzero(keep)[0], c)
        sel_boxes = boxes[box_idx]
        sel_scores = flat[keep]
        order = batched_nms(sel_boxes, sel_scores, labels, iou_thresh)[:max_dets]
        return {"boxes": sel_boxes[order], "scores": sel_scores[order],
                "labels": labels[order].astype(np.int64)}


class MaskHead(nn.Module):
    """Mask R-CNN mask head: 4 convs, a 2x transposed conv, per-class mask
    logits over RoIAligned features."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 pooled_size: int = 14, spatial_scale: float = 1 / 16,
                 feature_strides: Sequence[int] = (4, 8, 16, 32), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pooled = pooled_size
        self.spatial_scale = spatial_scale
        self.feature_strides = list(feature_strides)
        self.convs = nn.ModuleList(
            Conv(in_channels if i == 0 else channels, channels, (3, 3), **kw) for i in range(4))
        self.deconv = Conv(channels, channels, (2, 2), **kw)  # transposed, (out, in, kh, kw)
        self.predictor = Conv(channels, num_classes, (1, 1), **kw)

    def forward(self, features, boxes: torch.Tensor, batch_indices: torch.Tensor):
        """-> (N, 2*pooled, 2*pooled, num_classes) mask logits."""
        x = _pool(features, self.feature_strides, boxes, batch_indices, self.pooled,
                  self.spatial_scale)
        for c in self.convs:
            x = torch.relu(conv2d(x, c.weight, c.bias, 1, "SAME"))
        x = torch.relu(conv_transpose2d(x, self.deconv.weight, self.deconv.bias, 2, "SAME"))
        return conv2d(x, self.predictor.weight, self.predictor.bias, 1, "SAME")


# ---------------------------------------------------------------------------
# training: per-stage target assignment and losses (the cascade IoU schedule)
# ---------------------------------------------------------------------------

CASCADE_IOU_THRESHOLDS = (0.5, 0.6, 0.7)


def boxes_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) IoU."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-9)


def encode_deltas(boxes: torch.Tensor, targets: torch.Tensor, weights) -> torch.Tensor:
    """The inverse of ``apply_deltas``: regression targets of matched boxes."""
    wx, wy, ww, wh = weights
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    tw = targets[:, 2] - targets[:, 0]
    th = targets[:, 3] - targets[:, 1]
    tcx = targets[:, 0] + 0.5 * tw
    tcy = targets[:, 1] + 0.5 * th
    w, h = w.clamp(min=1e-6), h.clamp(min=1e-6)
    return torch.stack([wx * (tcx - cx) / w, wy * (tcy - cy) / h,
                        ww * torch.log(tw.clamp(min=1e-6) / w),
                        wh * torch.log(th.clamp(min=1e-6) / h)], dim=1)


def assign_targets(proposals, gt_boxes, gt_labels, gt_valid, iou_threshold: float,
                   num_classes: int):
    """IoU matcher: a proposal takes its best valid GT at IoU >= threshold,
    else background (label ``num_classes``).  Returns (labels (N,),
    matched boxes (N, 4), foreground mask (N,))."""
    iou = torch.where(gt_valid[None, :], boxes_iou(proposals, gt_boxes), -1.0)
    best_iou, best = iou.max(1)
    fg = best_iou >= iou_threshold
    labels = torch.where(fg, gt_labels[best], num_classes)
    return labels, gt_boxes[best], fg


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def cascade_box_loss(head: CascadeBoxHead, features, proposals, batch_indices, gt_boxes,
                     gt_labels, gt_valid, prop_valid=None):
    """The cascade's training loss: per stage, CE over the stage's logits and
    smooth-L1 on the deltas of foreground proposals; the proposals are
    refined for the next stage and detached.  Padded GTs are masked by
    ``gt_valid``, padded proposals by ``prop_valid``."""
    boxes = proposals.float()
    gt_boxes, gt_valid = gt_boxes.float(), gt_valid.bool()
    pv = (torch.ones(boxes.shape[:1], device=boxes.device) if prop_valid is None
          else prop_valid.float())
    n_valid = pv.sum().clamp(min=1.0)
    total_cls = total_box = 0.0
    metrics = {}
    for s, stage in enumerate(head.stages):
        labels, matched, fg = assign_targets(boxes, gt_boxes, gt_labels.long(), gt_valid,
                                             CASCADE_IOU_THRESHOLDS[min(s, 2)], head.num_classes)
        cls_logits, deltas = stage(_pool(features, head.feature_strides, boxes, batch_indices,
                                         head.pooled, head.spatial_scale))
        lp = torch.log_softmax(cls_logits.float(), -1)
        total_cls = total_cls + (-lp.gather(1, labels[:, None])[:, 0] * pv).sum() / n_valid
        weights = STAGE_DELTA_WEIGHTS[s]
        box_err = smooth_l1(deltas.float() - encode_deltas(boxes, matched, weights)).sum(-1)
        fgf = fg.float() * pv
        total_box = total_box + (box_err * fgf).sum() / fgf.sum().clamp(min=1.0)
        metrics[f"stage{s}_fg"] = fgf.sum() / n_valid
        boxes = apply_deltas(boxes, deltas.float(), weights).detach()
    n = len(head.stages)
    metrics.update(cls_loss=total_cls / n, box_loss=total_box / n)
    return (total_cls + total_box) / n, metrics
