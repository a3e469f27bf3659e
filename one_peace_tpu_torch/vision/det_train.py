"""The detector's training objective (counterpart of
``one_peace_tpu/vision/det_train.py``): the proposer's losses (RPN, the
recipe's, or FCOS), the 3-stage cascade on jittered GT boxes and the mask
head on GT masks, over static padded GT slots (``gt_valid``).

FCOS (Tian et al. 2019): sigmoid focal loss over every pyramid location, IoU
loss from the (l, t, r, b) distances and centerness BCE at positive
locations; a location is positive for the smallest valid GT box that
contains it and whose largest distance falls in the level's range.

The JAX package ``vmap``s per image; here a loop over the batch keeps the
same per-image semantics (assignment, the cascade's CE mean).  The caller's
generator is split into three streams: the trunk's drop path, the RPN
sampler and the proposal jitter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..models.components import generator_on, split_generator
from .cascade_rcnn import cascade_box_loss
from .roi_align import roi_align
from .rpn import rpn_loss

# the RPN sampler's seed in deterministic mode (a validation loss)
DETERMINISTIC_SAMPLER_SEED = 0


def optax_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    p = torch.sigmoid(logits)
    ce = optax_bce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def _level_points(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """(h*w, 2) location centres (x, y) in input pixels."""
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) * stride
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) * stride
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)


def _assign_level(points, gt_boxes, gt_valid, range_lo: float, range_hi: float):
    """points (P, 2); one image's gt (M, 4).  Returns (index into the GTs
    (P,), the chosen GT's (l, t, r, b) (P, 4), positive (P,) bool)."""
    x, y = points[:, 0:1], points[:, 1:2]
    ltrb = torch.stack([x - gt_boxes[None, :, 0], y - gt_boxes[None, :, 1],
                        gt_boxes[None, :, 2] - x, gt_boxes[None, :, 3] - y], -1)  # (P, M, 4)
    maxd = ltrb.max(-1).values
    ok = (ltrb.min(-1).values > 0) & (maxd >= range_lo) & (maxd <= range_hi) & gt_valid[None, :]
    area = ((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]))[None, :]
    area = torch.where(ok, area, torch.inf)
    best = area.argmin(-1)
    pos = torch.isfinite(area.min(-1).values)
    return best, ltrb.gather(1, best[:, None, None].expand(-1, 1, 4))[:, 0], pos


def fcos_loss(head, feats: List[torch.Tensor], gt_boxes, gt_labels, gt_valid
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """feats: per-level NHWC maps (``head.strides``); gt_boxes (B, M, 4) in
    input pixels, gt_labels (B, M) int, gt_valid (B, M) bool."""
    outs = head(feats)
    strides = head.strides
    total_cls = total_box = total_ctr = num_pos = 0.0
    for li, ((cls, box, ctr), stride) in enumerate(zip(outs, strides)):
        bsz, h, w, nc = cls.shape
        pts = _level_points(h, w, stride, cls.device)
        lo = 0.0 if li == 0 else strides[li] * 4.0
        hi = float("inf") if li == len(strides) - 1 else strides[li] * 8.0
        for i in range(bsz):
            with torch.no_grad():
                best, ltrb, pos = _assign_level(pts, gt_boxes[i].float(), gt_valid[i].bool(),
                                                lo, hi)
            posf = pos.float()
            lab = gt_labels[i].long()[best]
            cls_tgt = torch.nn.functional.one_hot(lab, nc).float() * posf[:, None]
            total_cls = total_cls + sigmoid_focal_loss(cls[i].reshape(-1, nc).float(),
                                                       cls_tgt).sum()
            # IoU loss from the distances
            pred = box[i].reshape(-1, 4).float()
            tgt = ltrb.clamp(min=0.0)
            inter = ((torch.minimum(pred[:, 0], tgt[:, 0]) + torch.minimum(pred[:, 2], tgt[:, 2]))
                     * (torch.minimum(pred[:, 1], tgt[:, 1])
                        + torch.minimum(pred[:, 3], tgt[:, 3])))
            area_p = (pred[:, 0] + pred[:, 2]) * (pred[:, 1] + pred[:, 3])
            area_t = (tgt[:, 0] + tgt[:, 2]) * (tgt[:, 1] + tgt[:, 3])
            iou = inter / (area_p + area_t - inter).clamp(min=1e-6)
            total_box = total_box + (-torch.log(iou.clamp(1e-6, 1.0)) * posf).sum()
            # centerness target
            lr, tb = tgt[:, 0::2], tgt[:, 1::2]
            ctr_tgt = torch.sqrt(((lr.min(-1).values / lr.max(-1).values.clamp(min=1e-6))
                                  * (tb.min(-1).values / tb.max(-1).values.clamp(min=1e-6))
                                  ).clamp(0.0, 1.0))
            total_ctr = total_ctr + (optax_bce(ctr[i].reshape(-1).float(), ctr_tgt) * posf).sum()
            num_pos = num_pos + posf.sum()
    denom = torch.as_tensor(num_pos).clamp(min=1.0)
    loss = (total_cls + total_box + total_ctr) / denom
    return loss, {"fcos_cls": total_cls / denom, "fcos_box": total_box / denom,
                  "fcos_ctr": total_ctr / denom, "fcos_pos": torch.as_tensor(num_pos)}


def mask_loss(head, features, boxes, batch_indices, gt_masks, mask_labels, valid,
              mask_stride: int = 1) -> torch.Tensor:
    """BCE of each box's GT-class mask logits against its GT instance mask
    RoI-cropped to the box.  gt_masks (N, H/ms, W/ms), the matched instance
    per box, rasterised at stride ``mask_stride`` of the input pixels."""
    logits = head(features, boxes, batch_indices)  # (N, s, s, C)
    n, s = logits.shape[:2]
    sel = logits.gather(-1, mask_labels.long()[:, None, None, None].expand(n, s, s, 1))[..., 0]
    with torch.no_grad():
        tgt = roi_align(gt_masks[..., None].float(), boxes.float() / float(mask_stride),
                        torch.arange(n, device=boxes.device), output_size=s,
                        spatial_scale=1.0)[..., 0]
        tgt = (tgt > 0.5).float()
    per = optax_bce(sel.float(), tgt).mean((1, 2))
    vf = valid.float()
    return (per * vf).sum() / vf.sum().clamp(min=1.0)


def detector_training_loss(detector, images, gt_boxes, gt_labels, gt_valid,
                           gt_masks: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           proposal_jitter: float = 0.1, mask_stride: int = 1,
                           rpn_sampler: str = "subsample", deterministic: bool = False):
    """The cascade mask R-CNN training objective.

    images (B, 3, H, W); gt_boxes (B, M, 4); gt_labels (B, M); gt_valid
    (B, M); gt_masks (B, M, H/ms, W/ms) binary or None, at stride
    ``mask_stride``.  ``generator`` (CPU) seeds three streams: the trunk's
    drop path, the RPN sampler and the proposal jitter.  The cascade trains
    on jittered GT boxes (the static-shape stand-in for detectron2 adding
    the GTs to the sampled proposals); without a generator the boxes are not
    jittered and the trunk draws no drop path, as the JAX package does
    without an rng.  ``deterministic=True`` (a validation loss) also runs
    the trunk without drop path and the boxes without jitter, and draws the
    RPN subsample from a generator seeded with ``DETERMINISTIC_SAMPLER_SEED``,
    so the loss is computable and repeatable."""
    bsz, m = gt_boxes.shape[:2]
    device = images.device
    gt_boxes, gt_valid = gt_boxes.float(), gt_valid.bool()
    gen_trunk, gen_sampler, gen_jitter = split_generator(None if deterministic else generator, 3)
    if deterministic:
        gen_sampler = torch.Generator().manual_seed(DETERMINISTIC_SAMPLER_SEED)
    f16 = detector.backbone(images, deterministic=deterministic or gen_trunk is None,
                            generator=gen_trunk)
    pyr = detector.fpn(f16)
    feats = [pyr[k] for k in detector.PYRAMID_KEYS]

    if detector.proposer_kind == "rpn":
        loss_prop, metrics = rpn_loss(detector.proposer, feats, gt_boxes, gt_labels, gt_valid,
                                      sampler=rpn_sampler,
                                      generator=generator_on(gen_sampler, device))
    else:
        loss_prop, metrics = fcos_loss(detector.proposer, feats, gt_boxes, gt_labels, gt_valid)

    props = gt_boxes
    if gen_jitter is not None:
        wh = torch.cat([gt_boxes[..., 2:4] - gt_boxes[..., 0:2]] * 2, -1)
        noise = torch.rand(gt_boxes.shape, generator=generator_on(gen_jitter, device),
                           device=device)
        props = gt_boxes + (noise - 0.5) * proposal_jitter * wh

    # the cascade per image (assignment IoUs within each image); gt_valid
    # masks the proposals too, since they are jittered GT slots
    zeros = torch.zeros(m, dtype=torch.long, device=device)
    per_image = [cascade_box_loss(detector.box_head, [f[i:i + 1] for f in feats], props[i],
                                  zeros, gt_boxes[i], gt_labels[i], gt_valid[i],
                                  prop_valid=gt_valid[i]) for i in range(bsz)]
    loss = loss_prop + torch.stack([loss for loss, _ in per_image]).mean()
    for key in per_image[0][1]:
        metrics[key] = torch.stack([torch.as_tensor(mt[key]) for _, mt in per_image]).mean()

    if gt_masks is not None and detector.mask_head is not None:
        lm = mask_loss(detector.mask_head, feats, props.reshape(-1, 4),
                       torch.arange(bsz, device=device).repeat_interleave(m),
                       gt_masks.reshape((-1,) + tuple(gt_masks.shape[2:])),
                       gt_labels.reshape(-1), gt_valid.reshape(-1), mask_stride=mask_stride)
        metrics["mask_loss"] = lm
        loss = loss + lm
    metrics["loss"] = loss
    return loss, metrics
