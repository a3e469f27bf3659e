"""Mask2Former set-prediction losses (counterpart of
``one_peace_tpu/vision/mask2former_loss.py``).

The reference's mmdet Mask2FormerHead training config (ref seg/configs/
_base_/models/mask2former_onepeace.py:93-118), as the JAX package has it:

- per prediction level and image, a Hungarian assignment of the GT masks
  to the queries on ``num_points`` uniform points, with costs cls 2.0 (the
  negative softmax probability), sigmoid CE 5.0 and naive dice 5.0;
- classification: CE over every query, class weight 1.0 for the real
  classes and 0.1 for no-object, weight 2.0, over the summed weights of the
  targets;
- the mask losses on the matched queries only: sigmoid BCE (5.0, over
  num_total_masks * num_points) and naive dice (5.0, over num_total_masks)
  on points importance-sampled by the prediction's uncertainty
  (oversample 3.0, importance 0.75: PointRend's
  get_uncertain_point_coords_with_randomness);
- deep supervision: the same loss on each of the 1 + num_decoder_layers
  levels, summed.

Every level's cost matrices are built first and assigned together on the
host (``matching.hungarian_assign``: one fetch); then the losses of all
levels run batched.  The random points come from one call of ``_uniforms``
on an explicit generator.  The points and the assignment carry no gradient.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .matching import hungarian_assign

OVERSAMPLE, IMPORTANCE = 3.0, 0.75


def _uniforms(generator: torch.Generator, shapes: Sequence[Tuple[int, ...]],
              device) -> List[torch.Tensor]:
    """The loss's random numbers: one uniform [0, 1) tensor per shape, in
    order (the matching points, the oversampled candidates, the uniform
    fill)."""
    return [torch.rand(s, generator=generator, device=device) for s in shapes]


def point_sample(mask: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """mask (..., H, W); points (..., P, 2) in [0, 1] (x, y), their leading
    dims broadcasting against the mask's -> (..., P).  grid_sample's
    align_corners=False semantics (zero-padded bilinear), computed as the
    JAX package computes them: four gathers, whose backward is a
    ``scatter_add``."""
    h, w = mask.shape[-2:]
    x = points[..., 0] * w - 0.5
    y = points[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    flat = mask.reshape(mask.shape[:-2] + (h * w,))
    lead = torch.broadcast_shapes(flat.shape[:-1], x.shape[:-1])
    flat = flat.expand(lead + flat.shape[-1:])

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return flat.gather(-1, idx.expand(lead + idx.shape[-1:])) * inside.to(mask.dtype)

    top = tap(x0, y0) * (1 - tx) + tap(x0 + 1, y0) * tx
    bot = tap(x0, y0 + 1) * (1 - tx) + tap(x0 + 1, y0 + 1) * tx
    return top * (1 - ty) + bot * ty


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _dice(pred_sig: torch.Tensor, gt: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """naive dice over the last axis (mmdet DiceLoss naive_dice=True)."""
    num = 2.0 * (pred_sig * gt).sum(-1)
    den = pred_sig.sum(-1) + gt.sum(-1)
    return 1.0 - (num + eps) / (den + eps)


def _match_costs(cls_logits, mask_points, gt_labels, gt_points, cls_w=2.0, mask_w=5.0,
                 dice_w=5.0) -> torch.Tensor:
    """cls_logits (..., Q, C+1); mask_points (..., Q, P) logits; gt_labels
    (..., K); gt_points (..., K, P) in {0, 1} -> (..., K, Q) costs (rows =
    GTs)."""
    p = mask_points.shape[-1]
    prob = torch.softmax(cls_logits.float(), -1)
    labels = gt_labels.long()[..., None, :].expand(prob.shape[:-1] + gt_labels.shape[-1:])
    cls_cost = -prob.gather(-1, labels).transpose(-1, -2)
    logits = mask_points.float()
    pos, neg = -F.logsigmoid(logits), -F.logsigmoid(-logits)
    mask_cost = (gt_points @ pos.transpose(-1, -2)
                 + (1.0 - gt_points) @ neg.transpose(-1, -2)) / p
    sig = torch.sigmoid(logits)
    dice_cost = 1.0 - (2.0 * (gt_points @ sig.transpose(-1, -2)) + 1.0) / (
        gt_points.sum(-1)[..., :, None] + sig.sum(-1)[..., None, :] + 1.0)
    return cls_w * cls_cost + mask_w * mask_cost + dice_w * dice_cost


def uncertainty_points(cand: torch.Tensor, rand: torch.Tensor, mask_logits: torch.Tensor,
                       num_points: int) -> torch.Tensor:
    """Per-mask point coords (..., num_points, 2): of the uniform candidates
    ``cand`` (..., oversample * P, 2), the most uncertain (uncertainty
    -|logit|, most uncertain first, ties to the lower index as
    ``lax.top_k``), then the uniform fill ``rand`` (..., P - importance * P,
    2).  mask_logits (..., H, W)."""
    n_imp = num_points - rand.shape[-2]
    unc = -point_sample(mask_logits, cand).abs()
    idx = torch.sort(unc, dim=-1, descending=True, stable=True).indices[..., :n_imp]
    imp = cand.gather(-2, idx[..., None].expand(idx.shape + (2,)))
    return torch.cat([imp, rand], dim=-2)


def point_counts(num_points: int) -> Tuple[int, int, int]:
    """(candidates, important, uniform fill) for ``num_points`` loss points."""
    n_imp = int(num_points * IMPORTANCE)
    return int(num_points * OVERSAMPLE), n_imp, num_points - n_imp


def mask2former_loss(all_cls: torch.Tensor, all_masks: torch.Tensor, gt_masks: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     generator: torch.Generator, num_points: int = 12544,
                     cls_weight: float = 2.0, mask_weight: float = 5.0,
                     dice_weight: float = 5.0, no_object_weight: float = 0.1
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """all_cls (L, B, Q, C+1); all_masks (L, B, Q, H, W) logits at the mask
    features' stride; gt_masks (B, K, Hm, Wm) in {0, 1}; gt_labels (B, K);
    gt_valid (B, K) bool.  ``generator`` lives on the predictions' device."""
    lvls, b, q, c1 = all_cls.shape
    num_classes, k = c1 - 1, gt_masks.shape[1]
    device = all_cls.device
    gt_masks = gt_masks.float()
    n_cand, _, n_rand = point_counts(num_points)
    match_pts, cand, rand = _uniforms(
        generator, [(lvls, b, num_points, 2), (lvls, b, k, n_cand, 2), (lvls, b, k, n_rand, 2)],
        device)
    num_total_masks = gt_valid.sum().float().clamp_min(1.0)
    cw = torch.ones(c1, device=device)
    cw[num_classes] = no_object_weight
    levels = torch.arange(lvls, device=device)[:, None, None]
    images = torch.arange(b, device=device)[None, :, None]
    valid = gt_valid.expand(lvls, b, k)

    with torch.no_grad():  # the matching: on uniform points, no gradient (as the JAX side's)
        mp = point_sample(all_masks, match_pts[:, :, None])   # (L, B, Q, P)
        gp = point_sample(gt_masks, match_pts[:, :, None])    # (L, B, K, P)
        cost = _match_costs(all_cls, mp, gt_labels.expand(lvls, b, k), gp,
                            cls_weight, mask_weight, dice_weight)
        cost = torch.where(valid[..., None], cost, 0.0)
        del mp, gp
        col = hungarian_assign(cost, valid)                   # (L, B, K)

    # classification targets over every query
    labels = torch.full((lvls, b, q), num_classes, dtype=torch.long, device=device)
    labels.scatter_(-1, col, torch.where(valid, gt_labels.long().expand(lvls, b, k),
                                         labels.gather(-1, col)))
    ce = -torch.log_softmax(all_cls.float(), -1).gather(-1, labels[..., None])[..., 0]
    wts = cw[labels]
    cls_l = cls_weight * (ce * wts).sum((1, 2)) / wts.sum((1, 2)).clamp_min(1.0)

    # the mask losses on the matched queries, at importance-sampled points
    matched = all_masks[levels, images, col]                  # (L, B, K, H, W)
    with torch.no_grad():
        pts = uncertainty_points(cand, rand, matched, num_points)
    pm = point_sample(matched, pts).float()                   # (L, B, K, P)
    pg = point_sample(gt_masks, pts)
    vf = valid.float()
    bce = _bce_logits(pm, pg).mean(-1)
    mask_l = mask_weight * ((bce * vf).sum((1, 2)) * num_points) / (num_total_masks * num_points)
    dice = _dice(torch.sigmoid(pm), pg)
    dice_l = dice_weight * (dice * vf).sum((1, 2)) / num_total_masks
    loss = cls_l.sum() + mask_l.sum() + dice_l.sum()
    metrics = {
        "m2f_cls": cls_l[-1], "m2f_mask": mask_l[-1], "m2f_dice": dice_l[-1],
        "m2f_cls_aux": cls_l[:-1].sum(), "m2f_mask_aux": mask_l[:-1].sum(),
        "m2f_dice_aux": dice_l[:-1].sum(),
    }
    return loss, metrics
