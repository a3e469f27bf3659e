"""The detection, segmentation and video criterions (counterpart of
``one_peace_tpu/criterions/vision_criterions.py``), with the criterion
contract of ``criterions.py``: ``DetectionCriterion``, the cascade mask
R-CNN objective of ``vision/det_train.py`` over static padded GT,
``SegmentationCriterion``, UperNet's pixel CE or Mask2Former's set losses,
and ``VideoClassifyCriterion``, the clip-level CE with label smoothing."""

from __future__ import annotations

import torch

from ..core.config import CriterionConfig
from ..models.components import generator_on, resize_linear
from ..vision.det_train import detector_training_loss
from ..vision.mask2former_loss import mask2former_loss
from ..vision.upernet import seg_cross_entropy


class DetectionCriterion:
    """RPN or FCOS + cascade + mask losses.  The GT masks' raster stride is
    read from the shapes.  ``deterministic=True`` (validation) runs without
    drop path or proposal jitter and draws the RPN subsample from a fixed
    seed, so the loss is computable and repeatable; the JAX package raises
    there under ``rpn_sampler="subsample"`` (no rng)."""

    def __init__(self, cfg: CriterionConfig):
        self.rpn_sampler = getattr(cfg, "rpn_sampler", "subsample")

    def __call__(self, model, batch, generator=None, deterministic=False):
        gt_masks, mask_stride = batch.get("gt_masks"), 1
        if gt_masks is not None:
            if model.mask_head is None:
                gt_masks = None
            else:
                mask_stride = batch["src_images"].shape[-1] // gt_masks.shape[-1]
        return detector_training_loss(
            model, batch["src_images"], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_valid"], gt_masks=gt_masks, generator=generator, mask_stride=mask_stride,
            rpn_sampler=self.rpn_sampler, deterministic=deterministic)


class SegmentationCriterion:
    """UperNet: the ignore_index-masked pixel CE, by default over the logits
    resized to the labels (``seg_loss_at="full"``, mmseg-exact; ``"stride"``
    subsamples the labels to the stride-4 logits instead), with label
    smoothing, the pixel accuracy and the counted share.  Mask2Former
    (``model.is_mask2former``): the set losses of ``vision/mask2former_loss``
    over GT masks made from the stride-subsampled label map: one binary mask
    per class present, the top ``min(max_instances, num_queries, C)`` classes
    by pixel count (ties to the lower class id, as ``lax.top_k``).  Its random
    points come from ``generator`` (moved to the images' device), or from a
    fixed seed without one, as the JAX package uses ``PRNGKey(0)``."""

    def __init__(self, cfg: CriterionConfig, ignore_index: int = 255):
        self.label_smoothing = cfg.label_smoothing
        self.ignore_index = ignore_index
        self.loss_at = getattr(cfg, "seg_loss_at", "full")

    def _mask2former(self, model, batch, generator):
        all_cls, all_masks = model.forward_sets(batch["src_images"])
        target = batch["target"].long()
        c = all_cls.shape[-1] - 1
        mh, mw = all_masks.shape[-2:]
        stride = target.shape[-1] // mw
        off = stride // 2
        tgt = target[:, off::stride, off::stride][:, :mh, :mw]
        kmax = min(getattr(model, "max_instances", 32), getattr(model, "num_queries", 100), c)
        valid = (tgt != self.ignore_index) & (tgt < c)
        safe = torch.where(valid, tgt, c).flatten(1)
        counts = torch.zeros(safe.shape[0], c + 1, dtype=torch.long, device=safe.device)
        counts = counts.scatter_add_(1, safe, torch.ones_like(safe))[:, :c]
        vals, ids = torch.sort(counts, dim=1, descending=True, stable=True)
        vals, ids = vals[:, :kmax], ids[:, :kmax]
        gt_masks = (tgt[:, None] == ids[:, :, None, None]).float()
        device = all_cls.device
        gen = (generator_on(generator, device) if generator is not None
               else torch.Generator(device=device).manual_seed(0))
        loss, metrics = mask2former_loss(all_cls, all_masks, gt_masks, ids, vals > 0, gen,
                                         num_points=getattr(model, "num_points", 2048))
        metrics["loss"] = loss
        return loss, metrics

    def __call__(self, model, batch, generator=None, deterministic=False):
        if getattr(model, "is_mask2former", False):
            return self._mask2former(model, batch, generator)
        logits = model.logits(batch["src_images"])  # (B, h, w, C)
        target = batch["target"].long()  # (B, H, W)
        if self.loss_at == "full":
            logits = resize_linear(logits.float(), target.shape[1:3], (1, 2))
            tgt = target
        else:
            stride = target.shape[-1] // logits.shape[-2]
            off = stride // 2
            tgt = target[:, off::stride, off::stride][:, :logits.shape[1], :logits.shape[2]]
        c = logits.shape[-1]
        loss = seg_cross_entropy(logits, tgt, self.ignore_index, self.label_smoothing)
        vf = (tgt != self.ignore_index).float()
        acc = ((logits.argmax(-1) == tgt) * vf).sum() / vf.sum().clamp_min(1.0)
        return loss, {"loss": loss, "pixel_acc": 100.0 * acc, "valid_frac": vf.mean(),
                      "num_classes": torch.tensor(float(c))}


class VideoClassifyCriterion:
    """Clip-level CE with label smoothing (the mmaction2 recognizer's loss),
    in fp32 over the clip logits, and the top-1 accuracy of the batch."""

    def __init__(self, cfg: CriterionConfig):
        self.label_smoothing = cfg.label_smoothing

    def __call__(self, model, batch, generator=None, deterministic=False):
        logits = model(batch["src_videos"], deterministic=deterministic, generator=generator)
        target = batch["target"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, target[:, None])[:, 0]
        if self.label_smoothing > 0:
            nll = (1 - self.label_smoothing) * nll + self.label_smoothing * -logp.mean(-1)
        loss = nll.mean()
        acc = (logits.argmax(-1) == target).float().mean()
        return loss, {"loss": loss, "accuracy": 100.0 * acc}
