"""The detection criterion (counterpart of
``one_peace_tpu/criterions/vision_criterions.py`` ``DetectionCriterion``):
the cascade mask R-CNN objective of ``vision/det_train.py`` over static
padded GT, with the criterion contract of ``criterions.py``.  The
segmentation criterion (segmentation training; segmentation serving and
evaluation are ported) and the video criterion are not ported yet (ROADMAP
queue 1 item 8)."""

from __future__ import annotations

from ..core.config import CriterionConfig
from ..vision.det_train import detector_training_loss


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
