"""Vision-transfer tasks (counterpart of ``one_peace_tpu/tasks/vision_tasks.py``):
COCO detection, drivable through ``cli/train.py task._name=coco_detection``
and ``cli/evaluate.py``.

``CocoDetectionTask`` builds the detector from the config's encoder dims and
task fields, reads COCO JSON through ``data/vision_datasets.py``, batches with
``vision_collate``, and scores box and mask AP with ``metrics.DetectionAP``.
Evaluation is eager on the model's device: ``detect()`` runs the trunk,
pyramid and heads on the card and decodes on the host; mask paste and AP run
on the host.  Nothing is compiled, so ``eval_compiles`` is 0.  The
segmentation and video tasks are not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..data.iterators import EpochBatchIterator
from ..data.vision_datasets import CocoDetectionDataset, vision_collate
from ..metrics.metrics import DetectionAP
from ..vision.mask_paste import paste_masks
from ..vision.zoo import OnePeaceDetector
from .base_task import refuse_shards


class VisionTaskBase:
    """The task contract (datasets, iterator, evaluation hooks) without the
    BPE and TSV machinery of ``BaseTask``."""

    criterion_name = ""

    def __init__(self, cfg, framework_cfg=None):
        self.cfg = cfg
        self.framework_cfg = framework_cfg
        self.datasets: Dict[str, object] = {}

    def build_dataset(self, split: str):
        raise NotImplementedError

    def load_dataset(self, split: str):
        self.datasets[split] = self.build_dataset(split)
        return self.datasets[split]

    def get_batch_iterator(self, split: str, batch_size: int, seed: int = 3407,
                           shard_id: int = 0, num_shards: int = 1,
                           ensure_equal_batch: bool = True,
                           skip_remainder_batch: bool = False) -> EpochBatchIterator:
        refuse_shards(num_shards)
        return EpochBatchIterator(
            self.datasets[split],
            collate_fn=vision_collate,
            batch_size=batch_size,
            seed=seed,
            shard_id=shard_id,
            num_shards=num_shards,
            shuffle=(split == "train"),
            ensure_equal_batch=ensure_equal_batch,
            skip_remainder_batch=skip_remainder_batch,
        )

    @property
    def eval_compiles(self) -> int:
        return 0

    def begin_valid_epoch(self, model, params):
        self.metric.initialize()

    def merge_results(self) -> Dict:
        return self.metric.merge_results()


class _DetectCall(nn.Module):
    """``model.detect`` as a module's forward, so that one
    ``functional_call`` runs it on given parameters (the trainer's
    compute-dtype copies) without a second copy of the model."""

    def __init__(self, model: OnePeaceDetector):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor, max_proposals: int):
        return self.model.detect(images, max_proposals=max_proposals)


class CocoDetectionTask(VisionTaskBase):
    """Cascade mask R-CNN fine-tuning on COCO (the detectron2 recipe)."""

    criterion_name = "detection_criterion"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = DetectionAP(num_classes=cfg.num_classes)

    def build_dataset(self, split: str):
        c = self.cfg
        ann = c.data if split == "train" else c.valid_data
        img_dir = c.image_dir if split == "train" else (c.valid_image_dir or c.image_dir)
        return CocoDetectionDataset(
            split, ann, img_dir, image_size=c.image_size, max_boxes=c.max_boxes,
            with_masks=c.with_masks, mask_stride=c.mask_stride,
            lsj_min_scale=c.lsj_min_scale, lsj_max_scale=c.lsj_max_scale)

    @staticmethod
    def build_model(cfg, device="cuda", dtype=None) -> OnePeaceDetector:
        """The detector of ``cfg.task`` over the trunk of ``cfg.model.encoder``
        (width, depth, heads, drop path, remat, attention path), built on
        ``device``."""
        enc, t = cfg.model.encoder, cfg.task
        return OnePeaceDetector(
            num_classes=t.num_classes, image_size=t.image_size, with_masks=t.with_masks,
            proposer=t.proposer, device=device, dtype=dtype, embed_dim=enc.embed_dim,
            ffn_embed_dim=enc.ffn_embed_dim, heads=enc.attention_heads, layers=enc.layers,
            window_size=t.window_size, global_period=t.global_period,
            drop_path_rate=enc.drop_path_rate, checkpoint_activations=enc.checkpoint_activations,
            attn_impl=enc.attn_impl)

    def detect(self, model: OnePeaceDetector, params, images) -> list:
        """``model.detect`` on ``params`` (a name -> tensor dict, such as the
        trainer's compute-dtype copies) or, with None, on the model's own
        weights; eager, in eval mode under ``torch.inference_mode()``.  The
        images go to the model's device in its weights' dtype."""
        weights = params if params is not None else dict(model.named_parameters())
        pos = weights["backbone.image_adapter.pos_embed"]
        images = torch.as_tensor(np.asarray(images)).to(pos.device, pos.dtype)
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                if params is None:
                    return model.detect(images, max_proposals=self.cfg.max_proposals)
                return torch.func.functional_call(
                    _DetectCall(model), {f"model.{k}": v for k, v in params.items()},
                    (images, self.cfg.max_proposals))
        finally:
            model.train(was_training)

    def valid_step(self, model, params, batch):
        """Box AND instance-mask (segm) scoring under the COCO protocol:
        mask probabilities paste into image coordinates (detectron2
        paste_masks_in_image semantics, at the GT raster stride), crowd
        regions flow through as ignore, and areas rescale to original
        px^2 via the per-image resize factor (ref det COCOEvaluator
        pair, lazyconfig_train_net.py:36-40)."""
        results = self.detect(model, params, batch["src_images"])
        gt_boxes = np.asarray(batch["gt_boxes"])
        gt_labels = np.asarray(batch["gt_labels"])
        gt_valid = np.asarray(batch["gt_valid"])
        gt_crowd = np.asarray(batch.get("gt_crowd", np.zeros(gt_valid.shape, bool)))
        gt_areas = batch.get("gt_areas")
        scales = np.asarray(batch.get("im_scale", np.ones(len(results), np.float32)),
                            np.float32)
        gt_masks = (np.asarray(batch["gt_masks"])
                    if "gt_masks" in batch and self.cfg.with_masks else None)
        size, stride = self.cfg.image_size, self.cfg.mask_stride
        for b, det in enumerate(results):
            v = gt_valid[b]
            f = float(scales[b])
            kw = {
                "gt_crowd": gt_crowd[b][v],
                "area_scale": 1.0 / (f * f),
            }
            if gt_areas is not None:
                kw["gt_areas"] = np.asarray(gt_areas[b])[v]
            if gt_masks is not None:
                # an image with zero detections still records an (0, G)
                # segm entry -- its unrecalled GTs must count
                dm = det.get("masks", np.zeros((0, 1, 1), np.float32))
                kw["det_masks"] = paste_masks(
                    dm, det["boxes"][:len(dm)], size // stride, size // stride, stride=stride)
                kw["gt_masks"] = gt_masks[b][v]
                kw["mask_area_scale"] = (stride * stride) / (f * f)
            self.metric.compute(det["boxes"], det["scores"], det["labels"],
                                gt_boxes[b][v], gt_labels[b][v], **kw)
