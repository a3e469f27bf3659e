"""Vision-transfer tasks (counterpart of ``one_peace_tpu/tasks/vision_tasks.py``):
COCO detection, ADE20K segmentation and K400 video classification, drivable
through ``cli/train.py`` (``task._name=coco_detection`` / ``ade20k_seg`` /
``k400_video``) and ``cli/evaluate.py``.

``CocoDetectionTask`` builds the detector from the config's encoder dims and
task fields, reads COCO JSON through ``data/vision_datasets.py``, batches with
``vision_collate``, and scores box and mask AP with ``metrics.DetectionAP``.
Evaluation is eager on the model's device: ``detect()`` runs the trunk,
pyramid and heads on the card and decodes on the host; mask paste and AP run
on the host.  Nothing is compiled, so ``eval_compiles`` is 0.

``Ade20kSegTask`` builds either segmenter (``task.seg_head``) with the
image adapter's grids set to the crop's, reads mmseg-style ADE20K trees, and
scores mIoU by ``task.seg_eval_protocol``: ``whole`` (one crop; the scores
resized to the labels, or the argmax repeated, by
``seg_eval_logits_upsample``), ``slide`` or ``ms_flip``.  Each batch's
confusion matrix is summed on the card and fetched once, in
``merge_results``.  Validation runs the trainer's compute-dtype copies of
the masters through ``functional_call``, as detection's does.

``K400VideoTask`` builds the AIM video classifier (the trunk frozen, the
adapters, temporal embedding, rel-pos table, norm and head trainable), reads
mmaction2 rawframes, and scores top-1 accuracy.  Under multi-view testing a
(B, V, T, 3, S, S) batch runs ``VIEWS_PER_FORWARD`` views a forward (the JAX
task runs all B * V in one; each view is independent, so the result is the
same), the views' softmax probabilities are averaged per clip, and each
batch's count of hits stays on the card until ``merge_results``.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..data.iterators import EpochBatchIterator
from ..data.vision_datasets import (Ade20kSegDataset, CocoDetectionDataset,
                                    RawframeVideoDataset, vision_collate)
from ..metrics.metrics import Accuracy, DetectionAP, MIoU, fetch_once
from ..models.components import resize_linear
from ..vision.mask_paste import paste_masks
from ..vision.zoo import (OnePeaceDetector, OnePeaceMask2FormerSegmenter, OnePeaceSegmenter,
                         OnePeaceVideoClassifier)
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


class _MethodCall(nn.Module):
    """A method of ``model`` as a module's forward, so that one
    ``functional_call`` runs it on given parameters (the trainer's
    compute-dtype copies) without a second copy of the model."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, method: str, *args, **kwargs):
        return getattr(self.model, method)(*args, **kwargs)


def call_on(model: nn.Module, params, method: str, *args, **kwargs):
    """``model.<method>(*args, **kwargs)`` on ``params`` (a name -> tensor
    dict such as the trainer's compute-dtype copies) or, with None, on the
    model's own weights."""
    if params is None:
        return getattr(model, method)(*args, **kwargs)
    return torch.func.functional_call(_MethodCall(model),
                                      {f"model.{k}": v for k, v in params.items()},
                                      (method, *args), kwargs)


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
                return call_on(model, params, "detect", images,
                               max_proposals=self.cfg.max_proposals)
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


class Ade20kSegTask(VisionTaskBase):
    """ViT-Adapter semantic segmentation with the Mask2Former head
    (``task.seg_head=mask2former``, the reference's headline recipe) or
    UperNet, evaluated by mIoU."""

    criterion_name = "segmentation_criterion"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        if cfg.num_classes == 1000:  # the classify default is meaningless here
            cfg.num_classes = 150
        self.metric = MIoU(num_classes=cfg.num_classes, ignore_index=cfg.ignore_index)
        self._cm = None

    def build_dataset(self, split: str):
        c = self.cfg
        spec = c.data if split == "train" else c.valid_data
        img_dir, _, ann_dir = spec.partition(":")
        return Ade20kSegDataset(
            split, img_dir, ann_dir, crop_size=c.image_size, num_classes=c.num_classes,
            ignore_index=c.ignore_index, reduce_zero_label=c.reduce_zero_label)

    @staticmethod
    def build_model(cfg, device="cuda", dtype=None) -> OnePeaceSegmenter:
        """The segmenter of ``cfg.task.seg_head`` over the encoder of
        ``cfg.model.encoder``, its image grids (absolute and relative) set to
        the crop's, built on ``device``; Mask2Former's set loss reads its
        ``max_instances`` and ``num_points`` from ``task.seg_max_instances``
        and ``task.seg_num_points``."""
        enc, t = copy.deepcopy(cfg.model.encoder), cfg.task
        grid = t.image_size // 16
        enc.image_adapter.bucket_size = grid
        enc.image_adapter.rel_bucket_size = grid
        if t.seg_head == "mask2former":
            model = OnePeaceMask2FormerSegmenter(
                enc, num_classes=t.num_classes, feat_channels=t.seg_feat_channels,
                num_queries=t.num_queries, dec_layers=t.seg_dec_layers,
                pixel_layers=t.seg_pixel_layers, device=device, dtype=dtype)
            model.max_instances = t.seg_max_instances
            model.num_points = t.seg_num_points
            return model
        if t.seg_head != "upernet":
            raise ValueError(f"task.seg_head {t.seg_head!r}: upernet or mask2former")
        return OnePeaceSegmenter(enc, num_classes=t.num_classes, device=device, dtype=dtype)

    def begin_valid_epoch(self, model, params):
        self.metric.initialize()
        self._cm = None

    def _confusion(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        """Add the (C, C) confusion matrix of ``pred`` against ``target`` (rows
        target, columns prediction; (B, H, W) each) to the sum kept on the
        card."""
        c, ign = self.metric.num_classes, self.metric.ignore_index
        valid = target != ign
        idx = torch.where(valid, target.clamp_min(0) * c + pred.clamp(0, c - 1), c * c)
        cm = torch.bincount(idx.reshape(-1), minlength=c * c + 1)[:c * c].reshape(c, c)
        self._cm = cm if self._cm is None else self._cm + cm

    @torch.inference_mode()
    def valid_step(self, model: OnePeaceSegmenter, params, batch):
        """One batch's confusion matrix by ``task.seg_eval_protocol``: ``whole``
        (one crop), ``slide`` (mmseg test_cfg mode='slide', stride
        ``seg_eval_stride``) or ``ms_flip`` (the reference's --aug-test over
        ``seg_ms_ratios``), in eval mode, on ``params`` (a name -> tensor dict
        such as the trainer's compute-dtype copies) or, with None, on the
        model's own weights."""
        was_training = model.training
        model.eval()
        try:
            device = next(model.parameters()).device
            images = torch.as_tensor(np.asarray(batch["src_images"], np.float32)).to(device)
            target = torch.as_tensor(np.asarray(batch["target"])).to(device).long()
            proto = self.cfg.seg_eval_protocol
            crop, stride = self.cfg.image_size, self.cfg.seg_eval_stride
            if proto == "slide":
                pred = call_on(model, params, "slide_scores", images, crop, stride).argmax(-1)
            elif proto == "ms_flip":
                pred = call_on(model, params, "ms_flip_logits", images, crop, stride,
                               ratios=tuple(self.cfg.seg_ms_ratios), flip=True).argmax(-1)
            elif proto == "whole":
                scores = call_on(model, params, "logits", images).float()
                if self.cfg.seg_eval_logits_upsample:
                    # mmseg-exact: the class scores resized to the labels, then argmax
                    pred = resize_linear(scores, target.shape[1:3], (1, 2)).argmax(-1)
                else:
                    s = target.shape[-1] // scores.shape[2]
                    pred = scores.argmax(-1).repeat_interleave(s, 1).repeat_interleave(s, 2)
                    pred = pred[:, :target.shape[1], :target.shape[2]]
            else:
                raise ValueError(f"task.seg_eval_protocol {proto!r}: whole, slide or ms_flip")
            self._confusion(pred, target)
        finally:
            model.train(was_training)

    def merge_results(self) -> Dict:
        if self._cm is not None:
            self.metric.update_confusion(fetch_once(self._cm))
            self._cm = None
        return self.metric.merge_results()


class K400VideoTask(VisionTaskBase):
    """Frozen-trunk AIM video classification (the reference's mmaction2
    recognizer recipes), evaluated by top-1 accuracy."""

    criterion_name = "video_classify_criterion"
    # views a forward under multi-view testing: 8 views of 32 frames are the
    # tokens of a training batch of 8 clips
    VIEWS_PER_FORWARD = 8

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        if cfg.num_classes == 1000:  # the classify default is meaningless here
            cfg.num_classes = 400
        self.metric = Accuracy()

    def build_dataset(self, split: str):
        c = self.cfg
        ann = c.data if split == "train" else c.valid_data
        root = c.image_dir if split == "train" else (c.valid_image_dir or c.image_dir)
        return RawframeVideoDataset(
            split, ann, root, num_frames=c.num_frames, image_size=c.image_size,
            frame_tmpl=c.frame_tmpl, test_num_clips=c.video_test_clips,
            test_three_crop=c.video_test_three_crop, sampling=c.video_sampling,
            frame_interval=c.video_frame_interval, train_aug=c.video_train_aug,
            color_jitter=c.video_color_jitter)

    @staticmethod
    def build_model(cfg, device="cuda", dtype=None) -> OnePeaceVideoClassifier:
        """The video classifier of ``cfg.task`` (classes, frames, the bucket
        grid of ``image_size``) over the trunk of ``cfg.model.encoder``
        (width, depth, heads, drop path, remat, attention path), built on
        ``device``."""
        enc, t = cfg.model.encoder, cfg.task
        return OnePeaceVideoClassifier(
            num_classes=t.num_classes, device=device, dtype=dtype, embed_dim=enc.embed_dim,
            ffn_embed_dim=enc.ffn_embed_dim, heads=enc.attention_heads, layers=enc.layers,
            bucket_size=t.image_size // 16, num_frames=t.num_frames,
            drop_path_rate=enc.drop_path_rate, checkpoint_activations=enc.checkpoint_activations,
            attn_impl=enc.attn_impl)

    @torch.inference_mode()
    def valid_step(self, model: OnePeaceVideoClassifier, params, batch):
        """One batch's top-1 hits, in eval mode, on ``params`` (a name ->
        tensor dict such as the trainer's compute-dtype copies) or, with
        None, on the model's own weights.  A (B, V, T, 3, S, S) batch of test
        views goes to the card ``VIEWS_PER_FORWARD`` views at a time; the
        views' softmax probabilities (fp32) are averaged per clip
        (mmaction2's ``average_clips='prob'``)."""
        was_training = model.training
        model.eval()
        try:
            device = next(model.parameters()).device
            videos = np.asarray(batch["src_videos"], np.float32)
            target = torch.as_tensor(np.asarray(batch["target"])).to(device).long()
            if videos.ndim == 6:
                b, v = videos.shape[:2]
                flat = videos.reshape((b * v,) + videos.shape[2:])
                probs = torch.cat([
                    torch.softmax(call_on(model, params, "forward", torch.from_numpy(
                        flat[i:i + self.VIEWS_PER_FORWARD]).to(device)).float(), dim=-1)
                    for i in range(0, b * v, self.VIEWS_PER_FORWARD)])
                pred = probs.reshape(b, v, -1).mean(1).argmax(-1)
            else:
                pred = call_on(model, params, "forward",
                               torch.from_numpy(videos).to(device)).argmax(-1)
            self.metric.compute(ncorrect=(pred == target).sum(), count=int(pred.shape[0]))
        finally:
            model.train(was_training)
