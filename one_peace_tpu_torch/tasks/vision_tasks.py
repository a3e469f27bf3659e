"""Vision-transfer tasks (counterpart of ``one_peace_tpu/tasks/vision_tasks.py``).

``CocoDetectionTask`` turns a framework config (the detection recipe through
``core.config.load_config``) into the detector and names its criterion.  Its
COCO dataset and its evaluation are not ported yet: they raise.  The
segmentation and video tasks are not ported yet."""

from __future__ import annotations

from ..vision.zoo import OnePeaceDetector


class CocoDetectionTask:
    """Cascade mask R-CNN fine-tuning on COCO (the detectron2 recipe)."""

    criterion_name = "detection_criterion"

    def __init__(self, cfg, framework_cfg=None):
        self.cfg = cfg
        self.framework_cfg = framework_cfg

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

    def load_dataset(self, split: str):
        raise NotImplementedError("the COCO detection dataset is not ported yet")

    def valid_step(self, model, batch):
        raise NotImplementedError("COCO detection evaluation is not ported yet")
