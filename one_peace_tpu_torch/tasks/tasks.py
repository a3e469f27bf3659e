"""Registered tasks: the retrieval part of ``one_peace_tpu/tasks/tasks.py``.

The retrieval tasks embed all validation texts in ``begin_valid_epoch``
(chunks of 50, with the optional "This is a sound of ..." template of
zero-shot ESC-50, ref tasks/audio_tasks/audio_text_retrieval.py:86), then
the image or audio side per batch into a ``Recall`` reducer, which fetches
everything to the host once in ``merge_results``.

``coco_detection`` is registered (``vision_tasks.CocoDetectionTask``: COCO
JSON, LSJ, box and mask AP).  Every other task of the JAX package raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from ..core.registry import TASKS
from ..data import datasets as D
from ..metrics import Recall
from .base_task import BaseTask
from .vision_tasks import CocoDetectionTask

UNPORTED = {
    "image_text_pretrain": "ROADMAP queue 1 item 6 (pretrain)",
    "audio_text_pretrain": "ROADMAP queue 1 item 6 (pretrain)",
    "vqa": "ROADMAP queue 1 item 4 (classify)",
    "nlvr2": "ROADMAP queue 1 item 4 (classify)",
    "image_classify": "ROADMAP queue 1 item 4 (classify)",
    "vggsound": "ROADMAP queue 1 item 4 (classify)",
    "fsd50k": "ROADMAP queue 1 item 4 (classify)",
    "aqa": "ROADMAP queue 1 item 4 (classify)",
    "refcoco": "ROADMAP queue 1 item 4 (classify)",
    "ade20k_seg": "ROADMAP queue 1 item 8 (segmentation and video)",
    "k400_video": "ROADMAP queue 1 item 8 (segmentation and video)",
}


def _chunk(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


class RetrievalTaskMixin:
    """Shared valid-epoch recall flow (ref image_text_retrieval.py:32-110)."""

    side = "image"  # or "audio"

    def _load_valid_texts(self):
        self.text_ids, self.texts = [], []
        with open(self.cfg.valid_file) as fh:
            for text_id, text_list in json.load(fh).items():
                for text in text_list:
                    self.text_ids.append(int(text_id))
                    self.texts.append(text)

    def begin_valid_epoch(self, model, params):
        if not getattr(self, "texts", None):
            self._load_valid_texts()
        logits_list = []
        for batch_texts in _chunk(self.texts, 50):
            if self.cfg.use_template:
                batch_texts = ["This is a sound of " + t for t in batch_texts]
            tokens = self.tokenizer.encode_batch(list(batch_texts))
            logits_list.append(self.eval_model(model, params, {"src_tokens": tokens},
                                               encoder_type="text"))
        self.metric.initialize(np.asarray(self.text_ids), logits_list)

    def valid_step(self, model, params, batch):
        if self.side == "image":
            out = self.eval_model(model, params, {"src_images": batch["src_images"]},
                                  encoder_type="image")
        else:
            out = self.eval_model(
                model, params,
                {"src_audios": batch["src_audios"],
                 "audio_padding_masks": batch["audio_padding_masks"]},
                encoder_type="audio")
        # the embeddings stay on the card; Recall fetches them all at merge
        self.metric.compute(np.asarray(batch["id"]), out)

    def merge_results(self, output_predict: bool = False) -> Dict:
        stats = self.metric.merge_results(output_predict=output_predict)
        if self.side == "audio":
            # rename the Recall reducer's image-side keys for audio tasks
            # (ref audio_text_retrieval.py:118-125)
            for key in list(stats):
                if key.startswith("img"):
                    stats["audio" + key[len("img"):]] = stats.pop(key)
                elif key.startswith("predict_img"):
                    stats["predict_audio" + key[len("predict_img"):]] = stats.pop(key)
        return stats


@TASKS.register("image_text_retrieval")
class ImageTextRetrievalTask(RetrievalTaskMixin, BaseTask):
    dataset_cls = D.ImageTextRetrievalDataset
    criterion_name = "image_text_retrieval_criterion"
    side = "image"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = Recall()


@TASKS.register("audio_text_retrieval")
class AudioTextRetrievalTask(RetrievalTaskMixin, BaseTask):
    dataset_cls = D.AudioTextRetrievalDataset
    criterion_name = "audio_text_retrieval_criterion"
    side = "audio"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = Recall()

    def dataset_kwargs(self):
        return {"max_src_length": self.cfg.max_src_length,
                "max_duration": self.cfg.max_duration,
                "feature_encoder_spec": self.audio_conv_spec()}


TASKS.register("coco_detection")(CocoDetectionTask)


def build_task(cfg, framework_cfg=None):
    if cfg._name in UNPORTED and cfg._name not in TASKS:
        raise NotImplementedError(f"task {cfg._name!r} is not ported to PyTorch yet: "
                                  f"{UNPORTED[cfg._name]}")
    return TASKS.get(cfg._name)(cfg, framework_cfg)
