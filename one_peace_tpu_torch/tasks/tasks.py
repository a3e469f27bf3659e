"""Registered tasks: the retrieval and classification parts of
``one_peace_tpu/tasks/tasks.py``.

The retrieval tasks embed all validation texts in ``begin_valid_epoch``
(chunks of 50, with the optional "This is a sound of ..." template of
zero-shot ESC-50, ref tasks/audio_tasks/audio_text_retrieval.py:86), then
the image or audio side per batch into a ``Recall`` reducer, which fetches
everything to the host once in ``merge_results``.

The classification tasks run the classify model on each validation batch
into a reducer that keeps its results on the card until ``merge_results``:
``image_classify``, ``vggsound``, ``nlvr2`` and ``aqa`` count top-1 hits
(``Accuracy``), ``vqa`` the soft score of the argmax answer, ``fsd50k``
the mean average precision over its classes (``MAP``) and ``refcoco`` the
share of predicted boxes at IoU >= 0.5 with the target once rescaled to
the original image (``IouAcc``).  ``image_classify`` mixes its training
batches (Mixup / CutMix, soft targets) in the iterator's collate when
``task.mixup`` or ``task.cutmix`` is set; its ``Mixup`` starts from seed 0
at every ``get_batch_iterator``, as the JAX task's does, and the iterator
saves its generator with the others.

Each task names the head it trains (``head_kwargs``), which both CLIs
build: ``task.num_classes`` outputs for most, NLVR2's two-image head with
2 classes, RefCOCO's 4 box coordinates, AQA's one score per answer choice;
the rest of the head keeps the JAX CLI's defaults (CLS pooling, no
pooler, ``head_scale_ratio`` 1).  The JAX CLI builds every classify head
from ``task.num_classes`` alone, which reaches none of the three.

The pretrain tasks (``image_text_pretrain``, ``audio_text_pretrain``) train
on the masked pretrain datasets and validate as the retrieval tasks do, on
the retrieval datasets (no masks) with ``Recall``; the pretrain model's
teacher pass returns (logits, features), of which the flow takes the
logits.

``coco_detection`` is registered (``vision_tasks.CocoDetectionTask``: COCO
JSON, LSJ, box and mask AP), ``ade20k_seg`` (``vision_tasks.Ade20kSegTask``:
mIoU by the whole, slide and ms_flip protocols) and ``k400_video``
(``vision_tasks.K400VideoTask``: rawframes, top-1 accuracy over multi-view
tests).  Every task of the JAX package is ported.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from ..core.config import TaskConfig
from ..core.registry import TASKS
from ..data import datasets as D
from ..data.mixup import Mixup
from ..metrics import MAP, Accuracy, IouAcc, Recall
from ..metrics.metrics import fetch_once
from ..models.classify import NET_INPUT_KEYS, choice_net_input
from .base_task import BaseTask
from .vision_tasks import Ade20kSegTask, CocoDetectionTask, K400VideoTask

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
            out = self.eval_model(model, params, {"src_tokens": tokens}, encoder_type="text")
            logits_list.append(out[0] if isinstance(out, tuple) else out)
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
        if isinstance(out, tuple):  # the pretrain model's (logits, features)
            out = out[0]
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


@TASKS.register("image_text_pretrain")
class ImageTextPretrainTask(RetrievalTaskMixin, BaseTask):
    """Stage-1 pretraining; validation is image-text retrieval's Recall
    (ref tasks/pretrain_tasks/image_text_pretrain.py:52-136)."""

    dataset_cls = D.ImageTextPretrainDataset
    criterion_name = "image_text_pretrain_loss"
    side = "image"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = Recall()

    def dataset_for(self, split: str):
        c = self.cfg
        if split != "train":
            return D.ImageTextRetrievalDataset, {"max_src_length": c.max_src_length,
                                                 "patch_image_size": c.patch_image_size}
        return self.dataset_cls, {
            "max_src_length": c.max_src_length, "patch_image_size": c.patch_image_size,
            "text_mask_ratio": c.text_mask_ratio, "image_mask_ratio": c.image_mask_ratio,
            "vl_text_mask_ratio": c.vl_text_mask_ratio,
            "vl_image_mask_ratio": c.vl_image_mask_ratio, "min_scale": c.min_scale}


@TASKS.register("audio_text_pretrain")
class AudioTextPretrainTask(RetrievalTaskMixin, BaseTask):
    """Stage-2 pretraining; validation is audio-text retrieval's Recall."""

    dataset_cls = D.AudioTextPretrainDataset
    criterion_name = "audio_text_pretrain_loss"
    side = "audio"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = Recall()

    def dataset_for(self, split: str):
        c = self.cfg
        kwargs = {"max_src_length": c.max_src_length, "max_duration": c.max_duration,
                  "feature_encoder_spec": self.audio_conv_spec()}
        if split != "train":
            return D.AudioTextRetrievalDataset, kwargs
        return self.dataset_cls, {**kwargs, "audio_mask_ratio": c.audio_mask_ratio,
                                  "al_text_mask_ratio": c.al_text_mask_ratio,
                                  "al_audio_mask_ratio": c.al_audio_mask_ratio}


def refuse_default_classes(name: str, cfg, classes: int) -> None:
    """Raise when ``task.num_classes`` is left at ``TaskConfig``'s default,
    naming the task's own class count: a head of the default width meets
    targets of another (VQA's soft targets) or trains over classes that
    never occur (VGGSound's, FSD50K's)."""
    if cfg.num_classes == TaskConfig.num_classes:
        raise ValueError(f"{name}: task.num_classes is left at TaskConfig's default of "
                         f"{cfg.num_classes}; {name.upper()} has {classes} classes: pass "
                         f"task.num_classes={classes}")


class ClassifyTaskBase(BaseTask):
    """Accuracy-scored classification family."""

    criterion_name = "classify_criterion"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = Accuracy()

    def begin_valid_epoch(self, model, params):
        self.metric.initialize()

    def _net_input(self, batch):
        return {k: batch[k] for k in NET_INPUT_KEYS if k in batch}

    def valid_step(self, model, params, batch):
        logits = self.eval_model(model, params, self._net_input(batch))
        self.metric.compute(logits, np.asarray(batch["target"]))

    def merge_results(self) -> Dict:
        return self.metric.merge_results()


@TASKS.register("vqa")
class VqaTask(ClassifyTaskBase):
    """VQA scored by the soft score of the argmax answer (ref
    tasks/vl_tasks/vqa.py).  Its soft targets have 3129 classes; the recipe
    leaves ``task.num_classes`` at ``TaskConfig``'s default, which is
    refused."""

    dataset_cls = D.VqaDataset

    def __init__(self, cfg, framework_cfg=None):
        refuse_default_classes("vqa", cfg, 3129)
        super().__init__(cfg, framework_cfg)

    def valid_step(self, model, params, batch):
        logits = self.eval_model(model, params, self._net_input(batch))
        preds = logits.argmax(-1)
        targets = torch.as_tensor(np.asarray(batch["target"]), device=logits.device)
        score = targets.gather(1, preds[:, None]).sum()
        self.metric.compute(ncorrect=score, count=int(preds.shape[0]))


@TASKS.register("image_classify")
class ImageClassifyTask(ClassifyTaskBase):
    dataset_cls = D.ImageClassifyDataset

    def dataset_kwargs(self):
        return {"patch_image_size": self.cfg.patch_image_size,
                "center_crop": self.cfg.center_crop}

    def get_batch_iterator(self, split, batch_size, **kw):
        """Training batches pass through Mixup / CutMix after collation when
        ``task.mixup`` or ``task.cutmix`` is set (ref
        image_classify_dataset.py:46-58; mode and minmax forwarded), hard
        labels becoming (B, num_classes) soft targets."""
        itr = super().get_batch_iterator(split, batch_size, **kw)
        c = self.cfg
        if split == "train" and (c.mixup > 0 or c.cutmix > 0):
            minmax = (tuple(float(x) for x in c.cutmix_minmax.split(","))
                      if c.cutmix_minmax else None)
            mixer = Mixup(c.mixup, c.cutmix, c.mixup_prob, c.mixup_switch_prob,
                          c.label_smoothing, c.num_classes,
                          mode=c.mixup_mode, cutmix_minmax=minmax)
            base_collate = itr.collate_fn

            def collate_with_mixup(samples):
                batch = base_collate(samples)
                batch["src_images"], batch["target"] = mixer(batch["src_images"],
                                                             batch["target"])
                return batch

            itr.collate_fn = collate_with_mixup
            itr.generators["mixup"] = mixer.rng
        return itr


@TASKS.register("vggsound")
class VggsoundTask(ClassifyTaskBase):
    """VGGSound's 309 classes; the recipe leaves ``task.num_classes`` at
    ``TaskConfig``'s default, which is refused."""

    dataset_cls = D.VggsoundDataset

    def __init__(self, cfg, framework_cfg=None):
        refuse_default_classes("vggsound", cfg, 309)
        super().__init__(cfg, framework_cfg)

    def dataset_kwargs(self):
        return {"max_duration": self.cfg.max_duration,
                "feature_encoder_spec": self.audio_conv_spec()}


@TASKS.register("nlvr2")
class Nlvr2Task(ClassifyTaskBase):
    """NLVR2: one statement, two images, true or false (ref
    tasks/vl_tasks/nlvr2.py); the head concatenates both images' pooled
    features."""

    dataset_cls = D.Nlvr2Dataset

    def head_kwargs(self) -> Dict:
        return {"num_classes": 2, "use_two_images": True}


@TASKS.register("fsd50k")
class Fsd50kTask(ClassifyTaskBase):
    """Multi-label audio tagging scored with mAP (ref tasks/audio_tasks).
    The dataset's multi-hot targets have ``task.num_classes`` classes, as
    the head has; the JAX task leaves them at the dataset's 200.  The
    recipe leaves ``task.num_classes`` at ``TaskConfig``'s default, which
    is refused: a head wider than the label space would average classes
    that never occur into the mAP as zeros."""

    dataset_cls = D.Fsd50kDataset

    def __init__(self, cfg, framework_cfg=None):
        refuse_default_classes("fsd50k", cfg, 200)
        super().__init__(cfg, framework_cfg)
        self.metric = MAP()

    def dataset_kwargs(self):
        return {"max_duration": self.cfg.max_duration,
                "feature_encoder_spec": self.audio_conv_spec(),
                "num_classes": self.cfg.num_classes}

    def valid_step(self, model, params, batch):
        logits = self.eval_model(model, params, self._net_input(batch))
        self.metric.compute(batch["id"], logits, np.asarray(batch["target"]))


@TASKS.register("aqa")
class AqaTask(ClassifyTaskBase):
    """Audio question answering over ``criterion.num_choices`` answers (ref
    tasks/audio_tasks/aqa.py): one token row per choice, each clip repeated
    once per choice on the card by ``choice_net_input``, as the criterion
    does; the argmax of each question's scores against its answer."""

    dataset_cls = D.AqaDataset
    criterion_name = "hinge_criterion"

    def dataset_kwargs(self):
        return {"max_src_length": self.cfg.max_src_length,
                "max_duration": self.cfg.max_duration,
                "feature_encoder_spec": self.audio_conv_spec()}

    def head_kwargs(self) -> Dict:
        return {"num_classes": 1}

    def valid_step(self, model, params, batch):
        if self.framework_cfg is None:
            raise ValueError("aqa validates with the framework config: its "
                             "criterion.num_choices groups the rows into questions")
        n = self.framework_cfg.criterion.num_choices
        net = choice_net_input(batch, n, next(model.parameters()).device)
        logits = self.eval_model(model, params, net)
        self.metric.compute(logits.reshape(-1, n), np.asarray(batch["target"]))


@TASKS.register("refcoco")
class RefCOCOTask(ClassifyTaskBase):
    """Visual grounding scored by Acc@0.5 (ref tasks/vl_tasks/refcoco.py:
    24-48): the predicted box, the sigmoid of the model's 4 outputs,
    rescaled by the image's width and height to its original coordinates.
    The outputs stay on the card; ``merge_results`` fetches them once."""

    dataset_cls = D.RefCOCODataset
    criterion_name = "refcoco_criterion"

    def __init__(self, cfg, framework_cfg=None):
        super().__init__(cfg, framework_cfg)
        self.metric = IouAcc()
        self._pending = []

    def head_kwargs(self) -> Dict:
        return {"num_classes": 4}

    def begin_valid_epoch(self, model, params):
        self.metric.initialize()
        self._pending = []

    def valid_step(self, model, params, batch):
        coords = self.eval_model(model, params, self._net_input(batch))
        w = np.asarray(batch["image_widths"])[:, None]
        h = np.asarray(batch["image_heights"])[:, None]
        self._pending.append({"coords": coords.float(),
                              "scale": np.concatenate([w, h, w, h], axis=1),
                              "target": np.asarray(batch["region_coords"])})

    def merge_results(self) -> Dict:
        fetched = fetch_once([p["coords"] for p in self._pending])
        for p, coords in zip(self._pending, fetched):
            pred = 1.0 / (1.0 + np.exp(-np.asarray(coords, np.float32)))
            self.metric.compute(pred * p["scale"], p["target"])
        self._pending = []
        return self.metric.merge_results()


TASKS.register("coco_detection")(CocoDetectionTask)
TASKS.register("ade20k_seg")(Ade20kSegTask)
TASKS.register("k400_video")(K400VideoTask)


def build_task(cfg, framework_cfg=None):
    return TASKS.get(cfg._name)(cfg, framework_cfg)
