"""Retrieval, pretrain and classification criterions (counterpart of
``one_peace_tpu/criterions/criterions.py``).

A criterion is a callable ``(model, batch, generator=None,
deterministic=False) -> (loss, metrics)``.  The retrieval criterions run two
encoder passes, one per modality, each with its own generator, then ITC.
The pretrain criterions run the pretrain model's teacher and student passes
in the reference's order, then ITC and the DCL terms; a pass the JAX
package wraps in ``stop_gradient`` runs under ``torch.no_grad()`` (the same
values, and no activations kept).
``ClassifyCriterion`` runs the classify model on the batch's net input and
also takes ``num_updates``, which the trainer passes to a criterion that
takes it, so that ``freeze_finetune_updates`` thaws.  ``RefCOCOCriterion``
(visual grounding: the 4 outputs through a sigmoid in fp32, then L1 and
GIoU) and ``HingeCriterion`` (AQA: each question's audio repeated once per
answer choice on the card, one score per choice, the multiple-choice
hinge) read the flat batch too.  ``detection_criterion``,
``segmentation_criterion`` and ``video_classify_criterion`` live in
``vision_criterions.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import CriterionConfig

from ..models.classify import NET_INPUT_KEYS, choice_net_input
from ..models.components import split_generator
from .losses import (bce_with_logits_loss, cross_entropy_loss, dcl_loss, hinge_loss,
                     itc_loss, refcoco_loss, soft_target_ce_loss)
from .vision_criterions import DetectionCriterion, SegmentationCriterion, VideoClassifyCriterion


class _RetrievalCriterion:
    other = ""  # the non-text modality
    batch_keys = ()

    def __init__(self, cfg: CriterionConfig):
        self.label_smoothing = cfg.label_smoothing

    def __call__(self, model, batch, generator=None, deterministic=False):
        gens = split_generator(generator, 2)
        text = model(src_tokens=batch["src_tokens"], encoder_type="text",
                     deterministic=deterministic, generator=gens[0])
        other = model(**{k: batch[k] for k in self.batch_keys}, encoder_type=self.other,
                      deterministic=deterministic, generator=gens[1])
        scale = model.logit_scale_exp()
        loss, m = itc_loss(other, text, scale, self.label_smoothing)
        bsz = text.shape[0]
        o = self.other[0]
        metrics = {"loss": loss, "logit_scale_exp": scale,
                   f"{o}2t_accuracy": 100.0 * m["a2b_ncorrect"] / bsz,
                   f"t2{o}_accuracy": 100.0 * m["b2a_ncorrect"] / bsz}
        return loss, metrics


class ImageTextRetrievalCriterion(_RetrievalCriterion):
    """ITC over (image, text) pairs."""
    other = "image"
    batch_keys = ("src_images",)


class AudioTextRetrievalCriterion(_RetrievalCriterion):
    """ITC over (audio, text) pairs."""
    other = "audio"
    batch_keys = ("src_audios", "audio_padding_masks")


class ImageTextPretrainCriterion:
    """ITC + four DCL terms (ref image_text_pretrain_loss.py:77-166), the
    passes in the reference's order: text teacher, image teacher, the VL
    teacher without gradient, then the text, image and VL students.  The
    text and image teachers keep their gradient for ITC; DCL detaches every
    teacher itself."""

    def __init__(self, cfg: CriterionConfig):
        self.cfg = cfg

    def __call__(self, model, batch, generator=None, deterministic=False):
        c = self.cfg
        gens = split_generator(generator, 6)
        tokens, images = batch["src_tokens"], batch["src_images"]
        common = dict(deterministic=deterministic)
        text_logits, teacher_text = model(src_tokens=tokens, encoder_type="text",
                                          generator=gens[0], **common)
        image_logits, teacher_image = model(src_images=images, encoder_type="image",
                                            generator=gens[1], **common)
        with torch.no_grad():
            teacher_vl_text, teacher_vl_image = model(
                src_tokens=tokens, src_images=images, encoder_type="vl", generator=gens[2],
                **common)
        student_text, _, _ = model(src_tokens=tokens, text_preserve_ids=batch["text_preserve_ids"],
                                   encoder_type="text", generator=gens[3], **common)
        _, student_image, _ = model(src_images=images,
                                    image_preserve_ids=batch["image_preserve_ids"],
                                    encoder_type="image", generator=gens[4], **common)
        student_vl_text, student_vl_image, _ = model(
            src_tokens=tokens, text_preserve_ids=batch["vl_text_preserve_ids"],
            src_images=images, image_preserve_ids=batch["vl_image_preserve_ids"],
            encoder_type="vl", generator=gens[5], **common)

        scale = model.logit_scale_exp()
        padding = tokens == 1
        dcl = dict(logit_scale=c.dcl_logit_scale, label_smoothing=c.label_smoothing,
                   gallery_chunks=c.dcl_gallery_chunks)
        dcl_text = dcl_loss(student_text, teacher_text, batch["text_mask_indices"], padding,
                            **dcl)
        dcl_image = dcl_loss(student_image, teacher_image, batch["image_mask_indices"], None,
                             **dcl)
        dcl_vl_text = dcl_loss(student_vl_text, teacher_vl_text,
                               batch["vl_text_mask_indices"], padding, **dcl)
        dcl_vl_image = dcl_loss(student_vl_image, teacher_vl_image,
                                batch["vl_image_mask_indices"], None, **dcl)
        itc, m = itc_loss(image_logits, text_logits, scale)
        loss = (itc + c.dcl_text_alpha * dcl_text + c.dcl_image_alpha * dcl_image
                + c.dcl_vl_text_alpha * dcl_vl_text + c.dcl_vl_image_alpha * dcl_vl_image)
        bsz = tokens.shape[0]
        return loss, {"loss": loss, "itc_loss": itc, "dcl_text_loss": dcl_text,
                      "dcl_image_loss": dcl_image, "dcl_vl_text_loss": dcl_vl_text,
                      "dcl_vl_image_loss": dcl_vl_image, "logit_scale_exp": scale,
                      "i2t_accuracy": 100.0 * m["a2b_ncorrect"] / bsz,
                      "t2i_accuracy": 100.0 * m["b2a_ncorrect"] / bsz}


class AudioTextPretrainCriterion:
    """ATC + three DCL terms (ref audio_text_pretrain_loss.py:73-150), the
    passes in the reference's order: the text teacher without gradient (the
    text branch is frozen in stage 2), the audio teacher, the AL teacher
    without gradient, then the audio and AL students.  Both audio DCL terms
    score against the AL teacher's audio features, as the reference's do."""

    def __init__(self, cfg: CriterionConfig):
        self.cfg = cfg

    def __call__(self, model, batch, generator=None, deterministic=False):
        c = self.cfg
        gens = split_generator(generator, 5)
        tokens, audios = batch["src_tokens"], batch["src_audios"]
        pad_masks = batch["audio_padding_masks"]
        common = dict(deterministic=deterministic)
        with torch.no_grad():
            text_logits, _ = model(src_tokens=tokens, encoder_type="text", generator=gens[0],
                                   **common)
        audio_logits, _ = model(src_audios=audios, audio_padding_masks=pad_masks,
                                encoder_type="audio", generator=gens[1], **common)
        with torch.no_grad():
            teacher_al_text, teacher_al_audio = model(
                src_tokens=tokens, src_audios=audios, audio_padding_masks=pad_masks,
                encoder_type="al", generator=gens[2], **common)
        _, _, student_audio = model(src_audios=audios, audio_padding_masks=pad_masks,
                                    audio_preserve_ids=batch["audio_preserve_ids"],
                                    encoder_type="audio", generator=gens[3], **common)
        student_al_text, _, student_al_audio = model(
            src_tokens=tokens, text_preserve_ids=batch["al_text_preserve_ids"],
            src_audios=audios, audio_padding_masks=pad_masks,
            audio_preserve_ids=batch["al_audio_preserve_ids"], encoder_type="al",
            generator=gens[4], **common)

        scale = model.logit_scale_exp()
        dcl = dict(logit_scale=c.dcl_logit_scale, label_smoothing=c.label_smoothing,
                   gallery_chunks=c.dcl_gallery_chunks)
        dcl_audio = dcl_loss(student_audio, teacher_al_audio, batch["audio_mask_indices"],
                             pad_masks, **dcl)
        dcl_al_text = dcl_loss(student_al_text, teacher_al_text, batch["al_text_mask_indices"],
                               tokens == 1, **dcl)
        dcl_al_audio = dcl_loss(student_al_audio, teacher_al_audio,
                                batch["al_audio_mask_indices"], pad_masks, **dcl)
        atc, m = itc_loss(audio_logits, text_logits, scale)
        loss = (atc + c.dcl_audio_alpha * dcl_audio + c.dcl_al_text_alpha * dcl_al_text
                + c.dcl_al_audio_alpha * dcl_al_audio)
        bsz = tokens.shape[0]
        return loss, {"loss": loss, "atc_loss": atc, "dcl_audio_loss": dcl_audio,
                      "dcl_al_text_loss": dcl_al_text, "dcl_al_audio_loss": dcl_al_audio,
                      "logit_scale_exp": scale,
                      "a2t_accuracy": 100.0 * m["a2b_ncorrect"] / bsz,
                      "t2a_accuracy": 100.0 * m["b2a_ncorrect"] / bsz}


class ClassifyCriterion:
    """Cross entropy with label smoothing on integer targets, soft-target
    cross entropy on (B, C) targets (mixup), or BCE over multi-hot targets
    with ``criterion.use_multi_label`` (VQA, FSD50K); the loss summed over
    the batch and divided by its size.  ``accuracy``: top-1 hits, the soft
    target's mass on the softmax, or the target's value at the argmax.

    The batch is flat (``data/collate.py``): the model's inputs are read from
    its keys.  The JAX criterion reads them from ``batch["net_input"]``,
    which the JAX collate does not make (ROADMAP section 3)."""

    def __init__(self, cfg: CriterionConfig, use_multi_label: Optional[bool] = None):
        self.label_smoothing = cfg.label_smoothing
        if use_multi_label is None:
            use_multi_label = getattr(cfg, "use_multi_label", False)
        self.use_multi_label = use_multi_label

    def __call__(self, model, batch, generator=None, deterministic=False, num_updates=None):
        kw = {}
        if num_updates is not None and getattr(model, "freeze_finetune_updates", 0):
            kw["num_updates"] = num_updates
        logits = model(**{k: batch[k] for k in NET_INPUT_KEYS if k in batch},
                       deterministic=deterministic, generator=generator, **kw)
        targets = batch["target"]
        if targets.is_floating_point():  # Mixup's soft targets may be float64
            targets = targets.float()
        bsz = logits.shape[0]
        if self.use_multi_label:
            loss = bce_with_logits_loss(logits, targets)
            ncorrect = targets.gather(1, logits.argmax(1)[:, None]).sum()
        elif targets.ndim == 2:
            loss = soft_target_ce_loss(logits, targets)
            ncorrect = (torch.softmax(logits.float(), dim=-1) * targets).sum()
        else:
            loss = cross_entropy_loss(logits, targets, self.label_smoothing)
            ncorrect = (logits.argmax(1) == targets).sum()
        loss = loss / bsz
        return loss, {"loss": loss, "accuracy": 100.0 * ncorrect / bsz}


class RefCOCOCriterion:
    """Grounding box regression (ref refcoco_loss.py:20-54): the model's 4
    outputs through a sigmoid in fp32 are the box as fractions of the
    image, held to the target box by ``refcoco_loss``."""

    def __init__(self, cfg: CriterionConfig):
        pass

    def __call__(self, model, batch, generator=None, deterministic=False):
        coords = model(**{k: batch[k] for k in NET_INPUT_KEYS if k in batch},
                       deterministic=deterministic, generator=generator)
        coords = torch.sigmoid(coords.float())
        loss = refcoco_loss(coords, batch["target"].float(), coords.shape[0])
        return loss, {"loss": loss}


class HingeCriterion:
    """AQA multiple choice (ref hinge_loss.py:25-60), margin 1, over
    ``criterion.num_choices`` answers: the model gives one score per
    choice row of ``choice_net_input``, and the hinge runs over each
    question's scores.  The loss is divided by the number of questions, as
    fairseq divides by the sample size."""

    def __init__(self, cfg: CriterionConfig):
        self.num_choices = cfg.num_choices

    def __call__(self, model, batch, generator=None, deterministic=False):
        n = self.num_choices
        logits = model(**choice_net_input(batch, n), deterministic=deterministic,
                       generator=generator).reshape(-1, n)
        loss, ncorrect = hinge_loss(logits, batch["target"])
        bsz = logits.shape[0]
        loss = loss / bsz
        return loss, {"loss": loss, "accuracy": 100.0 * ncorrect / bsz}


CRITERIONS = {"image_text_retrieval_criterion": ImageTextRetrievalCriterion,
              "audio_text_retrieval_criterion": AudioTextRetrievalCriterion,
              "image_text_pretrain_loss": ImageTextPretrainCriterion,
              "audio_text_pretrain_loss": AudioTextPretrainCriterion,
              "classify_criterion": ClassifyCriterion,
              "refcoco_criterion": RefCOCOCriterion,
              "hinge_criterion": HingeCriterion,
              "detection_criterion": DetectionCriterion,
              "segmentation_criterion": SegmentationCriterion,
              "video_classify_criterion": VideoClassifyCriterion}


ALIASES = {"image_text_pretrain": "image_text_pretrain_loss",
           "audio_text_pretrain": "audio_text_pretrain_loss"}


def build_criterion(cfg: CriterionConfig):
    name = ALIASES.get(cfg._name, cfg._name)
    if name not in CRITERIONS:
        raise NotImplementedError(f"criterion {cfg._name!r} is not ported; the port has "
                                  f"{sorted(CRITERIONS)}")
    return CRITERIONS[name](cfg)
