"""Retrieval and classification criterions (counterpart of
``one_peace_tpu/criterions/criterions.py``).

A criterion is a callable ``(model, batch, generator=None,
deterministic=False) -> (loss, metrics)``.  The retrieval criterions run two
encoder passes, one per modality, each with its own generator, then ITC.
``ClassifyCriterion`` runs the classify model on the batch's net input and
also takes ``num_updates``, which the trainer passes to a criterion that
takes it, so that ``freeze_finetune_updates`` thaws.  ``detection_criterion``
lives in ``vision_criterions.py``.  The pretrain, grounding and hinge
criterions are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import CriterionConfig

from ..models.classify import NET_INPUT_KEYS
from ..models.components import split_generator
from .losses import bce_with_logits_loss, cross_entropy_loss, itc_loss, soft_target_ce_loss
from .vision_criterions import DetectionCriterion


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


CRITERIONS = {"image_text_retrieval_criterion": ImageTextRetrievalCriterion,
              "audio_text_retrieval_criterion": AudioTextRetrievalCriterion,
              "classify_criterion": ClassifyCriterion,
              "detection_criterion": DetectionCriterion}


def build_criterion(cfg: CriterionConfig):
    if cfg._name not in CRITERIONS:
        raise NotImplementedError(f"criterion {cfg._name!r} is not ported; the port has "
                                  f"{sorted(CRITERIONS)}")
    return CRITERIONS[cfg._name](cfg)
