"""Retrieval criterions (counterpart of ``one_peace_tpu/criterions/criterions.py``).

A criterion is a callable ``(model, batch, generator=None,
deterministic=False) -> (loss, metrics)``: two encoder passes, one per
modality, each with its own generator, then ITC.  The pretrain, classify,
grounding and hinge criterions are not ported yet.
"""

from __future__ import annotations

from one_peace_tpu.core.config import CriterionConfig

from ..models.components import split_generator
from .losses import itc_loss


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


CRITERIONS = {"image_text_retrieval_criterion": ImageTextRetrievalCriterion,
              "audio_text_retrieval_criterion": AudioTextRetrievalCriterion}


def build_criterion(cfg: CriterionConfig):
    if cfg._name not in CRITERIONS:
        raise NotImplementedError(f"criterion {cfg._name!r} is not ported; the port has "
                                  f"{sorted(CRITERIONS)}")
    return CRITERIONS[cfg._name](cfg)
