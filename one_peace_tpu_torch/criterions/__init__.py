"""Training criterions (counterpart of ``one_peace_tpu/criterions``)."""

from .criterions import (AudioTextPretrainCriterion, AudioTextRetrievalCriterion,
                         ClassifyCriterion, HingeCriterion, ImageTextPretrainCriterion,
                         ImageTextRetrievalCriterion, RefCOCOCriterion, build_criterion)
from .vision_criterions import DetectionCriterion, SegmentationCriterion, VideoClassifyCriterion

__all__ = ["AudioTextPretrainCriterion", "AudioTextRetrievalCriterion", "ClassifyCriterion",
           "DetectionCriterion", "HingeCriterion", "ImageTextPretrainCriterion",
           "ImageTextRetrievalCriterion", "RefCOCOCriterion", "SegmentationCriterion",
           "VideoClassifyCriterion", "build_criterion"]
