"""Training criterions (counterpart of ``one_peace_tpu/criterions``)."""

from .criterions import (AudioTextPretrainCriterion, AudioTextRetrievalCriterion,
                         ClassifyCriterion, ImageTextPretrainCriterion,
                         ImageTextRetrievalCriterion, build_criterion)
from .vision_criterions import DetectionCriterion, SegmentationCriterion, VideoClassifyCriterion

__all__ = ["AudioTextPretrainCriterion", "AudioTextRetrievalCriterion", "ClassifyCriterion",
           "DetectionCriterion", "ImageTextPretrainCriterion", "ImageTextRetrievalCriterion",
           "SegmentationCriterion", "VideoClassifyCriterion", "build_criterion"]
