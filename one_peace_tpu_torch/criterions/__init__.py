"""Training criterions (counterpart of ``one_peace_tpu/criterions``)."""

from .criterions import (AudioTextRetrievalCriterion, ClassifyCriterion,
                         ImageTextRetrievalCriterion, build_criterion)
from .vision_criterions import DetectionCriterion

__all__ = ["AudioTextRetrievalCriterion", "ClassifyCriterion", "DetectionCriterion",
           "ImageTextRetrievalCriterion", "build_criterion"]
