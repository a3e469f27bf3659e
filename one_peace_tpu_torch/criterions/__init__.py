"""Training criterions (counterpart of ``one_peace_tpu/criterions``)."""

from .criterions import (AudioTextRetrievalCriterion, ImageTextRetrievalCriterion,
                         build_criterion)

__all__ = ["AudioTextRetrievalCriterion", "ImageTextRetrievalCriterion", "build_criterion"]
