from .metrics import Accuracy, DetectionAP, Recall  # noqa: F401
