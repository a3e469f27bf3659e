from .metrics import Accuracy, DetectionAP, MIoU, Recall  # noqa: F401
