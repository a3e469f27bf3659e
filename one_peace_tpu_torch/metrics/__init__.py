from .metrics import MAP, Accuracy, DetectionAP, IouAcc, MIoU, Recall  # noqa: F401
