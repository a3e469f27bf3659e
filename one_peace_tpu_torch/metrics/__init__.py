from .metrics import DetectionAP, Recall  # noqa: F401
