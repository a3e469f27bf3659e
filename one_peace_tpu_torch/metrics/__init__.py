from .metrics import Recall  # noqa: F401
