"""Tasks (counterpart of ``one_peace_tpu/tasks``)."""

from .base_task import BaseTask  # noqa: F401
from .tasks import build_task  # noqa: F401  (populates the task registry)
