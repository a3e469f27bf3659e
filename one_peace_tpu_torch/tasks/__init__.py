"""Tasks (counterpart of ``one_peace_tpu/tasks``)."""
