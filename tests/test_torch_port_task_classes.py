"""VQA and VGGSound refuse ``task.num_classes`` left at ``TaskConfig``'s
default of 1000, naming their class counts (3129 and 309), as FSD50K does
(``test_torch_port_classify_rest_data.py``): their recipes leave it there,
and a 1000-way head meets VQA's 3129-way soft targets at the first batch,
or trains VGGSound over 691 classes that never occur."""

import pytest
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu_torch.core.config import TaskConfig, load_config
from one_peace_tpu_torch.tasks import build_task


@pytest.mark.parametrize("name,recipe,classes", [
    ("vqa", "recipes/vqa/base.yaml", 3129), ("vggsound", "recipes/vggsound/base.yaml", 309)])
def test_task_refuses_the_default_class_count(name, recipe, classes):
    cfg = load_config(recipe, [])
    assert cfg.task._name == name and cfg.task.num_classes == TaskConfig.num_classes
    with pytest.raises(ValueError, match=f"task.num_classes={classes}"):
        build_task(cfg.task, cfg)
    with pytest.raises(ValueError, match=f"{classes} classes"):
        build_task(TaskConfig(_name=name))
