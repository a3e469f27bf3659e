"""The rest of classification through the port's CLIs on CPU at toy
size: ``recipes/{nlvr2,visual_grounding,aqa,fsd50k}/base.yaml`` from the
synthetic files of ``chip_smoke.write_classify_rest_corpus``, with the
data overrides (and FSD50K's ``task.num_classes=200``) over the toy
model of ``test_torch_port_train_cli.model_overrides``.

Each recipe trains 3 updates through ``cli.train`` with a validation after
each; ``checkpoint_best.npz`` carries the best ``accuracy``, ``acc@0.5`` or
``map`` and ``cli.evaluate`` on it prints that value (to 1e-6) with
``count``.  The export read by the JAX package's ``load_params`` into a
JAX ``OnePeaceClassifyModel`` with the task's head gives the port's outputs
on a valid batch (1e-4).  ``build_model_for_task`` gives each task its head
(NLVR2's two images and 2 classes, RefCOCO's 4 outputs, AQA's 1, FSD50K's
``task.num_classes``), and a restore whose head differs raises."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import CLASSIFY_REST_RECIPES, FSD50K_CLASSES, write_classify_rest_corpus
from one_peace_tpu.models.classify import OnePeaceClassifyModel as JaxModel
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu_torch.cli import evaluate, train
from one_peace_tpu_torch.core.config import load_config
from one_peace_tpu_torch.models.classify import NET_INPUT_KEYS, OnePeaceClassifyModel
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.utils import native_checkpoint as ckpt
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_port_train_cli import model_overrides

TASK_OVERRIDES = {
    "nlvr2": ["task.patch_image_size=32"],
    "refcoco": ["task.patch_image_size=32"],
    "aqa": ["task.max_duration=1"],
    "fsd50k": [f"task.num_classes={FSD50K_CLASSES}", "task.max_duration=1"],
}
METRIC = {"nlvr2": "accuracy", "refcoco": "acc@0.5", "aqa": "accuracy", "fsd50k": "map"}
HEAD = {"nlvr2": (2, 2), "refcoco": (4, 1), "aqa": (1, 1), "fsd50k": (FSD50K_CLASSES, 1)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_classify_rest_corpus(tmp_path_factory.mktemp("classify_rest_cli"), n_train=8,
                                      n_valid=4, clip_seconds=(0.3, 0.9), image_px=(40, 72))


def overrides(corpus, task, save_dir):
    t = corpus[task]
    return [*model_overrides("al"), f"task.data={t['train']}", f"task.valid_data={t['valid']}",
            f"task.bpe_dir={corpus['bpe']}", "common.bf16=false", "common.log_interval=1",
            "common.seed=7", f"common.log_file={save_dir}/log.jsonl", "optimization.lr=2e-3",
            "optimization.max_update=3", "lr_scheduler.warmup_updates=1",
            "dataset.batch_size=4", "dataset.batch_size_valid=3",
            "dataset.validate_interval_updates=1", f"checkpoint.save_dir={save_dir}",
            "distributed.fsdp=1", "distributed.tp=1", *TASK_OVERRIDES[task]]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    out = {}
    for task in TASK_OVERRIDES:
        save_dir = tmp_path_factory.mktemp(task)
        ov = overrides(corpus, task, save_dir)
        assert train.main(["--config", str(CLASSIFY_REST_RECIPES[task]), "--device", "cpu",
                           *ov]) == 0
        lines = [json.loads(line) for line in open(save_dir / "log.jsonl")]
        out[task] = {"dir": save_dir, "overrides": ov,
                     "train": [x for x in lines if x["tag"] == "train_inner"],
                     "valid": [x for x in lines if x["tag"] == "valid"]}
    return out


@pytest.mark.parametrize("task", sorted(TASK_OVERRIDES))
def test_train_then_evaluate(runs, task, tmp_path):
    run, metric = runs[task], METRIC[task]
    losses = [x["loss"] for x in run["train"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert len(run["valid"]) >= 3 and all(v["count"] == 4 for v in run["valid"])
    best = max(v[metric] for v in run["valid"])
    path = run["dir"] / "checkpoint_best.npz"
    assert ckpt.load_metadata(str(path))[metric] == best
    out = tmp_path / "eval.json"
    evaluate.main(["--config", str(CLASSIFY_REST_RECIPES[task]), "--path", str(path), "--output",
                   str(out), "--device", "cpu", *run["overrides"]])
    stats = json.loads(out.read_text())
    assert stats["count"] == 4
    assert abs(stats[metric] - best) <= 1e-6


def _cfg(run, task):
    cfg = load_config(str(CLASSIFY_REST_RECIPES[task]), run["overrides"])
    task_obj = build_task(cfg.task, cfg)
    return cfg, task_obj


@pytest.mark.parametrize("task", sorted(TASK_OVERRIDES))
def test_export_gives_the_ports_outputs_in_jax(runs, task):
    """The best export through the JAX ``load_params`` into a JAX model
    with the task's head, against the port's model on it, one valid batch
    (AQA's clips repeated once per choice, as its criterion does)."""
    run = runs[task]
    path = str(run["dir"] / "checkpoint_best.npz")
    cfg, task_obj = _cfg(run, task)
    model = train.build_model_for_task(cfg, task_obj, "cpu")
    train.load_weights(cfg, model, "cpu", path)
    head = task_obj.head_kwargs()
    jmodel = JaxModel(cfg.model, **head)
    params = jax_ckpt.load_params(path)
    task_obj.load_dataset("valid")
    batch = next(iter(task_obj.get_batch_iterator("valid", 3, ensure_equal_batch=False)
                      .next_epoch_itr()))
    net = {k: batch[k] for k in NET_INPUT_KEYS if k in batch}
    if task == "aqa":
        for k in ("src_audios", "audio_padding_masks"):
            net[k] = np.repeat(net[k], 4, axis=0)
    with torch.no_grad():
        got = model(**{k: torch.as_tensor(v) for k, v in net.items()}).numpy()
    want = np.asarray(jmodel(jax.tree.map(jnp.asarray, params),
                             **{k: jnp.asarray(v) for k, v in net.items()}))
    rows = 12 if task == "aqa" else 3
    assert got.shape == (rows, head["num_classes"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("task", sorted(TASK_OVERRIDES))
def test_each_task_builds_its_head(runs, task):
    cfg, task_obj = _cfg(runs[task], task)
    model = train.build_model_for_task(cfg, task_obj, "meta")
    assert isinstance(model, OnePeaceClassifyModel)
    classes, images = HEAD[task]
    fc1, fc2 = model.classify_head.classifier.fc1, model.classify_head.classifier.fc2
    assert fc2.weight.shape[0] == classes
    assert fc1.weight.shape[1] == images * cfg.model.encoder.embed_dim
    assert model.classify_head.attn_pooling is None and model.classify_head.pooler is None


def test_restore_with_another_head_raises(runs):
    """RefCOCO's 4-output export restored into the NLVR2 recipe's two-image
    head: ``load_weights`` names the entry that differs."""
    cfg, task_obj = _cfg(runs["nlvr2"], "nlvr2")
    model = train.build_model_for_task(cfg, task_obj, "cpu")
    other = str(runs["refcoco"]["dir"] / "checkpoint_best.npz")
    with pytest.raises(ValueError, match=r"classify_head\.classifier\.fc1\.weight"):
        train.load_weights(cfg, model, "cpu", other)
    back = params_from_jax(ckpt.load_params(str(runs["nlvr2"]["dir"] / "checkpoint_best.npz")))
    train.load_weights(cfg, model, "cpu", str(runs["nlvr2"]["dir"] / "checkpoint_best.npz"))
    state = model.state_dict()
    assert all(torch.equal(back[k], state[k]) for k in state)
