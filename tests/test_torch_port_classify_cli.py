"""The classification tasks from files through the port's CLIs, on CPU at
toy size: ``cli.train`` on the image_classify (Mixup and CutMix on), VQA
(BCE over 3129 answers) and VGGSound recipes from the config's init, with a
validation each epoch and ``checkpoint_best.npz``; then ``cli.evaluate`` on
that export, which must print the best validation's accuracy.  The export
is read by the JAX package's ``load_params``: its classify model gives the
port's logits on the same batch, and the JAX ``cli.evaluate`` prints the
port's accuracy for image_classify and VQA (the JAX evaluator pads audio
to whole seconds, which moves the audio logits; ROADMAP section 3).  The
the rest of classify (NLVR2, FSD50K, AQA, RefCOCO) builds on the JAX
tasks' datasets and criterions, and the pretrain model raises where the
JAX package has no counterpart.  The synthetic files come from ``chip_smoke.write_classify_corpus``
with a byte-level BPE set, since the GPT-2 assets are not in the repo."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import CLASSIFY_RECIPES, VQA_ANSWERS, write_classify_corpus
from one_peace_tpu import hub as jax_hub
from one_peace_tpu.cli import evaluate as jax_evaluate
from one_peace_tpu.core.config import load_config as jax_load_config
from one_peace_tpu_torch import hub
from one_peace_tpu_torch.cli import evaluate, train
from one_peace_tpu_torch.core.config import TaskConfig, load_config
from one_peace_tpu_torch.models.classify import NET_INPUT_KEYS, OnePeaceClassifyModel
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.utils import native_checkpoint as ckpt
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_port_train_cli import model_overrides

TASK_OVERRIDES = {
    "image_classify": ["task.num_classes=10", "task.mixup=0.8", "task.cutmix=1.0",
                       "task.label_smoothing=0.1"],
    "vqa": [f"task.num_classes={VQA_ANSWERS}"],
    "vggsound": ["task.num_classes=10", "task.max_duration=1"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_classify_corpus(tmp_path_factory.mktemp("classify_cli"), n_train=8, n_valid=4,
                                 clip_seconds=(0.6, 1.4))


def overrides(corpus, task, save_dir):
    t = corpus[task]
    return [*model_overrides("al"), f"task.data={t['train']}", f"task.valid_data={t['valid']}",
            f"task.bpe_dir={corpus['bpe']}", "task.patch_image_size=32", "common.bf16=false",
            "common.log_interval=1", "common.seed=7", f"common.log_file={save_dir}/log.jsonl",
            "optimization.lr=2e-3", "optimization.max_update=3", "lr_scheduler.warmup_updates=1",
            "dataset.batch_size=4", "dataset.batch_size_valid=3", f"checkpoint.save_dir={save_dir}",
            "distributed.fsdp=1", "distributed.tp=1", *TASK_OVERRIDES[task]]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    out = {}
    for task in TASK_OVERRIDES:
        save_dir = tmp_path_factory.mktemp(task)
        ov = overrides(corpus, task, save_dir)
        assert train.main(["--config", str(CLASSIFY_RECIPES[task]), "--device", "cpu", *ov]) == 0
        lines = [json.loads(line) for line in open(save_dir / "log.jsonl")]
        out[task] = {"dir": save_dir, "overrides": ov,
                     "train": [x for x in lines if x["tag"] == "train_inner"],
                     "valid": [x for x in lines if x["tag"] == "valid"]}
    return out


@pytest.mark.parametrize("task", sorted(TASK_OVERRIDES))
def test_train_then_evaluate(runs, task, tmp_path):
    run = runs[task]
    losses = [x["loss"] for x in run["train"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert len(run["valid"]) == 2 and all(v["count"] == 4 for v in run["valid"])
    best = max(v["accuracy"] for v in run["valid"])
    path = run["dir"] / "checkpoint_best.npz"
    assert ckpt.load_metadata(str(path))["accuracy"] == best
    out = tmp_path / "eval.json"
    evaluate.main(["--config", str(CLASSIFY_RECIPES[task]), "--path", str(path), "--output",
                   str(out), "--device", "cpu", *run["overrides"]])
    stats = json.loads(out.read_text())
    assert stats["count"] == 4
    assert abs(stats["accuracy"] - best) <= 1e-6


def _net_input(task_name, cfg):
    task = build_task(cfg.task, cfg)
    task.load_dataset("valid")
    batch = next(iter(task.get_batch_iterator("valid", 3, ensure_equal_batch=False)
                      .next_epoch_itr()))
    return {k: batch[k] for k in NET_INPUT_KEYS if k in batch}


@pytest.mark.parametrize("task", sorted(TASK_OVERRIDES))
def test_export_gives_the_ports_logits_in_jax(runs, corpus, task):
    """The best export through the JAX package's ``load_params`` and
    classify model against the port's model on it, on one valid batch."""
    run = runs[task]
    path = str(run["dir"] / "checkpoint_best.npz")
    recipe = str(CLASSIFY_RECIPES[task])
    cfg, jcfg = load_config(recipe, run["overrides"]), jax_load_config(recipe, run["overrides"])
    for c in (cfg, jcfg):
        c.model.head_type = c.task.head_type
        c.model.encoder.text_adapter.vocab_size = 260
        c.model.encoder.image_adapter.rel_bucket_size = c.task.patch_image_size // 16
    kw = dict(model_type="one_peace_classify", bpe_dir=corpus["bpe"],
              num_classes=cfg.task.num_classes)
    model = hub.from_pretrained(path, model_cfg=cfg.model, task_cfg=cfg.task, device="cpu",
                                **kw).model
    jh = jax_hub.from_pretrained(path, model_cfg=jcfg.model, task_cfg=jcfg.task, **kw)
    assert isinstance(model, OnePeaceClassifyModel)
    state = model.state_dict()
    back = params_from_jax(ckpt.load_params(path))
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
    net = _net_input(task, cfg)
    with torch.no_grad():
        got = model(**{k: torch.as_tensor(v) for k, v in net.items()}).numpy()
    want = np.asarray(jh.model(jh.params, **{k: jnp.asarray(v) for k, v in net.items()}))
    assert got.shape == (3, cfg.task.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("task", ["image_classify", "vqa"])
def test_jax_evaluate_reads_the_export(runs, task, capsys):
    run = runs[task]
    path = str(run["dir"] / "checkpoint_best.npz")
    recipe = str(CLASSIFY_RECIPES[task])
    ov = run["overrides"]
    evaluate.main(["--config", recipe, "--path", path, "--device", "cpu", *ov])
    ours = json.loads(capsys.readouterr().out)
    jax_evaluate.main(["--config", recipe, "--path", path, *ov])
    theirs = json.loads(capsys.readouterr().out)
    assert ours["count"] == theirs["count"] == 4
    assert abs(ours["accuracy"] - theirs["accuracy"]) <= 1e-6


def test_pretrained_pt_gets_a_fresh_head(runs, corpus, tmp_path):
    """A ``.pt`` without a ``classify_head`` (a pretrained checkpoint) loads
    as the encoder over the config's init of the head."""
    import torch_fixture as tf

    from one_peace_tpu_torch.utils.random_weights import init_weights_

    recipe = str(CLASSIFY_RECIPES["image_classify"])
    pt = tmp_path / "pretrained.pt"
    cfg = load_config(recipe, [*runs["image_classify"]["overrides"],
                               f"checkpoint.restore_file={pt}"])
    sd = tf.make_random_state_dict(cfg.model, seed=4)
    torch.save({"model": {k: torch.as_tensor(v) for k, v in sd.items()}}, pt)
    task = build_task(cfg.task, cfg)
    model = train.build_model_for_task(cfg, task, "cpu")
    train.load_weights(cfg, model, "cpu")
    fresh = init_weights_(train.build_model_for_task(cfg, task, "cpu"),
                          torch.Generator().manual_seed(cfg.common.seed),
                          cfg.model.encoder.layer_scale_init_value)
    state, init = model.state_dict(), fresh.state_dict()
    for k in state:
        if k.startswith("classify_head."):
            assert torch.equal(state[k], init[k]), k
    np.testing.assert_array_equal(
        state["encoder_wrapper.image_adapter.cls_embedding"].numpy().ravel(),
        sd["encoder_wrapper.image_adapter.cls_embedding"].ravel())


@pytest.mark.parametrize("name", ["nlvr2", "fsd50k", "aqa", "refcoco"])
def test_classify_tasks_build(name, corpus):
    """The rest of classify builds, on the JAX task's dataset and criterion."""
    from one_peace_tpu.tasks import tasks as jax_tasks

    classes = {"num_classes": 200} if name == "fsd50k" else {}  # FSD50K refuses the default
    task = build_task(TaskConfig(_name=name, bpe_dir=corpus["bpe"], **classes))
    want = jax_tasks.TASKS.get(name)
    assert type(task).dataset_cls.__name__ == want.dataset_cls.__name__
    assert type(task).criterion_name == want.criterion_name


def _pretrain_model(corpus):
    cfg = load_config(str(CLASSIFY_RECIPES["image_classify"]),
                      ["model._name=one_peace_pretrain", f"task.bpe_dir={corpus['bpe']}"])
    task = build_task(cfg.task, cfg)
    return cfg, train.build_model_for_task(cfg, task, "meta")


def test_pretrain_model_builds(corpus):
    """``one_peace_pretrain`` builds (here on the meta device, at the
    recipe's size) with the 768-d decoder."""
    from one_peace_tpu_torch.models.pretrain import OnePeacePretrainModel

    _, model = _pretrain_model(corpus)
    assert isinstance(model, OnePeacePretrainModel)
    assert model.decoder_wrapper.cfg.embed_dim == 768


def test_pretrain_model_raises(corpus, tmp_path):
    """The pretrain model restores only from a ``.npz`` export: a fairseq
    ``.pt`` raises, since the JAX package has no conversion for it."""
    cfg, model = _pretrain_model(corpus)
    path = tmp_path / "one-peace.pt"
    path.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="npz export"):
        train.load_weights(cfg, model, "cpu", str(path))


def test_layer_decay_refused_for_per_layer_tables(runs):
    """The classify model always has one rel-pos table per layer.  Under
    layer decay the trainer no longer refuses it: each adapter's tables move
    by their own layer's scale (``AdamW.slice_scales``), and one update moves
    table i by at most the scale of layer i's lr."""
    from one_peace_tpu_torch.criterions import build_criterion
    from one_peace_tpu_torch.optim.adamw import layer_decay_scales
    from one_peace_tpu_torch.trainer import Trainer

    cfg = load_config(str(CLASSIFY_RECIPES["image_classify"]),
                      [*runs["image_classify"]["overrides"], "optimization.layer_decay=0.9",
                       "criterion._name=classify_criterion"])
    model = train.build_model_for_task(cfg, build_task(cfg.task, cfg), "cpu")
    trainer = Trainer(cfg, model, build_criterion(cfg.criterion))
    named = dict(model.named_parameters())
    tables = {n for n in named if "rel_pos_table" in n}
    assert tables and {id(p) for p, _ in trainer.optimizer.slice_scales} == {
        id(named[n]) for n in tables}
    want = layer_decay_scales(named.items(), cfg.model.encoder.layers, 0.9)
    for p, s in trainer.optimizer.slice_scales:
        name = next(n for n in tables if named[n] is p)
        assert s.shape == (p.shape[0], 1, 1) and p.shape[0] == cfg.model.encoder.layers
        torch.testing.assert_close(s, want[name].float(), rtol=0, atol=0)
        assert len(set(s.flatten().tolist())) == p.shape[0]  # one lr per table
