"""The K400 video task from files: the rawframe dataset, the criterion, the
task through ``Trainer`` and ``valid_step``, and both CLIs, against the JAX
package's, on the CPU at a small size (d 128, 2 heads of 64, 2 layers, 4
frames, 64 px, B=2).

The corpus is ``chip_smoke.write_k400_corpus``: JPEG frames at 56 x 40 and
40 x 56 (landscape and portrait) and 72 x 48, clips of 5 to 30 frames, all
shorter than the sampled window of 4 frames x 8 apart, so dense sampling
loop-pads them.  The dataset's first epoch through the task's iterator
equals the JAX task's batch by batch under dense and segment sampling, the
``rrc`` and ``scale_jitter`` train pipelines, and 3 clips x ThreeCrop tests.
``Trainer`` steps match the JAX ``Trainer`` on the same weights, the
multi-view accuracy of ``valid_step`` matches the JAX task's clip by clip,
``cli.train`` exports a ``.npz`` whose ``cli.evaluate`` accuracy (both
packages') equals the training run's validation, and a run stopped
mid-epoch and resumed ends where the straight run does."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import write_k400_corpus
from test_torch_port_video_model import numpy_weights_

from one_peace_tpu.core import config as jax_config
from one_peace_tpu.criterions.vision_criterions import VideoClassifyCriterion as JaxCriterion
from one_peace_tpu.parallel.mesh import make_mesh
from one_peace_tpu.tasks import vision_tasks as jax_tasks
from one_peace_tpu.trainer import Trainer as JaxTrainer
from one_peace_tpu_torch.core import config as port_config
from one_peace_tpu_torch.criterions import build_criterion
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.tasks import vision_tasks as port_tasks
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax

RECIPE = "recipes/video/k400_32frames.yaml"
CLASSES = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_k400_corpus(tmp_path_factory.mktemp("k400"), 6, 4, lengths=(5, 12, 30, 9, 20),
                             sizes=((56, 40), (40, 56), (72, 48)), num_classes=CLASSES)


def overrides(corpus, *extra):
    return [f"task.data={corpus['train']}", f"task.valid_data={corpus['valid']}",
            f"task.image_dir={corpus['root']}", "task.image_size=64",
            f"task.num_classes={CLASSES}", "task.num_frames=4", "task.video_frame_interval=8",
            "model.encoder.embed_dim=128", "model.encoder.ffn_embed_dim=256",
            "model.encoder.layers=2", "model.encoder.attention_heads=2", "common.bf16=false",
            "dataset.batch_size=2", "dataset.batch_size_valid=2", *extra]


def configs(corpus, *extra):
    """The recipe with ``overrides`` in both packages."""
    # the port's trainer runs in one process: the recipe's fsdp: 8 needs torchrun
    return (port_config.load_config(RECIPE, overrides(corpus, *extra, "distributed.fsdp=1")),
            jax_config.load_config(RECIPE, overrides(corpus, *extra)))


def tasks(corpus, *extra):
    cfg, jcfg = configs(corpus, *extra)
    return cfg, build_task(cfg.task, cfg), jcfg, jax_tasks.K400VideoTask(jcfg.task, jcfg)


@pytest.mark.parametrize("split,extra", [
    ("train", ()),
    ("train", ("task.video_color_jitter=false",)),
    ("train", ("task.video_sampling=segment", "task.video_train_aug=scale_jitter")),
    ("valid", ()),
    ("valid", ("task.video_sampling=segment",)),
    ("valid", ("task.video_test_clips=1", "task.video_test_three_crop=false"))],
    ids=["dense-rrc", "dense-rrc-no-jitter", "segment-scale-jitter", "3x3crop", "segment-3x3crop",
         "one-view"])
def test_first_epoch_equals_jax(corpus, split, extra):
    """Every batch of the first epoch through each task's iterator (the
    shuffle, the dataset's draws in fetch order, the collate) equals the JAX
    task's, bit for bit; the test views are (V, T, 3, S, S)."""
    _, task, _, jtask = tasks(corpus, *extra)
    task.load_dataset(split)
    jtask.load_dataset(split)
    got = list(task.get_batch_iterator(split, 2, seed=7).next_epoch_itr())
    want = list(jtask.get_batch_iterator(split, 2, seed=7).next_epoch_itr())
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    views = got[0]["src_videos"].shape[1:]
    if split == "valid" and not extra[1:]:
        assert views == ((9 if not extra or "segment" in extra[0] else 1), 4, 3, 64, 64)


def _models(cfg, jcfg, seed=0):
    """The port's classifier on numpy-seeded weights, the JAX classifier of
    the same config, and those weights as its tree."""
    model = numpy_weights_(port_tasks.K400VideoTask.build_model(cfg, device="cpu"), seed)
    jmodel = jax_tasks.K400VideoTask(jcfg.task, jcfg).build_model(jcfg)
    return model, jmodel, jax.tree.map(jnp.asarray, model_to_jax(model))


def test_criterion_matches_jax(corpus):
    """The clip CE with the recipe's label smoothing 0.1 and the accuracy."""
    cfg, task, jcfg, _ = tasks(corpus)
    model, jmodel, tree = _models(cfg, jcfg)
    task.load_dataset("train")
    batch = next(iter(task.get_batch_iterator("train", 2).next_epoch_itr()))
    cfg.criterion._name = port_tasks.K400VideoTask.criterion_name
    criterion = build_criterion(cfg.criterion)
    assert cfg.criterion.label_smoothing == 0.1
    loss, metrics = criterion(model, {k: torch.as_tensor(np.asarray(batch[k]))
                                      for k in ("src_videos", "target")}, deterministic=True)
    jloss, jmetrics = JaxCriterion(jcfg.criterion)(jmodel, tree, batch, deterministic=True)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["accuracy"]) == pytest.approx(float(jmetrics["accuracy"]))


def test_trainer_matches_jax_trainer(corpus):
    """Two updates of the frozen-trunk recipe (remat, AdamW with weight
    decay 0.05, layer decay 0.9, clipping at 1): the losses and lrs at
    1e-5, the trainable parameters after the updates within 1e-4 of their
    norm together and 1e-3 each, the frozen ones bit-unchanged.  (``gnorm``
    differs by design: the port's is over the trainable gradients.)"""
    extra = ("optimization.layer_decay=0.9", "optimization.clip_norm=1.0",
             "optimization.lr=1e-3", "lr_scheduler.warmup_updates=1",
             "optimization.max_update=10", "lr_scheduler.warmup_ratio=0")
    cfg, task, jcfg, _ = tasks(corpus, *extra)
    model, jmodel, tree = _models(cfg, jcfg, seed=1)
    start = {n: p.clone() for n, p in model.named_parameters()}
    cfg.criterion._name = jcfg.criterion._name = "video_classify_criterion"
    port = Trainer(cfg, model, build_criterion(cfg.criterion))
    jtrainer = JaxTrainer(jcfg, jmodel, JaxCriterion(jcfg.criterion), params=tree,
                          mesh=make_mesh(1, 1, 1, devices=jax.devices()[:1]))
    task.load_dataset("train")
    for batch in list(task.get_batch_iterator("train", 2).next_epoch_itr())[:2]:
        batch = {k: batch[k] for k in ("src_videos", "target")}
        got, want = port.train_step(batch), jtrainer.train_step(batch)
        for key in ("loss", "lr", "accuracy"):
            assert got[key] == pytest.approx(float(want[key]), rel=1e-5, abs=1e-6), key
    after = params_from_jax(jax.tree.map(np.asarray, jtrainer.params))
    train = model.trainable_mask()
    diffs, norms = [], []
    for name, p in model.named_parameters():
        if not train[name]:
            assert torch.equal(p, start[name]), name
            continue
        w = after[name].double()
        diffs.append((p.detach().double() - w).norm())
        norms.append(w.norm())
        assert diffs[-1] <= 1e-3 * norms[-1] + 1e-7 * w.numel() ** 0.5, (name, float(diffs[-1]))
        assert not torch.equal(p, start[name]), name
    assert torch.stack(diffs).norm() <= 1e-4 * torch.stack(norms).norm()


def test_valid_step_multiview_accuracy_equals_jax(corpus, monkeypatch):
    """3 clips x ThreeCrop, the views' softmax probabilities averaged per
    clip: the hits of every batch equal the JAX task's, whatever the views
    a forward (4, or all 18 of a batch at once), and ``merge_results``
    fetches once."""
    from one_peace_tpu_torch.metrics.metrics import fetch_once

    cfg, task, jcfg, jtask = tasks(corpus)
    model, jmodel, tree = _models(cfg, jcfg, seed=2)
    task.load_dataset("valid")
    jtask.load_dataset("valid")
    batches = list(task.get_batch_iterator("valid", 2, ensure_equal_batch=False)
                   .next_epoch_itr())
    assert batches[0]["src_videos"].shape[:2] == (2, 9)
    jtask.begin_valid_epoch(jmodel, tree)
    for batch in batches:
        jtask.valid_step(jmodel, tree, batch)
    want = [int(x) for x in jtask.metric.ncorrect_list]
    stats_want = jtask.merge_results()
    for per_forward in (4, 18):
        monkeypatch.setattr(port_tasks.K400VideoTask, "VIEWS_PER_FORWARD", per_forward)
        task.begin_valid_epoch(model, None)
        for batch in batches:
            task.valid_step(model, None, batch)
        assert [int(x) for x in task.metric.ncorrect_list] == want
        before = fetch_once.calls
        stats = task.merge_results()
        assert fetch_once.calls == before + 1
        assert stats == pytest.approx(stats_want) and stats["count"] == 4


def _train(corpus, save, *extra):
    from one_peace_tpu_torch.cli import train as port_train

    argv = ["--config", RECIPE, "--device", "cpu"] + overrides(
        corpus, f"checkpoint.save_dir={save}", f"common.log_file={save}/log.jsonl",
        "common.log_interval=1", "optimization.lr=1e-3", "lr_scheduler.warmup_updates=0",
        "lr_scheduler.warmup_ratio=0", "checkpoint.save_interval_updates=2",
        "checkpoint.save_interval=1000", "dataset.validate_interval=1000",
        "distributed.fsdp=1", *extra)  # one process: the recipe's fsdp: 8 needs torchrun
    assert port_train.main(argv) == 0
    return [json.loads(line) for line in (save / "log.jsonl").read_text().splitlines()]


def _evaluate(module, corpus, path, out, device=True):
    argv = ["--config", RECIPE, "--path", str(path), "--output", str(out)]
    if device:
        argv += ["--device", "cpu"]
    assert module.main(argv + overrides(corpus)) == 0
    return json.loads(out.read_text())


def test_cli_train_then_evaluate(corpus, tmp_path):
    """``cli.train`` 4 updates (3 batches an epoch), validating at each save
    (updates 2 and 4, 3 clips x ThreeCrop), ``checkpoint_best.npz`` by
    accuracy; ``cli.evaluate`` of both packages on the export prints the
    accuracy its validation recorded."""
    from one_peace_tpu.cli import evaluate as jax_evaluate
    from one_peace_tpu_torch.cli import evaluate as port_evaluate
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt

    log = _train(corpus, tmp_path, "optimization.max_update=4",
                 "checkpoint.best_checkpoint_metric=accuracy")
    valid = [r for r in log if r["tag"] == "valid"]
    assert len(valid) == 2 and all(r["count"] == 4 for r in valid)
    best = tmp_path / "checkpoint_best.npz"
    meta = ckpt.load_metadata(str(best))
    got = _evaluate(port_evaluate, corpus, best, tmp_path / "port.json")
    want = _evaluate(jax_evaluate, corpus, best, tmp_path / "jax.json", device=False)
    assert got["count"] == want["count"] == 4
    assert got["accuracy"] == pytest.approx(meta["accuracy"]) == want["accuracy"]
    assert got["eval_batched_fetches"] == 1


def test_mid_epoch_resume_equals_straight_run(corpus, tmp_path):
    """Run to the end of epoch 1 (3 updates, the last save at update 2,
    mid-epoch) and resumed from that save to 4: the resumed updates' losses
    and the final masters equal the straight run's (the iterator restores
    the dataset's crop generator)."""
    from one_peace_tpu_torch.utils import native_checkpoint as ckpt

    straight = _train(corpus, tmp_path / "a", "optimization.max_update=4",
                      "checkpoint.best_checkpoint_metric=")
    _train(corpus, tmp_path / "b", "optimization.max_update=4", "optimization.max_epoch=1",
           "checkpoint.best_checkpoint_metric=")
    mid = ckpt.restore_train_state(str(tmp_path / "b" / "step_2"))
    assert (mid["trainer"]["step"], mid["iterator"]["consumed"]) == (2, 2)
    assert "data_rng" in mid["iterator"]
    resumed = _train(corpus, tmp_path / "b", "optimization.max_update=4",
                     "checkpoint.best_checkpoint_metric=")
    losses = [r["loss"] for r in straight if r["tag"] == "train_inner"]
    again = [r["loss"] for r in resumed if r["tag"] == "train_inner"]
    assert len(losses) == 4 and len(again) == 5  # the log file holds both parts
    assert again[:3] == pytest.approx(losses[:3], rel=1e-6)
    assert again[3:] == pytest.approx(losses[2:], rel=1e-6)
    a = ckpt.restore_train_state(str(tmp_path / "a" / "step_4"))["trainer"]["params"]
    b = ckpt.restore_train_state(str(tmp_path / "b" / "step_4"))["trainer"]["params"]
    for name in a:
        torch.testing.assert_close(b[name], a[name], rtol=1e-6, atol=1e-7)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_train_cli_without_a_card_raises(corpus, tmp_path):
    """Without ``--device`` the CLI builds on ``cuda``: with no card it
    raises rather than training on the CPU."""
    from one_peace_tpu_torch.cli import train as port_train

    with pytest.raises((RuntimeError, AssertionError)):
        port_train.main(["--config", RECIPE] + overrides(
            corpus, f"checkpoint.save_dir={tmp_path}", "distributed.fsdp=1"))
