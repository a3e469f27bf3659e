"""The port's ADE20K evaluation path against the JAX package's, on one
synthetic ADE20K tree in ``tmp_path`` (``chip_smoke.write_ade_corpus``:
JPEGs of four sizes and aspect ratios, PNG label maps with raw label 0 and
255 in each): the ``Ade20kSegDataset`` copy over a first epoch (train:
ratio resize, crop and flip; valid: squares) through each package's
iterator, bit for bit; ``MIoU`` against the JAX reducer; ``Ade20kSegTask``'s
``valid_step`` under the whole (with and without the score upsample), slide
and ms_flip protocols against the JAX task's mIoU on the same weights; the
port's ``cli.evaluate`` against the JAX ``cli.evaluate`` on one JAX-written
``.npz``, and the port's CLI under every protocol for both heads from the
``.npz`` and from a fairseq ``.pt``; the port's ``cli.train`` on the
Mask2Former segmenter, its ``checkpoint_best.npz`` read by the JAX
``cli.evaluate``."""

import json

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import write_ade_corpus
from torch_fixture import make_random_state_dict

from one_peace_tpu.core import config as jax_config
from one_peace_tpu.data import iterators as jax_iterators
from one_peace_tpu.data import vision_datasets as jax_vd
from one_peace_tpu.metrics import metrics as jax_metrics
from one_peace_tpu.tasks import build_task as jax_build_task
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu_torch.core import config as port_config
from one_peace_tpu_torch.data import iterators as port_iterators
from one_peace_tpu_torch.data import vision_datasets as port_vd
from one_peace_tpu_torch.metrics import metrics as port_metrics
from one_peace_tpu_torch.tasks import build_task as port_build_task
from one_peace_tpu_torch.utils.checkpoint import model_to_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_

CLASSES = 5
SIZES = ((80, 60), (60, 80), (112, 48), (37, 50))  # (width, height)
MODEL = ["model.encoder.embed_dim=48", "model.encoder.ffn_embed_dim=64",
         "model.encoder.layers=4", "model.encoder.attention_heads=4"]
M2F = ["task.seg_head=mask2former", "task.seg_feat_channels=32", "task.num_queries=6",
       "task.seg_dec_layers=3", "task.seg_pixel_layers=2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_ade_corpus(tmp_path_factory.mktemp("ade"), 6, 4, sizes=SIZES,
                            num_classes=CLASSES, seed=3)


def seeded(model, seed: int):
    """``fill_random_`` from ``seed``, in eval mode."""
    return fill_random_(model, torch.Generator().manual_seed(seed)).eval()


def jax_params(model):
    """The port model's weights as the JAX package's tree (numpy leaves);
    drawing them in the port spares the JAX init's minutes on the CPU."""
    return model_to_jax(model)


def overrides(corpus, *extra):
    return ["task._name=ade20k_seg", f"task.data={corpus['train']}",
            f"task.valid_data={corpus['valid']}", "task.image_size=32",
            f"task.num_classes={CLASSES}", "common.bf16=false", "dataset.batch_size_valid=3",
            *MODEL, *extra]


@pytest.mark.parametrize("split", ["train", "valid"])
def test_first_epoch_equal(corpus, split):
    """Each package's dataset through its own iterator (shuffled for train)
    and ``vision_collate``: bit-equal batches; the corpus holds ignored
    pixels of both kinds and every class."""
    img_dir, _, ann_dir = corpus[split].partition(":")
    batches = []
    for vd, itr in ((port_vd, port_iterators), (jax_vd, jax_iterators)):
        ds = vd.Ade20kSegDataset(split, img_dir, ann_dir, crop_size=32, num_classes=CLASSES,
                                 seed=11)
        it = itr.EpochBatchIterator(ds, vd.vision_collate, batch_size=2, seed=5,
                                    shuffle=split == "train")
        batches.append(list(it.next_epoch_itr()))
    assert len(batches[0]) == len(batches[1]) > 1
    targets = []
    for got, want in zip(*batches):
        assert sorted(got) == sorted(want)
        for key in want:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        targets.append(np.asarray(want["target"]))
    labels = set(np.unique(np.concatenate([t.ravel() for t in targets])).tolist())
    assert 255 in labels and labels - {255} <= set(range(CLASSES))


def test_miou_equal():
    rs = np.random.RandomState(0)
    port, ref = port_metrics.MIoU(6, 255), jax_metrics.MIoU(6, 255)
    for metric in (port, ref):
        metric.initialize()
        assert metric.merge_results() == {"miou": 0.0, "acc_classes": 0}
    for _ in range(3):
        target = rs.randint(0, 5, (2, 9, 7))  # class 5 never appears
        target[:, :2] = 255
        pred = np.where(rs.rand(*target.shape) < 0.6, target, rs.randint(0, 6, target.shape))
        pred[0, 0, 0] = 9  # out of range: clipped
        cm = np.bincount(rs.randint(0, 36, 50), minlength=36).reshape(6, 6)
        for metric in (port, ref):
            metric.compute(pred, target)
            metric.update_confusion(cm)
    got, want = port.merge_results(), ref.merge_results()
    assert got["acc_classes"] == want["acc_classes"] == 6
    assert got["miou"] == pytest.approx(want["miou"], abs=1e-9)


@pytest.fixture(scope="module")
def tasks(corpus):
    """The JAX and port tasks and UperNet segmenters of one configuration on
    the same seeded weights.  The protocol is set
    per test on both tasks' configs; the JAX task keeps its compiled
    functions across the tests."""
    ov = overrides(corpus, "task.seg_eval_stride=16", "task.seg_ms_ratios=(0.5,1.0)")
    out = []
    for config, build in ((jax_config, jax_build_task), (port_config, port_build_task)):
        cfg = config.load_config(None, ov)
        task = build(cfg.task, cfg)
        task.load_dataset("valid")
        out.append((cfg, task))
    (jcfg, jtask), (pcfg, ptask) = out
    pmodel = seeded(ptask.build_model(pcfg, device="cpu"), 7)
    return (jtask, jtask.build_model(jcfg), jax_params(pmodel)), (ptask, pmodel)


def _evaluate(task, model, params):
    task.begin_valid_epoch(model, params)
    itr = task.get_batch_iterator("valid", 3, ensure_equal_batch=False)
    for batch in itr.next_epoch_itr():
        task.valid_step(model, params, batch)
    return task.merge_results()


@pytest.mark.parametrize("protocol,upsample", [("whole", True), ("whole", False),
                                               ("slide", True), ("ms_flip", True)])
def test_valid_step_matches_jax(tasks, protocol, upsample, monkeypatch):
    """The UperNet segmenter on the 4 valid squares (32 px); the JAX slide
    and ms_flip run their host window loop (one compile).  ms_flip at ratios
    0.5 (a padded window) and 1.0, each with its flip; tail windows are
    ``test_torch_port_seg_model.py``'s."""
    monkeypatch.setenv("ONE_PEACE_SLIDE_IMPL", "host")
    (jtask, jmodel, params), (ptask, pmodel) = tasks
    for task in (jtask, ptask):
        task.cfg.seg_eval_protocol = protocol
        task.cfg.seg_eval_logits_upsample = upsample
    want = _evaluate(jtask, jmodel, params)
    got = _evaluate(ptask, pmodel, None)
    assert got["acc_classes"] == want["acc_classes"] > 0
    assert got["miou"] == pytest.approx(want["miou"], abs=1e-6)
    assert 0.0 < got["miou"] < 100.0


def _cli(module, corpus, path, out, *extra, device=True):
    argv = ["--path", str(path), "--output", str(out)]
    if device:
        argv += ["--device", "cpu"]
    assert module.main(argv + overrides(corpus, *extra)) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def npz(corpus, tmp_path_factory):
    """JAX-written ``.npz`` files of both segmenters (seeded weights), by head."""
    root = tmp_path_factory.mktemp("seg_npz")
    paths = {}
    for seed, (head, extra) in enumerate((("mask2former", M2F), ("upernet", []))):
        cfg = port_config.load_config(None, overrides(corpus, *extra))
        model = seeded(port_build_task(cfg.task, cfg).build_model(cfg, device="cpu"), 9 + seed)
        paths[head] = root / f"{head}.npz"
        jax_ckpt.save_params(str(paths[head]), jax_params(model))
    return paths


def test_cli_evaluate_matches_jax_npz(corpus, npz, tmp_path):
    from one_peace_tpu.cli import evaluate as jax_evaluate
    from one_peace_tpu_torch.cli import evaluate as port_evaluate

    want = _cli(jax_evaluate, corpus, npz["mask2former"], tmp_path / "jax.json", *M2F,
                device=False)
    got = _cli(port_evaluate, corpus, npz["mask2former"], tmp_path / "port.json", *M2F)
    assert got["acc_classes"] == want["acc_classes"] > 0
    assert got["miou"] == pytest.approx(want["miou"], abs=1e-6)
    assert got["eval_batched_fetches"] == 1


@pytest.fixture(scope="module")
def pretrain_pt(tmp_path_factory):
    """A fairseq ``.pt`` of the tests' encoder (the CLI's default adapters,
    16-grid image tables)."""
    cfg = jax_config.load_config(None, MODEL).model
    cfg.encoder.image_adapter.bucket_size = cfg.encoder.image_adapter.rel_bucket_size = 16
    sd = make_random_state_dict(cfg, seed=12)
    path = tmp_path_factory.mktemp("seg_pt") / "one-peace.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return path


@pytest.mark.parametrize("head", ["upernet", "mask2former"])
@pytest.mark.parametrize("source", ["npz", "pt"])
def test_port_cli_every_protocol(corpus, npz, pretrain_pt, tmp_path, head, source):
    """The port's CLI runs both heads from a JAX ``.npz`` and from the fairseq
    ``.pt`` (the backbone over ``init_segmenter_``), the recipe's
    Mask2Former under the three protocols, UperNet (512 channels at every
    level: the costly head on the CPU) under the whole one (its slide and
    ms_flip are ``test_valid_step_matches_jax``'s); each prints an mIoU in
    range."""
    from one_peace_tpu_torch.cli import evaluate as port_evaluate

    extra = M2F if head == "mask2former" else []
    for protocol in ("whole", "slide", "ms_flip") if head == "mask2former" else ("whole",):
        stats = _cli(port_evaluate, corpus, npz[head] if source == "npz" else pretrain_pt,
                     tmp_path / f"{protocol}.json", *extra,
                     f"task.seg_eval_protocol={protocol}", "task.seg_eval_stride=16",
                     "task.seg_ms_ratios=(0.75,1.25)")
        assert 0.0 <= stats["miou"] <= 100.0 and stats["acc_classes"] > 0, (protocol, stats)


def test_cli_train_then_jax_evaluate(corpus, tmp_path):
    """The port's ``cli.train`` fine-tunes the Mask2Former segmenter for 2
    updates from files (validation after each, ``checkpoint_best.npz`` by
    mIoU), and the JAX ``cli.evaluate`` reads that export: its mIoU equals
    the one the port's validation recorded in the export."""
    from one_peace_tpu.cli import evaluate as jax_evaluate
    from one_peace_tpu_torch.cli import train as port_train
    from one_peace_tpu_torch.utils import native_checkpoint as port_ckpt

    save = tmp_path / "run"
    extra = [*M2F, "task.seg_num_points=32", "task.seg_max_instances=4"]
    assert port_train.main(["--device", "cpu"] + overrides(
        corpus, *extra, f"checkpoint.save_dir={save}", "dataset.batch_size=2",
        "optimization.max_update=2", "optimization.lr=1e-3", "lr_scheduler.warmup_updates=0",
        "optimization.layer_decay=0.9", "dataset.validate_interval_updates=1",
        "checkpoint.best_checkpoint_metric=miou", "checkpoint.save_interval_updates=1")) == 0
    best = save / "checkpoint_best.npz"
    meta = port_ckpt.load_metadata(str(best))
    assert meta["step"] in (1, 2) and sorted(p.name for p in save.glob("step_*")) == [
        "step_1", "step_2"]
    got = _cli(jax_evaluate, corpus, best, tmp_path / "jax.json", *extra, device=False)
    assert got["miou"] == pytest.approx(meta["miou"], abs=1e-6)
