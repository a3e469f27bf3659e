"""The rest of classification's data path against the JAX package's, on
the same synthetic files (``chip_smoke.write_classify_rest_corpus`` at a
small size, with a byte-level BPE set).

Bit for bit: every batch of the first epoch of ``nlvr2``, ``refcoco``,
``aqa`` and ``fsd50k``, train split (NLVR2's distortion, blur, flip and
RandAugment; RefCOCO's blur) and valid split, through each package's
prefetching iterator.  A mid-epoch resume of ``nlvr2`` and of
``image_classify`` (with Mixup) serves the straight run's batches
bit-equal, through a ``torch.save`` / ``torch.load(weights_only=True)``
round trip, and an iterator state written before the augmenters'
generators were saved still loads.  Each task's ``valid_step`` +
``merge_results`` on fixed model outputs against the JAX task's;
``IouAcc`` and ``MAP`` against the JAX reducers (``MAP`` through sklearn
there: ties, a class with no positive, ragged batches)."""

import io

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import FSD50K_CLASSES, write_classify_rest_corpus
from one_peace_tpu.core.config import FrameworkConfig as JaxFrameworkConfig
from one_peace_tpu.core.config import TaskConfig as JaxTaskConfig
from one_peace_tpu.metrics import metrics as jax_metrics
from one_peace_tpu.tasks import build_task as jax_build_task
from one_peace_tpu_torch.core.config import FrameworkConfig, TaskConfig
from one_peace_tpu_torch.data import iterators
from one_peace_tpu_torch.metrics import metrics as port_metrics
from one_peace_tpu_torch.tasks import build_task

TASKS = {  # name: task config fields
    "nlvr2": dict(head_type="vl", patch_image_size=32),
    "refcoco": dict(head_type="vl", patch_image_size=32),
    "aqa": dict(head_type="al", max_duration=1),
    "fsd50k": dict(head_type="audio", max_duration=1, num_classes=FSD50K_CLASSES),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_classify_rest_corpus(tmp_path_factory.mktemp("classify_rest"), n_train=7,
                                      n_valid=5, clip_seconds=(0.2, 0.9), image_px=(40, 72))


def _tasks(corpus, name, split, **extra):
    key = "data" if split == "train" else "valid_data"
    kw = {"_name": name, **TASKS[name], key: corpus[name][split], "bpe_dir": corpus["bpe"],
          **extra}
    tasks = [build_task(TaskConfig(**kw)), jax_build_task(JaxTaskConfig(**kw))]
    for task in tasks:
        task.load_dataset(split)
    return tasks


@pytest.mark.parametrize("split", ["train", "valid"])
@pytest.mark.parametrize("name", sorted(TASKS))
def test_first_epoch_equal(corpus, name, split):
    port_task, jax_task = _tasks(corpus, name, split)
    itrs = [t.get_batch_iterator(split, 3, seed=11, ensure_equal_batch=split == "train")
            for t in (port_task, jax_task)]
    n = 0
    for got, want in zip(*(itr.next_epoch_itr() for itr in itrs), strict=True):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), key)
        n += 1
    assert n >= 2
    if name == "nlvr2":
        assert got["src_images_2"].shape == got["src_images"].shape == (len(got["id"]), 3, 32, 32)
    if name == "aqa":  # one token row per answer choice
        assert got["src_tokens"].shape[0] == 4 * got["src_audios"].shape[0]
    if name == "fsd50k":
        assert got["target"].shape[1] == FSD50K_CLASSES and got["target"].max() == 1
    if name == "refcoco":
        assert got["target"].shape == got["region_coords"].shape == (len(got["id"]), 4)


def test_fsd50k_targets_take_the_task_classes(corpus):
    """The port's FSD50K targets are as wide as ``task.num_classes`` (the
    head's width); the JAX task leaves them at the dataset's 200."""
    port_task = build_task(TaskConfig(_name="fsd50k", data=corpus["fsd50k"]["train"],
                                      bpe_dir=corpus["bpe"], num_classes=300, max_duration=1))
    jax_task = jax_build_task(JaxTaskConfig(_name="fsd50k", data=corpus["fsd50k"]["train"],
                                            bpe_dir=corpus["bpe"], num_classes=300,
                                            max_duration=1))
    assert port_task.load_dataset("train")[0]["target"].shape == (300,)
    assert jax_task.load_dataset("train")[0]["target"].shape == (FSD50K_CLASSES,)


@pytest.mark.parametrize("name,message", [("fsd50k", "task.num_classes=200"),
                                          ("aqa", "criterion.num_choices")])
def test_tasks_refuse_a_setting_left_out(corpus, name, message):
    """FSD50K left at ``TaskConfig``'s 1000 classes is refused, naming the
    override (a 1000-way head would average 800 classes that never occur
    into the mAP); AQA validates only with the framework config, whose
    ``criterion.num_choices`` groups its rows."""
    kw = {"_name": name, **TASKS[name], "valid_data": corpus[name]["valid"],
          "bpe_dir": corpus["bpe"]}
    with pytest.raises(ValueError, match=message):
        if name == "fsd50k":
            build_task(TaskConfig(**{**kw, "num_classes": TaskConfig.num_classes}))
        else:
            task = build_task(TaskConfig(**kw))
            task.load_dataset("valid")
            task.begin_valid_epoch(None, None)
            batch = next(iter(task.get_batch_iterator("valid", 2).next_epoch_itr()))
            task.valid_step(torch.nn.Linear(1, 1), None, batch)


def _round_trip(state):
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def _resumable(corpus, name):
    if name == "nlvr2":
        cfg = TaskConfig(_name="nlvr2", data=corpus["nlvr2"]["train"], bpe_dir=corpus["bpe"],
                         **TASKS["nlvr2"])
    else:  # the corpus's images with 4 labels
        table = corpus["root"] / "imagenet.tsv"
        table.write_text("image\tlabel\n" + "".join(f"img{i}.jpg\t{i % 4}\n" for i in range(9)))
        cfg = TaskConfig(_name="image_classify", data=str(table), bpe_dir=corpus["bpe"],
                         head_type="image", patch_image_size=32, num_classes=4, mixup=0.8,
                         cutmix=1.0, label_smoothing=0.1)

    def make():
        task = build_task(cfg)
        task.load_dataset("train")
        return task.get_batch_iterator("train", 2, seed=5)

    return make


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), key)


@pytest.mark.parametrize("name", ["nlvr2", "image_classify"])
def test_mid_epoch_resume_serves_the_straight_batches(corpus, name):
    """Stopped after 2 batches of epoch 2 (the prefetcher drawn ahead),
    saved, and resumed in fresh objects: the rest of epoch 2 and all of
    epoch 3 equal the straight run's, every augmentation drawn again."""
    make = _resumable(corpus, name)
    straight = make()
    epochs = [list(straight.next_epoch_itr()) for _ in range(3)]
    expected = epochs[1][2:] + epochs[2]

    stopped = make()
    list(stopped.next_epoch_itr())
    it = stopped.next_epoch_itr()
    next(it)
    next(it)
    state = _round_trip(stopped.state_dict())
    names = {"nlvr2": {"distort", "blur", "randaug"},
             "image_classify": {"distort", "blur", "randaug", "mixup"}}[name]
    assert "data_rng" in state and set(state["generators"]) == names
    resumed = make()
    resumed.load_state_dict(state)
    got = list(resumed.next_epoch_itr()) + list(resumed.next_epoch_itr())
    _assert_batches_equal(got, expected)
    # without the augmenters' generators the resumed batches differ
    old = make()
    old.load_state_dict({k: v for k, v in state.items() if k != "generators"})
    differs = [not np.array_equal(a["src_images"], b["src_images"])
               for a, b in zip(old.next_epoch_itr(), expected)]
    assert any(differs)


def test_state_saved_before_the_augmenters_loads(corpus):
    """A state with only the dataset's ``data_rng`` (as iterators wrote it
    before) restores the dataset's generator and leaves the others."""
    task = build_task(TaskConfig(_name="nlvr2", data=corpus["nlvr2"]["train"],
                                 bpe_dir=corpus["bpe"], **TASKS["nlvr2"]))
    task.load_dataset("train")
    rng = np.random.RandomState(77)
    name, keys, pos, has_gauss, gauss = rng.get_state()
    old = {"epoch": 2, "consumed": 1, "seed": 5,
           "data_rng": [name, torch.from_numpy(keys.astype(np.int64)), int(pos), int(has_gauss),
                        float(gauss)]}
    itr = task.get_batch_iterator("train", 2, seed=5)
    blur_before = itr.generators["blur"].getstate()
    itr.load_state_dict(_round_trip(old))
    assert (itr.epoch, itr._consumed, itr.seed) == (2, 1, 5)
    assert task.datasets["train"].rng.randint(1 << 30) == rng.randint(1 << 30)
    assert itr.generators["blur"].getstate() == blur_before
    assert set(itr.state_dict()) == {"epoch", "consumed", "seed", "data_rng"}


def test_dataset_generators_found(corpus):
    for name, want in (("nlvr2", {"rng", "distort", "blur", "randaug"}),
                       ("refcoco", {"blur"}), ("aqa", set()), ("fsd50k", set())):
        port_task, _ = _tasks(corpus, name, "train")
        assert set(iterators.dataset_generators(port_task.datasets["train"])) == want, name
    port_task, _ = _tasks(corpus, "nlvr2", "valid")
    assert set(iterators.dataset_generators(port_task.datasets["valid"])) == {"rng"}


def _framework(cls):
    cfg = cls()
    cfg.criterion.num_choices = 4
    return cfg


def _outputs(name, batch, rng):
    b = len(batch["id"])
    if name == "aqa":
        return rng.randn(4 * b, 1).astype(np.float32)
    width = {"nlvr2": 2, "refcoco": 4, "fsd50k": FSD50K_CLASSES}[name]
    out = rng.randn(b, width).astype(np.float32)
    if name == "refcoco":  # some boxes near their targets, so that Acc@0.5 counts hits
        frac = batch["region_coords"] / np.stack([batch["image_widths"], batch["image_heights"]] * 2,
                                                 axis=1)
        near = np.log(np.clip(frac, 1e-3, 1 - 1e-3) / (1 - np.clip(frac, 1e-3, 1 - 1e-3)))
        out[::2] = near[::2] + out[::2] * 0.05
    return out


@pytest.mark.parametrize("name", sorted(TASKS))
def test_valid_step_matches_jax(corpus, name):
    """``valid_step`` + ``merge_results`` on the same model outputs (the
    forward replaced on both sides) as the JAX task's; AQA's repeated audio
    checked in the net input, RefCOCO's boxes fetched once."""
    key = "valid_data"
    kw = {"_name": name, **TASKS[name], key: corpus[name]["valid"], "bpe_dir": corpus["bpe"]}
    port_task = build_task(TaskConfig(**kw), _framework(FrameworkConfig))
    jax_task = jax_build_task(JaxTaskConfig(**kw), _framework(JaxFrameworkConfig))
    for task in (port_task, jax_task):
        task.load_dataset("valid")
    batches = list(port_task.get_batch_iterator("valid", 2, ensure_equal_batch=False)
                   .next_epoch_itr())
    rng = np.random.RandomState(3)
    outputs = [_outputs(name, b, rng) for b in batches]
    probe = torch.nn.Linear(1, 1)  # the device the port's AQA repeats on
    for task in (port_task, jax_task):
        task.begin_valid_epoch(None, None)
    seen = []
    fetches = port_metrics.fetch_once.calls
    for batch, out in zip(batches, outputs):
        def port_eval(model, params, net, out=out):
            seen.append({k: tuple(np.shape(v)) for k, v in net.items()})
            if name == "aqa":
                assert isinstance(net["src_audios"], torch.Tensor)
            return torch.as_tensor(out)

        port_task.eval_model = port_eval
        jax_task.eval_model = lambda model, params, net, out=out: out
        port_task.valid_step(probe, None, batch)
        jax_task.valid_step(None, None, batch)
    got, want = port_task.merge_results(), jax_task.merge_results()
    assert got.keys() == want.keys()
    assert got["count"] == want["count"] == 5
    metric = {"nlvr2": "accuracy", "aqa": "accuracy", "refcoco": "acc@0.5", "fsd50k": "map"}[name]
    np.testing.assert_allclose(got[metric], want[metric], rtol=1e-6, atol=1e-9)
    assert port_metrics.fetch_once.calls - fetches == 1
    if name == "aqa":
        for shapes, batch in zip(seen, batches):
            assert shapes["src_audios"][0] == shapes["src_tokens"][0] == 4 * len(batch["id"])
    if name == "refcoco":
        assert 0 < got[metric] < 100


def test_iou_acc_equal():
    rng = np.random.RandomState(4)
    ours, theirs = port_metrics.IouAcc(), jax_metrics.IouAcc()
    for m in (ours, theirs):
        m.initialize()
    for b in (5, 1, 8):
        lo = rng.rand(b, 2) * 50
        target = np.concatenate([lo, lo + 5 + rng.rand(b, 2) * 40], 1)
        pred = target + rng.randn(b, 4) * rng.choice([1.0, 10.0, 30.0])
        pred[0, 2:] = pred[0, :2] - 1  # an inverted box
        ours.compute(pred, target)
        theirs.compute(pred, target)
    got, want = ours.merge_results(), theirs.merge_results()
    assert got == want and got["count"] == 14
    box = rng.rand(6, 4)
    np.testing.assert_array_equal(port_metrics.IouAcc.box_iou(box, box[::-1]),
                                  jax_metrics.IouAcc.box_iou(box, box[::-1]))


@pytest.mark.parametrize("case", ["ties", "all_negative_class", "ragged", "random"])
def test_map_equals_jax_map(case):
    """The port's ``MAP`` (no sklearn) against the JAX ``MAP`` (sklearn's
    per-class average precision) on the same logits and targets."""
    rng = np.random.RandomState({"ties": 0, "all_negative_class": 1, "ragged": 2, "random": 3}[case])
    sizes = {"ragged": (5, 1, 9, 3)}.get(case, (6, 6))
    c = 7
    ours, theirs = port_metrics.MAP(), jax_metrics.MAP()
    for m in (ours, theirs):
        m.initialize()
    for b in sizes:
        if case == "ties":  # few distinct scores: tied predictions across rows
            logits = rng.randint(-2, 3, (b, c)).astype(np.float32)
        else:
            logits = rng.randn(b, c).astype(np.float32) * 3
        targets = (rng.rand(b, c) < 0.4).astype(np.float32)
        if case == "all_negative_class":
            targets[:, 2] = 0.0
        targets[0, 0] = 1.0  # class 0 has a positive in every case
        ids = np.arange(b)
        ours.compute(ids, torch.as_tensor(logits), targets)
        theirs.compute(ids, logits, targets)
    got, want = ours.merge_results(), theirs.merge_results()
    assert got["count"] == want["count"] == sum(sizes)
    np.testing.assert_allclose(got["map"], want["map"], rtol=1e-12, atol=1e-12)


def test_average_precision_per_class_matches_sklearn():
    """Each class's AP, not only their mean, against sklearn (as the JAX
    ``MAP`` calls it), including an all-negative class (0.0)."""
    from sklearn.metrics import average_precision_score

    rng = np.random.RandomState(5)
    targets = (rng.rand(40, 5) < 0.3).astype(np.float32)
    targets[:, 4] = 0.0
    scores = np.round(rng.rand(40, 5) * 4) / 4
    with pytest.warns(UserWarning):
        want = average_precision_score(targets, scores, average=None)
    got = [port_metrics.average_precision(targets[:, i], scores[:, i]) for i in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got[4] == 0.0
