"""The port's classification data path against the JAX package's, on the
same synthetic files in ``tmp_path``: JPEG images with labels, a VQA TSV
with ``|!+``-separated answer confidences, WAV clips with labels, and a
byte-level BPE set.

Copies held equal, bit for bit: ``Mixup`` in each mode, with and without
``cutmix_minmax``, and its box helpers; RandAugment's ops, the photometric
distortion and the blur on fixed images; the first epoch of
``image_classify`` (with Mixup / CutMix in the collate, and its center-crop
valid split), ``vqa`` and ``vggsound`` through each package's prefetching
iterator.  ``Accuracy`` and VQA's soft score against the JAX reducers on
the same logits."""

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from PIL import Image

from chip_smoke import write_bpe_dir
from one_peace_tpu.core.config import TaskConfig as JaxTaskConfig
from one_peace_tpu.data import mixup as jax_mixup
from one_peace_tpu.data import randaugment as jax_ra
from one_peace_tpu.metrics import metrics as jax_metrics
from one_peace_tpu.tasks import build_task as jax_build_task
from one_peace_tpu_torch.core.config import TaskConfig
from one_peace_tpu_torch.data import mixup as port_mixup
from one_peace_tpu_torch.data import randaugment as port_ra
from one_peace_tpu_torch.metrics import metrics as port_metrics
from one_peace_tpu_torch.tasks import build_task
from test_torch_port_retrieval_data import write_wav

QUESTIONS = ["what color is the dog?", "How many cats", "is it raining", "where is the boat?",
             "what is on the table", "Who holds the kite?", "is the sky blue", "what sport"]


def _images(n, rng):
    out = []
    for i in range(n):
        h, w = 36 + 5 * i, 44 + 3 * (i % 4)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        chans = [np.sin(xx / (5 + c + rng.rand() * 3) + yy / (7 + c)) for c in range(3)]
        arr = (np.stack(chans, -1) * 0.4 + 0.5) * 255 + rng.randn(h, w, 3) * 8
        out.append(Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("classify_corpus")
    rng = np.random.RandomState(0)
    rows = ["image\tlabel"]
    for i, img in enumerate(_images(10, rng)):
        img.save(root / f"img{i}.jpg", quality=90)
        rows.append(f"img{i}.jpg\t{i % 4}")
    (root / "imagenet.tsv").write_text("\n".join(rows) + "\n")
    vqa = ["id\timage\tquestion\trefs"]
    for i, q in enumerate(QUESTIONS):
        answers = rng.choice(20, 1 + i % 3, replace=False)
        refs = "&&".join(f"ans{a}|!+{a}|!+{rng.choice([0.3, 0.6, 0.9, 1.0])}" for a in answers)
        vqa.append(f"{500 + i}\timg{i}.jpg\t{q}\t{refs}")
    (root / "vqa.tsv").write_text("\n".join(vqa) + "\n")
    audio = ["id\taudio\tlabel\tduration"]
    for i in range(7):
        n = 4000 + 2300 * i
        wav = np.sin(np.arange(n) * (0.02 + 0.004 * i)) * 5000 + rng.randn(n) * 600
        write_wav(root / f"clip{i}.wav", wav.astype(np.int16))
        audio.append(f"{900 + i}\tclip{i}.wav\t{i % 3}\t{n / 16000:.3f}")
    (root / "vggsound.tsv").write_text("\n".join(audio) + "\n")
    return {"root": root, "bpe": write_bpe_dir(root / "bpe")}


@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)])
@pytest.mark.parametrize("alphas", [(0.8, 1.0), (0.0, 1.0), (0.8, 0.0)])
def test_mixup_equal(mode, minmax, alphas):
    rng = np.random.RandomState(1)
    images = rng.randn(6, 3, 16, 20).astype(np.float32)
    targets = rng.randint(0, 5, 6)
    mixers = [m.Mixup(alphas[0], alphas[1], prob=0.9, switch_prob=0.5, label_smoothing=0.1,
                      num_classes=5, seed=3, mode=mode, cutmix_minmax=minmax)
              for m in (port_mixup, jax_mixup)]
    for _ in range(4):
        (gi, gt), (wi, wt) = (mixer(images, targets) for mixer in mixers)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
        assert gt.shape == (6, 5) and gt.dtype == wt.dtype  # float64 in "batch" mode
        np.testing.assert_allclose(gt.sum(1), 1.0, rtol=1e-5)


def test_mixup_helpers_equal():
    for h, w, lam in ((32, 32, 0.3), (17, 40, 0.9), (8, 8, 0.0)):
        a, b = np.random.RandomState(5), np.random.RandomState(5)
        assert port_mixup.rand_bbox(a, h, w, lam) == jax_mixup.rand_bbox(b, h, w, lam)
        assert (port_mixup.rand_bbox_minmax(a, h, w, (0.2, 0.8))
                == jax_mixup.rand_bbox_minmax(b, h, w, (0.2, 0.8)))
    np.testing.assert_array_equal(port_mixup.one_hot(np.array([2, 0]), 4, 0.9, 0.025),
                                  jax_mixup.one_hot(np.array([2, 0]), 4, 0.9, 0.025))


@pytest.mark.parametrize("op", port_ra.DEFAULT_OPS + ["Invert", "Posterize", "Solarize", "Color",
                                                      "Contrast"])
def test_augment_ops_equal(op):
    img = _images(1, np.random.RandomState(2))[0]
    for level in (3, 7, 10):
        got = port_ra.apply_op(img, op, level, __import__("random").Random(level))
        want = jax_ra.apply_op(img, op, level, __import__("random").Random(level))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_random_transforms_equal():
    """RandomAugment, RandomDistortion (with hue) and GaussianBlur draw the
    same ops and magnitudes in the same order."""
    images = _images(6, np.random.RandomState(3))
    pairs = [(port_ra.RandomAugment(2, 7, seed=4), jax_ra.RandomAugment(2, 7, seed=4)),
             (port_ra.RandomDistortion(0.4, 0.4, 0.4, 0.1, 0.5, seed=5),
              jax_ra.RandomDistortion(0.4, 0.4, 0.4, 0.1, 0.5, seed=5)),
             (port_ra.GaussianBlur(0.5, seed=6), jax_ra.GaussianBlur(0.5, seed=6))]
    for port_t, jax_t in pairs:
        for img in images:
            np.testing.assert_array_equal(np.asarray(port_t(img)), np.asarray(jax_t(img)))
    with pytest.raises(ValueError):
        port_ra.apply_op(images[0], "Bogus", 5, None)


TASKS = {  # name: (table, task config fields)
    "image_classify": ("imagenet.tsv", dict(head_type="image", patch_image_size=32,
                                            num_classes=4, mixup=0.8, cutmix=1.0,
                                            label_smoothing=0.1, selected_cols="image,label")),
    "image_classify_minmax": ("imagenet.tsv", dict(
        _name="image_classify", head_type="image", patch_image_size=32, num_classes=4,
        cutmix=1.0, cutmix_minmax="0.3,0.7", mixup_mode="pair", selected_cols="image,label")),
    "vqa": ("vqa.tsv", dict(head_type="vl", patch_image_size=32, num_classes=3129)),
    # VGGSound refuses task.num_classes left at 1000 (its 309 classes)
    "vggsound": ("vggsound.tsv", dict(head_type="audio", max_duration=1, num_classes=309)),
}


def _tasks(corpus, name, split):
    table, fields = TASKS[name]
    fields = {"_name": name, **fields}
    path = str(corpus["root"] / table)
    key = "data" if split == "train" else "valid_data"
    kw = {**fields, key: path, "bpe_dir": corpus["bpe"], "center_crop": split != "train"}
    tasks = [build_task(TaskConfig(**kw)), jax_build_task(JaxTaskConfig(**kw))]
    for task in tasks:
        task.load_dataset(split)
    return tasks


@pytest.mark.parametrize("split", ["train", "valid"])
@pytest.mark.parametrize("name", sorted(TASKS))
def test_first_epoch_equal(corpus, name, split):
    """Every batch of the first epoch, through each package's prefetching
    iterator, bit-equal: the augmentations, Mixup and the VQA soft targets
    drawn in the same order."""
    port_task, jax_task = _tasks(corpus, name, split)
    n = 0
    itrs = [t.get_batch_iterator(split, 3, seed=11, ensure_equal_batch=split == "train")
            for t in (port_task, jax_task)]
    for got, want in zip(*(itr.next_epoch_itr() for itr in itrs), strict=True):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), key)
        n += 1
    assert n >= 3
    if name == "vqa":
        assert got["target"].shape[1] == 3129 and got["target"].max() > 0
    if name.startswith("image_classify") and split == "train":
        assert got["target"].ndim == 2  # soft targets


def test_accuracy_equal():
    rng = np.random.RandomState(8)
    ours, theirs = port_metrics.Accuracy(), jax_metrics.Accuracy()
    for m in (ours, theirs):
        m.initialize()
    for b in (4, 7, 1):
        logits = rng.randn(b, 6).astype(np.float32)
        targets = rng.randint(0, 6, b)
        ours.compute(torch.as_tensor(logits), targets)
        theirs.compute(logits, targets)
        soft = rng.rand(b, 6).astype(np.float32)
        score = soft[np.arange(b), logits.argmax(-1)].sum()
        ours.compute(ncorrect=torch.as_tensor(soft)[torch.arange(b), torch.as_tensor(
            logits).argmax(-1)].sum(), count=b)
        theirs.compute(ncorrect=score, count=b)
    got, want = ours.merge_results(), theirs.merge_results()
    assert got["count"] == want["count"] == 24
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-6)


def test_vqa_valid_step_matches_jax(corpus):
    """``VqaTask.valid_step``'s soft score and ``ImageClassifyTask``'s top-1
    on the same logits as the JAX tasks' (the model's forward replaced by
    fixed logits on both sides)."""
    rng = np.random.RandomState(9)
    for name, rows in (("vqa", 8), ("image_classify", 10)):
        port_task, jax_task = _tasks(corpus, name, "valid")
        classes = TASKS[name][1]["num_classes"]
        batches = list(port_task.get_batch_iterator("valid", 3, ensure_equal_batch=False)
                       .next_epoch_itr())
        logits = [rng.randn(len(b["id"]), classes).astype(np.float32) for b in batches]
        for task in (port_task, jax_task):
            task.begin_valid_epoch(None, None)
        for batch, out in zip(batches, logits):
            port_task.eval_model = lambda model, params, net, out=out: torch.as_tensor(out)
            jax_task.eval_model = lambda model, params, net, out=out: out
            port_task.valid_step(None, None, batch)
            jax_task.valid_step(None, None, batch)
        got, want = port_task.merge_results(), jax_task.merge_results()
        assert got["count"] == want["count"] == rows
        np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-6)
