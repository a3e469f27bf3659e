"""The port's COCO detection data path and evaluation against the JAX
package's, on one synthetic COCO tree in ``tmp_path`` (``chip_smoke.
write_coco_corpus`` at 64 px: PNGs of four sizes and orientations, category
ids 2, 5 and 9, masks as polygons, compressed and uncompressed RLE, one
crowd region an image and a box too thin to survive any resize).

Copies held equal, bit for bit: ``rle_decode``, ``_polygons_to_mask``,
``CocoDetectionDataset`` over a first epoch (train: LSJ, flips and crowd
filtering; valid: crowd kept as ignore, never evicting a real GT) through
each package's ``EpochBatchIterator`` and ``vision_collate``, with the
prefetch thread keeping fetch order; ``paste_masks`` at stride 1 and 4 with
boxes partly outside the canvas (to 1e-6 on the sampled values);
``DetectionAP.merge_results`` (to 1e-9) on the inputs of
``tests/test_detection_eval.py``'s hand-computed cases and on random
records with crowd, area scaling and masks, and its ragged pack / unpack;
a sharded iterator raises."""

import json

import numpy as np
import pytest

from chip_smoke import rle_encode, write_coco_corpus
from one_peace_tpu.data import iterators as jax_iterators
from one_peace_tpu.data import vision_datasets as jax_vd
from one_peace_tpu.metrics import metrics as jax_metrics
from one_peace_tpu.vision import mask_paste as jax_paste
from one_peace_tpu_torch.core.config import load_config
from one_peace_tpu_torch.data import iterators as port_iterators
from one_peace_tpu_torch.data import vision_datasets as port_vd
from one_peace_tpu_torch.metrics import metrics as port_metrics
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.vision import mask_paste as port_paste

TOY_SIZES = ((64, 48), (48, 64), (80, 60), (33, 50))  # (width, height)
CATEGORY_IDS = (2, 5, 9)
DATASET_KW = dict(image_size=64, max_boxes=4, with_masks=True, mask_stride=4,
                  lsj_min_scale=0.1, lsj_max_scale=2.0, seed=11)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_coco_corpus(tmp_path_factory.mktemp("coco"), 8, 4, sizes=TOY_SIZES,
                             category_ids=CATEGORY_IDS, ext="png", seed=3)


def _dataset(module, corpus, split):
    return module.CocoDetectionDataset(split, corpus[split]["ann"], corpus[split]["images"],
                                       **DATASET_KW)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_rle_decode_equal():
    rs = np.random.RandomState(0)
    for _ in range(50):
        h, w = rs.randint(1, 40, 2)
        mask = (rs.rand(h, w) < rs.rand()).astype(np.uint8)
        for compressed in (True, False):
            rle = rle_encode(mask, compressed)
            got, want = port_vd.rle_decode(rle, h, w), jax_vd.rle_decode(rle, h, w)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, mask)
    rle = rle_encode(mask, True)
    rle["counts"] = rle["counts"].encode("ascii")
    np.testing.assert_array_equal(port_vd.rle_decode(rle, h, w), mask)


@pytest.mark.parametrize("scale,offset,flip_w", [(1.0, (0.0, 0.0), None),
                                                 (0.37, (3.5, 1.25), None),
                                                 (1.3, (10.0, 7.0), 40.0)])
def test_polygons_to_mask_equal(scale, offset, flip_w):
    rs = np.random.RandomState(1)
    polys = [(rs.uniform(-3, 20, 2 * n) + 12 * rs.rand()).tolist() for n in (3, 5, 8)]
    polys.append([1.0, 2.0, 3.0, 4.0])  # two points: not drawn
    got = port_vd._polygons_to_mask(polys, 24, 30, scale, offset, flip_w)
    want = jax_vd._polygons_to_mask(polys, 24, 30, scale, offset, flip_w)
    assert got.dtype == want.dtype and got.any()
    np.testing.assert_array_equal(got, want)


class _RecordingRandomState:
    """A RandomState that logs every ``rand()`` draw (the flip draws)."""

    def __init__(self, seed):
        self.rng, self.rands = np.random.RandomState(seed), []

    def rand(self, *args):
        value = self.rng.rand(*args)
        self.rands.append(value)
        return value

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.mark.parametrize("split", ["train", "valid"])
def test_first_epoch_equal(corpus, split):
    """Each package's dataset through its own iterator (shuffled for train)
    and vision_collate, batch by batch: bit-equal.  The corpus exercises
    what the dataset must get right."""
    port_ds, jax_ds = _dataset(port_vd, corpus, split), _dataset(jax_vd, corpus, split)
    port_ds.rng = _RecordingRandomState(DATASET_KW["seed"])
    batches = []
    for module, ds, collate in ((port_iterators, port_ds, port_vd.vision_collate),
                                (jax_iterators, jax_ds, jax_vd.vision_collate)):
        itr = module.EpochBatchIterator(ds, collate, batch_size=3, seed=5,
                                        shuffle=split == "train")
        batches.append(list(itr.next_epoch_itr()))
    assert len(batches[0]) == len(batches[1]) > 1
    for got, want in zip(*batches):
        _assert_batches_equal(got, want)

    doc = json.loads(open(corpus[split]["ann"]).read())
    assert port_ds.cat_to_label == {2: 0, 5: 1, 9: 2} and port_ds.num_classes == 3
    samples = [port_ds[i] for i in range(len(port_ds))]
    valid = np.stack([s["gt_valid"] for s in samples])
    crowd = np.stack([s["gt_crowd"] for s in samples])
    assert set(np.stack([s["gt_labels"] for s in samples])[valid]) == {0, 1, 2}
    if split == "train":
        assert not crowd.any()  # filtered out of the targets
        assert any(v < 0.5 for v in port_ds.rng.rands)  # some samples flipped
        assert any(v >= 0.5 for v in port_ds.rng.rands)
    else:
        assert crowd.any()  # kept as ignore regions
        # the crowd slot comes after every real GT: it never evicts one
        for v, c in zip(valid, crowd):
            assert not c[:max(np.flatnonzero(v & ~c), default=-1) + 1].any()
        for i, s in enumerate(samples):
            anns = [a for a in doc["annotations"] if a["image_id"] == port_ds.images[i]["id"]]
            objects = sum(not a["iscrowd"] and a["bbox"][2] >= 1 for a in anns)
            # the thin box is dropped, not clipped to 1 px; the crowd takes a
            # slot only where the objects leave one
            assert s["gt_valid"].sum() == min(objects + 1, DATASET_KW["max_boxes"])
            width = (s["gt_boxes"][:, 2] - s["gt_boxes"][:, 0])[s["gt_valid"]]
            assert (width >= 1).all()
            assert s["gt_masks"][s["gt_valid"]].reshape(len(width), -1).any(1).all()


def test_prefetch_keeps_fetch_order(corpus):
    """The iterator's prefetch thread fetches samples strictly in batch
    order, so the dataset's one generator is drawn as without prefetch."""
    fetched = {0: [], 2: []}
    runs = {}
    for prefetch in (0, 2):
        ds = _dataset(port_vd, corpus, "train")
        real = ds.__getitem__

        class Logged:
            def __len__(self):
                return len(ds)

            def __getitem__(self, i, prefetch=prefetch):
                fetched[prefetch].append(i)
                return real(i)

        itr = port_iterators.EpochBatchIterator(Logged(), port_vd.vision_collate, batch_size=3,
                                                seed=5, prefetch=prefetch)
        runs[prefetch] = [b for _ in range(2) for b in itr.next_epoch_itr()]
        order = [i for e in (1, 2) for b in itr._batches_for_epoch(e) for i in b]
        assert fetched[prefetch] == order
    assert fetched[0] == fetched[2]
    for got, want in zip(runs[2], runs[0]):
        _assert_batches_equal(got, want)


def test_vision_collate_equal():
    rs = np.random.RandomState(2)
    samples = [{"id": 7 + i, "src_images": rs.randn(3, 4, 4).astype(np.float32),
                "gt_valid": rs.rand(5) > 0.5, "im_scale": np.float32(rs.rand())}
               for i in range(3)]
    _assert_batches_equal(port_vd.vision_collate(samples), jax_vd.vision_collate(samples))
    assert port_vd.vision_collate([]) == jax_vd.vision_collate([]) == {}


@pytest.mark.parametrize("stride", [1, 4])
def test_paste_masks_equal(stride):
    rs = np.random.RandomState(3 + stride)
    n, size = 12, 64
    xy = rs.uniform(-20, size, (n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0.5, 40, (n, 2))], 1)
    boxes[0] = [-30, -30, -10, -5]  # wholly outside the canvas
    masks = rs.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    out = size // stride
    got = port_paste.paste_masks(masks, boxes, out, out, stride=stride)
    want = jax_paste.paste_masks(masks, boxes, out, out, stride=stride)
    assert got.dtype == want.dtype == bool and got.any() and not got[0].any()
    np.testing.assert_array_equal(got, want)
    fy, fx = rs.uniform(-2, 30, 17), rs.uniform(-2, 30, 13)
    np.testing.assert_allclose(port_paste._bilinear_zero_pad(masks[1], fy, fx),
                               jax_paste._bilinear_zero_pad(masks[1], fy, fx), rtol=0, atol=1e-6)
    assert port_paste.paste_masks(masks[:0], boxes[:0], out, out).shape == (0, out, out)


def _box(x0, y0, x1, y1):
    return np.asarray([[x0, y0, x1, y1]], np.float64)


def _segm_masks():
    gt = np.zeros((1, 32, 32), bool)
    gt[0, 4:12, 4:12] = True
    good, bad = np.zeros((32, 32), bool), np.zeros((32, 32), bool)
    good[4:12, 4:12] = True
    bad[4:12, 20:28] = True
    return gt, good[None], bad[None]


def _hand_cases():
    """The inputs of tests/test_detection_eval.py's hand-computed cases:
    {name: (DetectionAP kwargs, [compute() calls as (args, kwargs)])}."""
    z = lambda n: np.zeros(n, np.int64)  # noqa: E731
    dets3 = np.concatenate([_box(0, 0, 10, 10), _box(20, 20, 30, 26.25), _box(50, 50, 60, 60)])
    crowd_dets = np.concatenate([_box(22, 22, 30, 30), _box(31, 31, 39, 39), _box(0, 0, 10, 10)])
    crowd_gts = np.concatenate([_box(0, 0, 10, 10), _box(20, 20, 40, 40)])
    area_gts = np.concatenate([_box(0, 0, 16, 16), _box(30, 30, 70, 70),
                               _box(100, 100, 200, 200)])
    gt_mask, good, bad = _segm_masks()
    small = np.zeros((1, 16, 16), bool)
    small[0, 2:8, 2:8] = True
    s9 = np.asarray([0.9])
    return {
        "ap_10_thresholds": ({}, [((dets3, np.asarray([0.9, 0.8, 0.7]), z(3),
                                    np.concatenate([_box(0, 0, 10, 10), _box(20, 20, 30, 30)]),
                                    z(2)), {})]),
        "crowd_ignore": ({"iou_thresholds": [0.5]}, [((crowd_dets, np.asarray([0.9, 0.85, 0.8]),
                                                       z(3), crowd_gts, z(2)),
                                                      {"gt_crowd": np.asarray([False, True])})]),
        "crowd_as_real": ({"iou_thresholds": [0.5]}, [((crowd_dets, np.asarray([0.9, 0.85, 0.8]),
                                                        z(3), crowd_gts, z(2)), {})]),
        "crowd_det_area": ({"iou_thresholds": [0.9]}, [((_box(22, 22, 26, 26), s9, z(1),
                                                         crowd_gts, z(2)),
                                                        {"gt_crowd": np.asarray([False, True])})]),
        "area_buckets": ({"iou_thresholds": [0.5]}, [((area_gts[:2], np.asarray([0.9, 0.8]), z(2),
                                                       area_gts, z(3)), {})]),
        "area_scale": ({"iou_thresholds": [0.5]}, [((area_gts[:2] / 2, np.asarray([0.9, 0.8]),
                                                     z(2), area_gts / 2, z(3)),
                                                    {"area_scale": 4.0})]),
        "segm_good": ({"iou_thresholds": [0.5]}, [((_box(4, 4, 12, 12), s9, z(1),
                                                    _box(4, 4, 12, 12), z(1)),
                                                   {"det_masks": good, "gt_masks": gt_mask})]),
        "segm_bad": ({"iou_thresholds": [0.5]}, [((_box(4, 4, 12, 12), s9, z(1),
                                                   _box(4, 4, 12, 12), z(1)),
                                                  {"det_masks": bad, "gt_masks": gt_mask})]),
        "segm_no_dets": ({"iou_thresholds": [0.5]}, [
            ((_box(2, 2, 8, 8), s9, z(1), _box(2, 2, 8, 8), z(1)),
             {"det_masks": small, "gt_masks": small}),
            ((np.zeros((0, 4)), np.zeros(0), z(0), _box(2, 2, 8, 8), z(1)),
             {"det_masks": np.zeros((0, 16, 16), bool), "gt_masks": small})]),
    }


def _random_case(seed):
    """Random per-image records: 3 classes, up to 12 dets and 6 GTs (some
    crowd), images without dets or without GTs, masks at 16 x 16, per-image
    resize factors and annotation areas."""
    rs = np.random.RandomState(seed)
    calls = []
    for i in range(7):
        nd, ng = rs.randint(0, 13) if i else 0, rs.randint(0, 7) if i != 3 else 0

        def boxes(n):
            xy = rs.uniform(0, 48, (n, 2))
            return np.concatenate([xy, xy + rs.uniform(2, 30, (n, 2))], 1)

        gts = boxes(ng)
        dets = np.concatenate([gts[:nd] + rs.normal(0, 2, (min(nd, ng), 4)),
                               boxes(max(nd - ng, 0))])
        f = rs.uniform(0.3, 2.0)
        kw = {"gt_crowd": rs.rand(ng) < 0.2, "area_scale": 1 / f ** 2,
              "det_masks": rs.rand(nd, 16, 16) < 0.4, "gt_masks": rs.rand(ng, 16, 16) < 0.4,
              "mask_area_scale": 16 / f ** 2}
        if i % 2:
            kw["gt_areas"] = rs.uniform(10, 20000, ng)
        calls.append(((dets, rs.rand(nd), rs.randint(0, 3, nd), gts, rs.randint(0, 3, ng)), kw))
    return {"num_classes": 3}, calls


AP_CASES = {**_hand_cases(), **{f"random{s}": _random_case(s) for s in range(4)}}


@pytest.mark.parametrize("case", sorted(AP_CASES))
def test_detection_ap_equal(case):
    kw, calls = AP_CASES[case]
    kw = {"num_classes": 1, **kw}
    results = []
    for module in (port_metrics, jax_metrics):
        metric = module.DetectionAP(**kw)
        metric.initialize()
        for args, call_kw in calls:
            metric.compute(*args, **call_kw)
        results.append(metric.merge_results())
    got, want = results
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-9, (key, got[key], want[key])
    if case.startswith("random"):
        assert want["ap"] > 0 and "ap_mask" in want


def test_ragged_pack_round_trip():
    kw, calls = _random_case(5)
    metric = port_metrics.DetectionAP(**kw)
    metric.initialize()
    for args, call_kw in calls:
        metric.compute(*args, **call_kw)
    packed = port_metrics._pack_ragged_images(metric.images)
    want = jax_metrics._pack_ragged_images(metric.images)
    assert sorted(packed) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(packed[key], want[key])
    back = port_metrics._unpack_ragged_images(packed)
    assert len(back) == len(metric.images)
    for got, rec in zip(back, metric.images):
        assert sorted(got) == sorted(rec)
        for key in rec:
            np.testing.assert_array_equal(got[key], np.asarray(rec[key]).astype(got[key].dtype))
    again = port_metrics.DetectionAP(**kw)
    again.initialize()
    again.images, again.has_masks = back, True
    assert again.merge_results() == metric.merge_results()


def test_sharded_iterator_raises(corpus):
    cfg = load_config(None, ["task._name=coco_detection", f"task.data={corpus['train']['ann']}",
                             f"task.image_dir={corpus['train']['images']}",
                             "task.image_size=64", "task.num_classes=3", "task.max_boxes=4"])
    task = build_task(cfg.task, cfg)
    task.load_dataset("train")
    assert task.get_batch_iterator("train", 2).batch_size == 2
    # no longer raises: rank 1 of 2 takes the second image of each global
    # batch of 2, whose augmentation draws are those of the whole batch
    whole = next(iter(task.get_batch_iterator("train", 2).next_epoch_itr()))
    again = build_task(cfg.task, cfg)  # a fresh dataset: its generator from the start
    again.load_dataset("train")
    part = next(iter(again.get_batch_iterator("train", 2, shard_id=1,
                                              num_shards=2).next_epoch_itr()))
    assert part["src_images"].shape[0] == 1
    for key in ("src_images", "gt_boxes", "gt_labels", "gt_valid"):
        np.testing.assert_array_equal(part[key], whole[key][1:], err_msg=key)
