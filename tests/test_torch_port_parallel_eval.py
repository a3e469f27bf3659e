"""The global-batch losses, the detection step, the sharded-evaluation
merge and the training CLI across gloo ranks on the CPU
(``torch_ranks.run_ranks``; each spawn of ranks takes ~10-25 s).

- ITC and DCL at 2 ranks, each on its rows against the gathered gallery:
  the losses weighted by the ranks' shares sum to the one-process loss of
  the global batch and to ``jax.value_and_grad`` of the JAX loss, and the
  ranks' gradients, concatenated, are the global gradients (1e-5 / 1e-4 as
  ``test_torch_port_train.py``).
- The detection step at 2 ranks (fsdp 2, the toy detector, rpn with the
  subsample sampler, proposal jitter and drop path on) equals the
  one-process step on the same global batches: every random draw is the
  global batch's.
- Every reducer (``Recall``, ``Accuracy``, ``IouAcc``, ``MAP``, ``MIoU``,
  ``DetectionAP`` and the K400 multi-view counts) merged over 2 ranks fed
  contiguous slices of each batch, the last one ragged (a single row, so one
  rank has none), equals the unsharded result; fed the whole data at
  ``num_shards`` 1 (replicas) it does not count twice.
- ``cli/train.py`` at 2 ranks (fsdp 2) on a tiny retrieval corpus logs the
  ``train_inner`` losses and the validation Recall of one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

import parallel_workers as pw
from one_peace_tpu.criterions import losses as jlosses
from one_peace_tpu_torch.criterions.losses import dcl_loss, itc_loss
from test_torch_port_train_cli import corpus, overrides, read_log  # noqa: F401 (fixture)
from torch_ranks import run_ranks

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _grad_close(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-12) + 1e-12, err


def _loss_arrays(b=6, length=5, d=16, seed=0):
    rs = np.random.RandomState(seed)
    a, e = (rs.randn(b, d).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    mask = rs.rand(b, length) < 0.5
    mask[:, 0] = False
    pad = np.zeros((b, length), bool)
    pad[1, -2:] = True
    return {"a": a, "b": e, "scale": np.float32(1 / 0.07),
            "student": rs.randn(b, length, d).astype(np.float32),
            "teacher": rs.randn(b, length, d).astype(np.float32), "mask": mask, "pad": pad}


@pytest.mark.parametrize("label_smoothing,gallery_chunks", [(0.0, 1), (0.1, 1), (0.1, 2)])
def test_losses_at_two_ranks_equal_the_global_batch(label_smoothing, gallery_chunks, tmp_path):
    arrays = _loss_arrays()
    ranks = run_ranks(2, pw.losses_at_ranks, arrays, label_smoothing, gallery_chunks,
                      tmp_path=tmp_path)
    # one process, the global batch
    leaves = [torch.tensor(arrays[k], requires_grad=True) for k in ("a", "b", "scale")]
    itc, _ = itc_loss(*leaves, label_smoothing)
    g_itc = torch.autograd.grad(itc, leaves)
    student = torch.tensor(arrays["student"], requires_grad=True)
    dcl = dcl_loss(student, torch.tensor(arrays["teacher"]), torch.tensor(arrays["mask"]),
                   torch.tensor(arrays["pad"]), logit_scale=2.5, label_smoothing=label_smoothing,
                   gallery_chunks=gallery_chunks)
    (g_dcl,) = torch.autograd.grad(dcl, (student,))
    # the JAX losses
    want_itc = jax.value_and_grad(lambda a, b, s: jlosses.itc_loss(a, b, s, label_smoothing)[0],
                                  argnums=(0, 1, 2))(*(jnp.asarray(arrays[k])
                                                       for k in ("a", "b", "scale")))
    want_dcl = jax.value_and_grad(lambda s: jlosses.dcl_loss(
        s, jnp.asarray(arrays["teacher"]), jnp.asarray(arrays["mask"]),
        jnp.asarray(arrays["pad"]), logit_scale=2.5, label_smoothing=label_smoothing,
        gallery_chunks=gallery_chunks))(jnp.asarray(arrays["student"]))

    got_itc = sum(r["itc"] for r in ranks)
    got_dcl = sum(r["dcl"] for r in ranks)
    for got in (got_itc, float(itc)):
        assert got == pytest.approx(float(want_itc[0]), abs=LOSS_TOL, rel=LOSS_TOL)
    for got in (got_dcl, float(dcl)):
        assert got == pytest.approx(float(want_dcl[0]), abs=LOSS_TOL, rel=LOSS_TOL)
    for k, i in (("a", 0), ("b", 1)):
        merged = np.concatenate([r[k] for r in ranks])
        _grad_close(merged, want_itc[1][i])
        _grad_close(merged, g_itc[i].numpy())
    _grad_close(sum(r["scale"] for r in ranks), want_itc[1][2])
    merged = np.concatenate([r["student"] for r in ranks])
    _grad_close(merged, want_dcl[1])
    _grad_close(merged, g_dcl.numpy())


def _det_batch(seed, b=2, m=3, size=64, stride=4):
    rs = np.random.RandomState(seed)
    x0, y0 = rs.uniform(0, size / 2, (b, m)), rs.uniform(0, size / 2, (b, m))
    w, h = rs.uniform(8, size / 2, (b, m)), rs.uniform(8, size / 2, (b, m))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, size - 1), np.minimum(y0 + h, size - 1)],
                     -1).astype(np.float32)
    masks = np.zeros((b, m, size // stride, size // stride), np.uint8)
    for i in range(b):
        for j in range(m):
            c0, r0, c1, r1 = (boxes[i, j] / stride).astype(int)
            masks[i, j, r0:r1 + 1, c0:c1 + 1] = 1
    valid = np.ones((b, m), bool)
    valid[1, -1] = False
    return {"src_images": rs.randn(b, 3, size, size).astype(np.float32), "gt_boxes": boxes,
            "gt_labels": rs.randint(0, 4, (b, m)), "gt_valid": valid, "gt_masks": masks}


def test_detection_step_at_two_ranks_equals_one_process(tmp_path):
    batches = [_det_batch(s) for s in (1, 2)]
    kw = dict(drop_path_rate=0.3, checkpoint_activations=True)
    ranks = run_ranks(2, pw.detection_steps, batches, 2, kw, tmp_path=tmp_path, timeout=240)
    want = pw.detection_steps(0, 1, batches, 1, kw)
    for r in ranks:
        for got, exp in zip(r["metrics"], want["metrics"], strict=True):
            for key in ("loss", "gnorm", "lr", "skipped", "rpn_obj", "rpn_box", "mask_loss"):
                assert got[key] == pytest.approx(exp[key], rel=1e-5, abs=1e-6), key
    got = ranks[0]["params"]
    for name, w in want["params"].items():
        err = (got[name].double() - w.double()).norm() / max(float(w.norm()), 1e-12)
        assert err <= 1e-4, (name, float(err))  # ReLU units of the heads flip on ~1e-7


def _feeds(n=7, batch=3, seed=0):
    """Evaluation data in batches of ``batch`` rows (the last ragged: one
    row) for every reducer."""
    rs = np.random.RandomState(seed)
    d, c = 8, 5
    text_ids = np.repeat(np.arange(n) + 100, 2)
    text_logits = rs.randn(2 * n, d).astype(np.float32)
    rows = {
        "id": np.arange(n) + 100,
        "image_logits": rs.randn(n, d).astype(np.float32),
        "logits": rs.randn(n, c).astype(np.float32),
        "target": rs.randint(0, c, n),
        "probs": rs.rand(n, 3, c).astype(np.float32),
        "pred_boxes": np.sort(rs.rand(n, 4), axis=-1)[:, [0, 1, 2, 3]] * 50,
        "target_boxes": np.sort(rs.rand(n, 4), axis=-1) * 50,
        "multi_hot": (rs.rand(n, c) < 0.4).astype(np.float32),
        "pred_map": rs.randint(0, c, (n, 6, 6)),
        "target_map": np.where(rs.rand(n, 6, 6) < 0.1, 255, rs.randint(0, c, (n, 6, 6))),
        "n_det": rs.randint(0, 5, n), "n_gt": rs.randint(1, 4, n),
    }
    boxes = lambda k: np.concatenate([np.sort(rs.rand(n, k, 2) * 40, -1)[..., [0]],  # noqa: E731
                                      np.sort(rs.rand(n, k, 2) * 40, -1)[..., [0]],
                                      np.zeros((n, k, 2))], -1)
    det = boxes(5)
    det[..., 2:] = det[..., :2] + 4 + rs.rand(n, 5, 2) * 20
    gt = boxes(4)
    gt[..., 2:] = gt[..., :2] + 4 + rs.rand(n, 4, 2) * 20
    rows.update(det_boxes=det, det_scores=rs.rand(n, 5), det_labels=rs.randint(0, 3, (n, 5)),
                gt_boxes=gt, gt_labels=rs.randint(0, 3, (n, 4)),
                det_masks=rs.rand(n, 5, 8, 8) < 0.4, gt_masks=rs.rand(n, 4, 8, 8) < 0.4)
    batches = [{k: v[i:i + batch] for k, v in rows.items()} for i in range(0, n, batch)]
    return {"text_ids": text_ids, "text_logits": text_logits, "batches": batches}


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    feeds = _feeds()
    assert len(feeds["batches"][-1]["id"]) == 1  # ragged: rank 1 gets no row of it
    whole = pw.merge_reducers(0, 1, feeds, 1)
    sharded = run_ranks(2, pw.merge_reducers, feeds, 2,
                        tmp_path=tmp_path_factory.mktemp("merge"))
    replicas = run_ranks(2, pw.merge_reducers, feeds, 1,
                         tmp_path=tmp_path_factory.mktemp("replicas"))
    return whole, sharded, replicas


REDUCERS = ["recall", "accuracy", "k400", "iou_acc", "map", "miou", "detection_ap"]


@pytest.mark.parametrize("reducer", REDUCERS)
def test_sharded_merge_equals_the_unsharded_result(reducer, merged):
    whole, sharded, _ = merged
    assert whole[reducer]
    for r in sharded:
        assert r[reducer] == whole[reducer], reducer


def test_replicas_are_not_counted_twice(merged):
    whole, _, replicas = merged
    for r in replicas:
        assert r == whole
    assert whole["accuracy"]["count"] == 7 and whole["recall"]["img_count"] == 7


def test_train_cli_at_two_ranks_matches_one_process(corpus, tmp_path):  # noqa: F811
    from one_peace_tpu_torch.cli import train

    logs = {}
    for world in (1, 2):
        save = tmp_path / f"world{world}"
        argv = ["--device", "cpu"] + overrides(corpus, save, checkpoint__restore_file=corpus[
            "root"] / "model.pt", distributed__fsdp=world)
        if world == 1:
            assert train.main(argv) == 0
        else:
            assert run_ranks(2, pw.train_cli, argv, tmp_path=tmp_path, timeout=240) == [0, 0]
        logs[world] = {tag: read_log(save / "log.jsonl", tag) for tag in ("train_inner", "valid")}
    inner = [logs[w]["train_inner"] for w in (1, 2)]
    assert [x["step"] for x in inner[1]] == [x["step"] for x in inner[0]] == [1, 2, 3, 4]
    for got, want in zip(inner[1], inner[0]):
        for key in ("loss", "lr", "gnorm", "i2t_accuracy", "t2i_accuracy"):
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-5), (key, got)
    valid = [logs[w]["valid"] for w in (1, 2)]
    assert len(valid[1]) == len(valid[0]) >= 1
    for got, want in zip(valid[1], valid[0]):
        assert {k: v for k, v in got.items() if k.startswith(("txt_", "img_", "r_"))} == \
            {k: v for k, v in want.items() if k.startswith(("txt_", "img_", "r_"))}
