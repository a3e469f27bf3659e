"""COCO detection through the port's task and CLIs against the JAX package,
at toy size (D 32, F 64, 4 heads, 4 layers, 64 px, window 2, 3 classes,
``max_boxes`` 4) on a synthetic COCO tree of PNGs in ``tmp_path``
(``chip_smoke.write_coco_corpus``), fp32, the JAX side on its XLA attention.

- ``params_to_jax`` with the detector's ``jax_layout`` inverts
  ``params_from_jax`` on the detector tree (keys, shapes, values), for
  global periods 2 and 4 and both proposers, bf16 leaves too; a trunk of
  global layers only raises.
- ``init_detector_`` against ``OnePeaceDetector.init``: every leaf that the
  JAX init holds constant is equal; every random leaf lies within the bound
  of its JAX distribution, with a standard deviation within 10% of it.
- ``CocoDetectionTask.valid_step`` on the weights of JAX's ``init`` (saved
  by the JAX ``save_params``, read through ``params_from_jax``): the AP dict
  within 1e-6 of the JAX task's, on the model's weights and on a parameter
  dict as the trainer passes; the per-image records (scores and box IoUs
  to 1e-4, pasted-mask IoUs equal) and their AP at IoU 0.1-0.3, where a
  fresh init scores above 0, within 1e-6.
- The CLIs: the port's ``cli.train`` takes 3 updates, validates and writes
  ``checkpoint_best.npz``; both packages' ``cli.evaluate`` on it print AP
  dicts within 1e-6 of each other and of the run's validation.  A ``.pt``
  restore gives the trunk of ``load_pretrained`` and the heads of
  ``init_detector_`` drawn from ``common.seed``."""

import json

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from chip_smoke import write_coco_corpus
from test_vision_checkpoint import _fake_vision_sd
from one_peace_tpu.cli import evaluate as jax_evaluate
from one_peace_tpu.core.config import load_config as jax_load_config
from one_peace_tpu.tasks import build_task as jax_build_task
from one_peace_tpu.utils import native_checkpoint as jax_ckpt
from one_peace_tpu.vision.zoo import OnePeaceDetector as JaxDetector
from one_peace_tpu_torch.cli import evaluate, train
from one_peace_tpu_torch.core.config import load_config
from one_peace_tpu_torch.metrics import DetectionAP
from one_peace_tpu_torch.tasks import build_task
from one_peace_tpu_torch.utils import native_checkpoint as ckpt
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax, params_to_jax
from one_peace_tpu_torch.utils.random_weights import init_detector_
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

RECIPE = "recipes/detection/cascade_mask_rcnn_1024.yaml"
TOY = dict(num_classes=3, image_size=64, fpn_channels=16, embed_dim=32, ffn_embed_dim=64,
           heads=4, layers=4, window_size=2)
AP_TOL = 1e-6
TRUNC_STD = 0.537965  # std of N(0, 1) truncated to [-1, 1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("det_cli")
    paths = write_coco_corpus(root, 6, 4, sizes=((64, 48), (48, 64), (80, 60), (33, 50)),
                              category_ids=(2, 5, 9), ext="png", seed=4)
    return {"root": root, **paths}


def overrides(corpus, **extra):
    ov = {"task.data": corpus["train"]["ann"], "task.image_dir": corpus["train"]["images"],
          "task.valid_data": corpus["valid"]["ann"],
          "task.valid_image_dir": corpus["valid"]["images"], "task.image_size": "64",
          "task.num_classes": "3", "task.max_boxes": "4", "task.window_size": "2",
          "task.max_proposals": "16", "model.encoder.embed_dim": "32",
          "model.encoder.ffn_embed_dim": "64", "model.encoder.layers": "4",
          "model.encoder.attention_heads": "4", "common.bf16": "false",
          "dataset.batch_size": "2", "dataset.batch_size_valid": "2", **extra}
    return [f"{k}={v}" for k, v in ov.items()]


def _flat(tree, prefix=()):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): sub for i, sub in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {"/".join(prefix): tree}


def _numpy(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("proposer,period", [("rpn", 2), ("fcos", 4), ("rpn", 1)])
def test_params_to_jax_inverts_params_from_jax_on_the_detector(proposer, period):
    geometry = {**TOY, "global_period": period}
    jdet = JaxDetector(proposer=proposer, checkpoint_activations=False, **geometry)
    params = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(period)))
    tree = _flat(params)
    det = OnePeaceDetector(proposer=proposer, device="cpu", **geometry)
    state = params_from_jax(params)
    det.load_state_dict(state, strict=True)
    if period == 1:  # no windowed layers: their (groups, 0, ...) shapes are not in the state
        with pytest.raises(NotImplementedError, match="global period 1"):
            params_to_jax(state, **det.jax_layout())
        return
    back = _flat(params_to_jax(state, **det.jax_layout()))
    assert sorted(back) == sorted(tree)
    assert "fpn/scale_4.0/up1/w" in back and "backbone/win_layers/gamma_1" in back
    for key, want in tree.items():
        assert back[key].shape == want.shape and back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    again = params_from_jax(model_to_jax(det))
    assert again.keys() == det.state_dict().keys()
    assert all(torch.equal(again[k], v) for k, v in det.state_dict().items())
    bf16 = _flat(model_to_jax(det.to(torch.bfloat16)))
    assert all(v.dtype == torch.bfloat16 for v in bf16.values())
    for key, want in tree.items():
        np.testing.assert_array_equal(_numpy(bf16[key]),
                                      torch.tensor(want).bfloat16().float().numpy(), key)


def _distribution(key, leaf, tree):
    """(bound or None, std) of a random leaf of ``OnePeaceDetector.init``,
    from its path in ``tree``: ``init_conv2d`` (kernel within
    sqrt(3 / fan_in), bias within 1 / sqrt(fan_in) of the kernel beside it),
    the trunk's truncated N(0, 0.02^2), the heads' Xavier-uniform,
    ``pos_embed``'s N(0, 1 / d)."""
    name = key.rsplit("/", 1)[-1]
    if name == "pos_embed":
        return None, leaf.shape[-1] ** -0.5
    if "_layers/" in key:
        return 0.02, 0.02 * TRUNC_STD
    if key.startswith("box_head/"):
        bound = np.sqrt(6.0 / (leaf.shape[0] + leaf.shape[1]))
        return bound, bound / np.sqrt(3)
    fan_in = np.prod(tree[key.rsplit("/", 1)[0] + "/w"].shape[:3])  # HWIO
    bound = np.sqrt(3.0 / fan_in) if name == "w" else 1.0 / np.sqrt(fan_in)
    return bound, bound / np.sqrt(3)


@pytest.mark.parametrize("proposer", ["rpn", "fcos"])
def test_init_detector_matches_jax_init(proposer):
    geometry = {**TOY, "global_period": 2, "pretrain_bucket_size": 4}
    jdet = JaxDetector(proposer=proposer, checkpoint_activations=False, **geometry)
    jax_a, jax_b = (_flat(jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(s))))
                    for s in (0, 1))
    det = init_detector_(OnePeaceDetector(proposer=proposer, device="cpu", **geometry),
                         torch.Generator().manual_seed(0))
    port = {k: _numpy(v) for k, v in _flat(model_to_jax(det)).items()}
    assert sorted(port) == sorted(jax_a)
    constant, random = [], []
    for key, want in jax_a.items():
        if np.array_equal(want, jax_b[key]):  # the JAX init does not draw it
            np.testing.assert_array_equal(port[key], want, err_msg=key)
            constant.append(key)
            continue
        random.append(key)
        bound, std = _distribution(key, want, jax_a)
        for name, leaf in (("jax", want), ("port", port[key])):
            if bound is not None:
                assert np.abs(leaf).max() <= bound * (1 + 1e-6), (name, key)
            if leaf.size >= 500:
                assert abs(leaf.std() - std) <= 0.1 * std, (name, key, leaf.std(), std)
    assert {"backbone/rel_pos_table", "backbone/glob_layers/self_attn/rel_pos_h",
            "backbone/win_layers/gamma_1", "fpn/scale_1.0/lateral_ln/scale"} <= set(constant)
    if proposer == "fcos":
        assert {"proposer/scales", "proposer/cls_pred/b", "proposer/cls_tower/0/gn/scale"} \
            <= set(constant)
        np.testing.assert_allclose(port["proposer/cls_pred/b"], -np.log(99.0), rtol=1e-6)
    assert len(random) > 30


def _jax_and_port_tasks(corpus, extra=()):
    ov = overrides(corpus) + ["model.encoder.attn_impl=xla", *extra]
    jcfg, cfg = jax_load_config(RECIPE, ov), load_config(RECIPE, ov)
    return jcfg, jax_build_task(jcfg.task, jcfg), cfg, build_task(cfg.task, cfg)


def test_valid_step_matches_jax(corpus, tmp_path):
    """The same weights (JAX's init, through the JAX save_params and the
    port's params_from_jax) and the same batches: the AP dicts agree."""
    jcfg, jtask, cfg, task = _jax_and_port_tasks(corpus)
    jdet = jtask.build_model(jcfg)
    params = jdet.init(jax.random.PRNGKey(7))
    jax_ckpt.save_params(str(tmp_path / "init.npz"), params)
    det = task.build_model(cfg, device="cpu")
    det.load_state_dict(params_from_jax(ckpt.load_params(str(tmp_path / "init.npz"))),
                        strict=True)
    task.load_dataset("valid")
    batches = list(task.get_batch_iterator("valid", 2, ensure_equal_batch=False)
                   .next_epoch_itr())
    results = []
    for run in ("jax", "port", "port with a parameter dict"):
        t = jtask if run == "jax" else task
        t.begin_valid_epoch(None, None)
        for batch in batches:
            if run == "jax":
                t.valid_step(jdet, params, batch)
            else:
                t.valid_step(det, dict(det.named_parameters())
                             if run.endswith("dict") else None, batch)
        results.append(t.merge_results())
    want = results[0]
    assert "ap_mask" in want and want["classes_with_gt"] == 3
    for got in results[1:]:
        assert sorted(got) == sorted(want)
        for key in want:
            assert abs(got[key] - want[key]) <= AP_TOL, (key, got[key], want[key])
    assert results[1] == results[2]
    assert det.training  # valid_step put the training mode back

    # the per-image records: detections, pasted masks and IoUs.  A fresh
    # init's boxes rarely reach IoU 0.5 (its AP is 0 above), so the records
    # are also swept at IoU 0.1-0.3, where the AP is not
    assert len(jtask.metric.images) == len(task.metric.images) == 4
    for a, b in zip(jtask.metric.images, task.metric.images):
        assert sorted(a) == sorted(b) and len(a["scores"]) > 0
        for key in ("dlabels", "glabels", "gcrowd", "gareas", "dareas_mask", "iou_mask"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        for key in ("scores", "iou_box"):
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(b["dareas"], a["dareas"], rtol=1e-4, err_msg="dareas")
    swept = []
    for t in (jtask, task):
        low = DetectionAP(num_classes=3, iou_thresholds=[0.1, 0.2, 0.3])
        low.initialize()
        low.images, low.has_masks = t.metric.images, True
        swept.append(low.merge_results())
    assert swept[0]["ap"] > 0 and swept[0]["ap_mask"] > 0
    for key in swept[0]:
        assert abs(swept[1][key] - swept[0][key]) <= AP_TOL, key


def test_cli_train_then_both_evaluates(corpus, capsys):
    save_dir = corpus["root"] / "run"
    ov = overrides(corpus, **{
        "optimization.max_update": "3", "dataset.validate_interval_updates": "3",
        "lr_scheduler.warmup_updates": "1", "common.log_interval": "1", "common.seed": "5",
        "common.log_file": f"{save_dir}/log.jsonl", "checkpoint.save_dir": str(save_dir),
        "checkpoint.save_interval": "1000"})
    assert train.main(["--config", RECIPE, "--device", "cpu", *ov]) == 0
    lines = [json.loads(x) for x in (save_dir / "log.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if x["tag"] == "train_inner"] == [1, 2, 3]
    valid = [x for x in lines if x["tag"] == "valid"]
    assert len(valid) == 1 and (save_dir / "checkpoint_best.npz").exists()
    best = str(save_dir / "checkpoint_best.npz")
    outs = {}
    for name, cli, extra in (("port", evaluate, ["--device", "cpu"]),
                             ("jax", jax_evaluate, ["model.encoder.attn_impl=xla"])):
        out = save_dir / f"{name}.json"
        assert cli.main(["--config", RECIPE, "--path", best, "--output", str(out),
                         *extra, *ov]) == 0
        outs[name] = json.loads(out.read_text())
    capsys.readouterr()
    keys = [k for k in outs["jax"] if not k.startswith("eval_")]
    assert "ap" in keys and "ap_mask" in keys
    for key in keys:
        assert abs(outs["port"][key] - outs["jax"][key]) <= AP_TOL, key
        assert abs(outs["port"][key] - valid[0][key]) <= AP_TOL, key
    assert outs["port"]["eval_compiled_programs"] == 0


def test_pt_restore_gives_the_trunk_and_the_init_heads(corpus, tmp_path):
    """cli.train's load_weights on a fairseq .pt of the det trunk (vision
    naming, pretrain bucket 16): the trunk as load_pretrained reads it, the
    pyramid and heads as init_detector_ draws them from common.seed."""
    cfg = load_config(RECIPE, overrides(corpus, **{"common.seed": "9"}))
    sd = _fake_vision_sd(np.random.RandomState(2), bucket=16)
    path = tmp_path / "one-peace.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    det = build_task(cfg.task, cfg).build_model(cfg, device="cpu")
    train.load_weights(cfg, det, "cpu", str(path))
    init = init_detector_(build_task(cfg.task, cfg).build_model(cfg, device="cpu"),
                          torch.Generator().manual_seed(9))
    trunk = init_detector_(build_task(cfg.task, cfg).build_model(cfg, device="cpu"),
                           torch.Generator().manual_seed(1)).load_pretrained(str(path))
    state = det.state_dict()
    for key, value in state.items():
        want = trunk.state_dict()[key] if key.startswith("backbone.") else init.state_dict()[key]
        assert torch.equal(value, want), key
    assert not torch.equal(state["backbone.layers.0.self_attn.q_proj.weight"],
                           init.state_dict()["backbone.layers.0.self_attn.q_proj.weight"])
    assert torch.equal(state["backbone.layers.1.self_attn.q_proj.weight"],
                       torch.from_numpy(sd["encoder.layers.1.self_attn.q_proj.weight"]))
