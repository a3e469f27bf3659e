"""The detection training path's pieces around the losses, at toy size:
drop path one draw per image on the trunk's 4-D maps (where the JAX
package's (B, 1, 1) mask does not fit), remat on and off with drop path on,
the detector's layer ids, scales and decay mask against the JAX optimizer's
trees, ``DetectionCriterion``'s deterministic mode, ``CocoDetectionTask``
on the detection recipe, a few ``Trainer`` steps, and every public entry
point's device default."""

import inspect

import jax
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.optim.adamw import decay_mask as jax_decay_mask
from one_peace_tpu.optim.adamw import layer_decay_scales as jax_layer_decay_scales
from one_peace_tpu.vision.zoo import OnePeaceDetector as JaxDetector
from one_peace_tpu_torch import hub
from one_peace_tpu_torch.cli import embed
from one_peace_tpu_torch.core.config import FrameworkConfig, load_config
from one_peace_tpu_torch.criterions import DetectionCriterion, build_criterion
from one_peace_tpu_torch.metrics import DetectionAP
from one_peace_tpu_torch.models.components import drop_path
from one_peace_tpu_torch.models.one_peace import OnePeaceRetrievalModel
from one_peace_tpu_torch.optim.adamw import decay_mask, layer_decay_scales, layer_id_for_path
from one_peace_tpu_torch.tasks.vision_tasks import CocoDetectionTask
from one_peace_tpu_torch.trainer import Trainer
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

GEOMETRY = dict(num_classes=4, image_size=64, fpn_channels=16, embed_dim=32, ffn_embed_dim=64,
                heads=4, layers=2, pretrain_bucket_size=4, window_size=2, global_period=2)
RECIPE = "recipes/detection/cascade_mask_rcnn_1024.yaml"


def _detector(proposer="rpn", seed=0, **kw):
    det = OnePeaceDetector(proposer=proposer, device="cpu", **{**GEOMETRY, **kw})
    return fill_random_(det, torch.Generator().manual_seed(seed))


def _batch(seed=1, b=2, m=3, size=64, stride=4):
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


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (4, 4, 4, 8), (3, 5, 7)])
def test_drop_path_one_draw_per_leading_index(shape):
    """On (B, h, w, C) maps, also with B == h, each image is kept whole
    (scaled by 1 / keep) or dropped whole; on (B, L, D) the mask is drawn
    exactly as the (B, 1, 1) draw of the retrieval path."""
    x = torch.rand(shape) + 0.5
    rate = 0.5
    y = drop_path(x, rate, False, torch.Generator().manual_seed(3))
    keep = torch.rand((shape[0],) + (1,) * (len(shape) - 1),
                      generator=torch.Generator().manual_seed(3)) < 0.5
    want = torch.where(keep, x / 0.5, torch.zeros(()))
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    ratio = (y / x).reshape(shape[0], -1)
    assert torch.all(ratio == ratio[:, :1])  # one value per image
    assert drop_path(x, rate, True, torch.Generator()) is x


def test_trunk_drop_path_is_per_image_and_seeded():
    """The trunk's training path: different images draw different masks, the
    same generator seed gives the same output, deterministic or no
    generator is the serving path."""
    det = _detector(drop_path_rate=0.9, checkpoint_activations=False)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        serve = det.backbone(x)
        a = det.backbone(x, deterministic=False, generator=torch.Generator().manual_seed(1))
        b = det.backbone(x, deterministic=False, generator=torch.Generator().manual_seed(1))
        assert torch.equal(det.backbone(x, deterministic=True,
                                        generator=torch.Generator().manual_seed(1)), serve)
        assert torch.equal(det.backbone(x, deterministic=False), serve)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, serve)
    np.testing.assert_allclose(det.backbone.dpr, np.linspace(0, 0.9, 2, dtype=np.float32))


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_remat_on_and_off_give_equal_gradients(attn_impl):
    """Per-layer remat through torch.utils.checkpoint, drop path 0.5 on: the
    recompute draws the same masks, so the gradients equal those without
    remat, also on bf16 copies swapped in by functional_call."""
    grads = {}
    for remat in (False, True):
        det = _detector(drop_path_rate=0.5, checkpoint_activations=remat, attn_impl=attn_impl)
        names, masters = zip(*det.backbone.named_parameters())
        for p in masters:
            p.requires_grad_(True)
        x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32))
        copies = {n: p.bfloat16() for n, p in zip(names, masters)}
        out = torch.func.functional_call(
            det.backbone, copies, (x,),
            dict(deterministic=False, generator=torch.Generator().manual_seed(2)))
        loss = out.float().square().mean()
        grads[remat] = torch.autograd.grad(loss, masters)
    for a, b in zip(grads[False], grads[True]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("proposer", ["rpn", "fcos"])
def test_layer_ids_scales_and_decay_mask_match_jax(proposer):
    """Layer ids (image adapter 0, trunk layer i i+1, the rest L+1), the
    layer-decay scales and the decay mask against the JAX optimizer's trees
    on the JAX detector's parameters, carried by params_from_jax."""
    layers = GEOMETRY["layers"]
    jdet = JaxDetector(proposer=proposer, **GEOMETRY)
    jparams = jdet.init(jax.random.PRNGKey(0))
    det = _detector(proposer)
    named = list(det.named_parameters())
    mask = decay_mask(named)
    # the JAX mask has one bool per stacked leaf: spread it over the leaf
    want_mask = params_from_jax(jax.tree.map(lambda m, p: np.broadcast_to(m, p.shape),
                                             jax_decay_mask(jparams), jparams))
    scales = layer_decay_scales(named, layers, 0.9)
    want_scales = params_from_jax(jax.tree.map(
        np.asarray, jax_layer_decay_scales(jparams, layers, 0.9)))
    assert set(mask) == set(want_mask) == set(scales) == set(want_scales)
    for name, _ in named:
        assert mask[name] == bool(want_mask[name].all()) == bool(want_mask[name].any()), name
        values = np.unique(want_scales[name].numpy())
        assert len(values) == 1, name
        np.testing.assert_allclose(scales[name], values[0], rtol=1e-6, err_msg=name)
    assert layer_id_for_path("backbone.image_adapter.pos_embed", 40) == 0
    assert layer_id_for_path("backbone.layers.7.self_attn.q_proj.weight", 40) == 8
    assert layer_id_for_path("backbone.rel_pos_table", 40) == 41
    assert layer_id_for_path("fpn.scale_4_0.up1.weight", 40) == 41
    assert layer_id_for_path("box_head.stages.0.fc1.weight", 40) == 41


def test_criterion_deterministic_mode():
    """deterministic=True: no drop path, no jitter, the RPN subsample from a
    fixed seed, so a validation loss is computable (the JAX criterion raises
    there) and repeats; without a generator and not deterministic, the
    subsample sampler raises as in JAX; the mask stride comes from the
    shapes."""
    det = _detector(drop_path_rate=0.5)
    crit = DetectionCriterion(FrameworkConfig().criterion)
    assert crit.rpn_sampler == "subsample"
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    with torch.no_grad():
        a, ma = crit(det, batch, generator=torch.Generator().manual_seed(1), deterministic=True)
        b, _ = crit(det, batch, deterministic=True)
        assert float(a) == float(b) and np.isfinite(float(a)) and "mask_loss" in ma
        c, _ = crit(det, batch, generator=torch.Generator().manual_seed(1))
        d, _ = crit(det, batch, generator=torch.Generator().manual_seed(1))
        assert float(c) == float(d) and float(c) != float(a)
        with pytest.raises(ValueError):
            crit(det, batch)


def test_task_builds_the_recipe_detector():
    """The detection recipe through load_config: CocoDetectionTask builds the
    detector its task and encoder sections describe (cut to 4 layers and a
    narrow width here), names detection_criterion, and scores the recipe's
    80 classes with DetectionAP, compiling nothing; without an annotation
    file its dataset does not load."""
    cfg = load_config(RECIPE, ["model.encoder.layers=4", "model.encoder.embed_dim=32",
                               "model.encoder.ffn_embed_dim=64", "model.encoder.attention_heads=4",
                               "task.image_size=64", "task.window_size=2"])
    det = CocoDetectionTask.build_model(cfg, device="cpu")
    bb = det.backbone
    assert (det.proposer_kind, det.num_classes, det.mask_head is not None) == ("rpn", 80, True)
    assert (len(bb.layers), bb.window_size, bb.global_period, bb.checkpoint_activations,
            bb.attn_impl) == (4, 2, 4, True, "pallas")
    np.testing.assert_allclose(bb.dpr, np.linspace(0, 0.6, 4, dtype=np.float32))
    cfg.criterion._name = cfg.criterion._name or CocoDetectionTask.criterion_name
    assert isinstance(build_criterion(cfg.criterion), DetectionCriterion)
    task = CocoDetectionTask(cfg.task, cfg)
    assert isinstance(task.metric, DetectionAP) and task.metric.num_classes == 80
    assert task.eval_compiles == 0
    with pytest.raises(FileNotFoundError):
        task.load_dataset("train")


@pytest.mark.parametrize("proposer", ["rpn", "fcos"])
def test_trainer_steps_lower_the_loss(proposer):
    """Trainer.train_step on the toy detector with remat and drop path on:
    AdamW with layer decay and clipping, fp32 masters, the batch keys of
    vision_collate (uint8 masks at stride 4); on a fixed batch with the same
    generator state every step, the loss falls."""
    cfg = FrameworkConfig()
    cfg.model.encoder.layers = GEOMETRY["layers"]
    cfg.criterion._name = "detection_criterion"
    cfg.optimization.lr, cfg.optimization.clip_norm = 1e-3, 1.0
    cfg.optimization.layer_decay = 0.9
    cfg.lr_scheduler.warmup_updates = 0
    det = _detector(proposer, drop_path_rate=0.3, checkpoint_activations=True)
    trainer = Trainer(cfg, det, build_criterion(cfg.criterion), total_updates=10)
    batch = _batch(5)
    state = trainer.generator.get_state()
    losses = []
    for _ in range(4):
        trainer.generator.set_state(state)
        metrics = trainer.train_step(batch)
        assert metrics["skipped"] == 0.0 and np.isfinite(metrics["gnorm"])
        losses.append(metrics["loss"])
    assert losses[-1] < losses[0], losses
    assert trainer.step == 4


def test_entry_points_default_to_the_card():
    """Every public entry point builds on cuda unless the caller asks for
    another device."""
    from one_peace_tpu_torch.cli.train import build_model_for_task
    from one_peace_tpu_torch.models.pretrain import OnePeacePretrainModel
    from one_peace_tpu_torch.tasks.vision_tasks import Ade20kSegTask
    from one_peace_tpu_torch.vision.zoo import OnePeaceMask2FormerSegmenter, OnePeaceSegmenter

    for fn in (OnePeaceRetrievalModel.__init__, OnePeaceDetector.__init__, hub.from_pretrained,
               CocoDetectionTask.build_model, OnePeacePretrainModel.__init__,
               build_model_for_task, OnePeaceSegmenter.__init__,
               OnePeaceMask2FormerSegmenter.__init__, Ade20kSegTask.build_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn

    seen = {}

    def fake_from_pretrained(path, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hub, "from_pretrained", fake_from_pretrained)
        with pytest.raises(RuntimeError, match="stop"):
            embed.main(["--path", "model.pt", "--output", "out.npz"])
    assert seen["device"] == "cuda"
