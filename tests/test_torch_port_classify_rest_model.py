"""The rest of classification's losses, criterions and heads against the
JAX package's, on CPU at toy size (held at 1e-4 unless stated).

``box_giou``, ``refcoco_loss`` and ``hinge_loss`` in value and gradient
against ``jax.grad``, invalid boxes and ties included.  Each task's
criterion through the tiny classify model built with the task's head,
loss and every gradient against ``jax.value_and_grad`` of the JAX
criterion on a JAX ``OnePeaceClassifyModel`` with the same head kwargs and
weights (one seeded fairseq state dict through each package's
``convert_classify_model``): NLVR2's two images through ``ClassifyCriterion``,
RefCOCO's 4 outputs through ``RefCOCOCriterion``, AQA's 4 choices through
``HingeCriterion`` and FSD50K's multi-hot BCE.  The two-image head's
``fc1`` drawn as the JAX init draws it, and a checkpoint whose head
differs from the task's raising, naming the entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

import torch_fixture as tf
from helpers import tiny_model_config
from one_peace_tpu.core.config import CriterionConfig
from one_peace_tpu.criterions import criterions as jax_criterions
from one_peace_tpu.criterions import losses as jax_losses
from one_peace_tpu.models import one_peace as jax_heads
from one_peace_tpu.models.adapters.audio import conv_output_length
from one_peace_tpu.models.classify import OnePeaceClassifyModel as JaxModel
from one_peace_tpu.utils import checkpoint_convert as jax_convert
from one_peace_tpu_torch import hub
from one_peace_tpu_torch.criterions import (ClassifyCriterion, HingeCriterion, RefCOCOCriterion,
                                            losses)
from one_peace_tpu_torch.models.classify import OnePeaceClassifyModel, check_head
from one_peace_tpu_torch.utils import checkpoint_convert as port_convert
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_

TOL = 1e-4


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _boxes(rng, n, invalid=0):
    lo = rng.rand(n, 2) * 0.5
    boxes = np.concatenate([lo, lo + 0.05 + rng.rand(n, 2) * 0.45], 1).astype(np.float32)
    boxes[:invalid, 2:] = boxes[:invalid, :2] - 0.01  # x1 < x0, y1 < y0
    return boxes


def test_box_giou_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 9, invalid=2), _boxes(rng, 9)
    b[3] = a[3]  # identical boxes
    b[4] = [0.9, 0.9, 0.95, 0.97]  # disjoint
    a[4] = [0.0, 0.0, 0.1, 0.2]
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    got = losses.box_giou(ta, tb)
    _close(got, jax_losses.box_giou(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    w = rng.randn(9).astype(np.float32)
    (got * torch.as_tensor(w)).sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(jax_losses.box_giou(x, y) * w), (0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    _close(ta.grad, ga, 1e-5)
    _close(tb.grad, gb, 1e-5)


def test_refcoco_loss_matches_jax():
    """L1 over nsentences plus the mean 1 - GIoU over the valid boxes (two
    of eight predictions inverted, left out of the GIoU term)."""
    rng = np.random.RandomState(1)
    pred, target = _boxes(rng, 8, invalid=2), _boxes(rng, 8)
    p = torch.tensor(pred, requires_grad=True)
    loss = losses.refcoco_loss(p, torch.as_tensor(target), 8)
    jloss, jgrad = jax.value_and_grad(jax_losses.refcoco_loss)(jnp.asarray(pred),
                                                                jnp.asarray(target), 8)
    _close(loss, jloss, 1e-6)
    loss.backward()
    _close(p.grad, jgrad, 1e-6)
    all_invalid = torch.as_tensor(_boxes(rng, 3, invalid=3))
    _close(losses.refcoco_loss(all_invalid, torch.as_tensor(target[:3]), 3),
           jax_losses.refcoco_loss(jnp.asarray(all_invalid.numpy()), jnp.asarray(target[:3]), 3),
           1e-6)


def test_hinge_loss_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 4).astype(np.float32)
    logits[2] = [0.5, 0.5, -1.0, 2.0]  # a tied pair
    targets = rng.randint(0, 4, 6)
    t = torch.tensor(logits, requires_grad=True)
    loss, ncorrect = losses.hinge_loss(t, torch.as_tensor(targets), margin=1.0)
    (jloss, jn), jgrad = jax.value_and_grad(
        lambda x: jax_losses.hinge_loss(x, jnp.asarray(targets), 1.0), has_aux=True)(
        jnp.asarray(logits))
    _close(loss, jloss, 1e-6)
    assert int(ncorrect) == int(jn)
    loss.backward()
    _close(t.grad, jgrad, 1e-6)


HEADS = {  # task: (head type, num_classes, head kwargs)
    "nlvr2": ("vl", 2, dict(use_two_images=True)),
    "refcoco": ("vl", 4, {}),
    "aqa": ("al", 1, {}),
    "fsd50k": ("audio", 5, {}),
}


def _pair(task, seed=0):
    """(JAX model, its params, port model) on one fairseq state dict with
    the task's head."""
    head_type, classes, kw = HEADS[task]
    cfg = tiny_model_config(head_type=head_type)
    sd = tf.make_random_state_dict(cfg, seed=seed)
    tf.add_classify_head_state(sd, cfg, classes)
    if kw.get("use_two_images"):  # fc1 reads both images' pooled features
        d = cfg.encoder.embed_dim
        sd["classify_head.classifier.0.weight"] = (
            np.random.RandomState(seed + 20).randn(d, 2 * d).astype(np.float32) * 0.05)
    params = jax_convert.to_jax(jax_convert.convert_classify_model(dict(sd), cfg))
    model = OnePeaceClassifyModel(cfg, classes, device="cpu", **kw)
    state = port_convert.convert_classify_model(dict(sd), cfg)
    wanted = model.state_dict().keys()
    model.load_state_dict({k: v for k, v in state.items() if k in wanted}, strict=True)
    return cfg, JaxModel(cfg, classes, **kw), params, model


def _batch(cfg, task):
    """(flat port batch, JAX batch) for the task's criterion."""
    rng = np.random.RandomState(3)
    tokens = np.array([[5, 6, 7, 1, 1], [8, 9, 10, 11, 12], [13, 14, 1, 1, 1]])
    spec = cfg.encoder.audio_adapter.feature_encoder_spec
    if task in ("nlvr2", "refcoco"):
        net = {"src_tokens": tokens, "src_images": rng.randn(3, 3, 32, 32).astype(np.float32)}
        if task == "nlvr2":
            net["src_images_2"] = rng.randn(3, 3, 32, 32).astype(np.float32)
            target = np.array([1, 0, 1])
        else:
            lo = rng.rand(3, 2) * 0.5
            target = np.concatenate([lo, lo + 0.1 + rng.rand(3, 2) * 0.4], 1).astype(np.float32)
        return {**net, "target": target}, {"net_input": net, "target": target}
    t = conv_output_length(100, spec)
    mask = np.zeros((2 if task == "aqa" else 3, t + 1), bool)
    mask[1, -4:] = True
    audios = rng.randn(mask.shape[0], 100).astype(np.float32)
    if task == "aqa":  # 2 questions x 4 choices: one token row per choice
        choices = rng.randint(5, 40, (8, 6))
        choices[[1, 6], 4:] = 1
        batch = {"src_tokens": choices, "src_audios": audios, "audio_padding_masks": mask,
                 "target": np.array([3, 0])}
        return batch, dict(batch)
    target = (rng.rand(3, 5) < 0.4).astype(np.float32)
    net = {"src_audios": audios, "audio_padding_masks": mask}
    return {**net, "target": target}, {"net_input": net, "target": target}


def _criteria(task):
    ccfg = CriterionConfig(_name="", use_multi_label=task == "fsd50k", num_choices=4)
    if task == "refcoco":
        return RefCOCOCriterion(ccfg), jax_criterions.RefCOCOCriterion(ccfg)
    if task == "aqa":
        return HingeCriterion(ccfg), jax_criterions.HingeCriterion(ccfg)
    return ClassifyCriterion(ccfg), jax_criterions.ClassifyCriterion(ccfg)


@pytest.mark.parametrize("task", sorted(HEADS))
def test_criterion_gradients_match_jax(task):
    cfg, jmodel, params, model = _pair(task)
    batch, jbatch = _batch(cfg, task)
    criterion, jcriterion = _criteria(task)
    for p in model.parameters():
        p.requires_grad_(True)
    loss, metrics = criterion(model, {k: torch.as_tensor(v) for k, v in batch.items()},
                              deterministic=True)
    loss.backward()
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}

    def f(p):
        return jcriterion(jmodel, p, jax.tree.map(jnp.asarray, jbatch), deterministic=True)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    _close(loss, jloss, 1e-5)
    assert metrics.keys() == jmetrics.keys()
    for key in metrics:
        _close(metrics[key], jmetrics[key])
    assert got.keys() <= want.keys()
    num = sum(float((got[k].double() * torch.as_tensor(want[k]).double()).sum()) for k in got)
    den = np.sqrt(sum(float(got[k].double().norm() ** 2) for k in got)
                  * sum(float(torch.as_tensor(want[k]).double().norm() ** 2) for k in got))
    assert num / den > 1 - 1e-6
    for k in got:
        _close(got[k], want[k])
    if task == "nlvr2":
        assert got["classify_head.classifier.fc1.weight"].shape[1] == 2 * cfg.encoder.embed_dim


def test_two_image_fc1_drawn_as_the_jax_init():
    """``fill_random_`` draws the two-image head's fc1 Xavier-uniform over
    its 2d inputs, as ``ClassifyHead.init`` does: the same bound, and a
    spread within a few percent of the JAX draw's."""
    d = 64
    head = jax_heads.ClassifyHead(False, False, 0.0, d, 4, 1.0, 2, use_two_images=True)
    want = np.asarray(head.init(jax.random.PRNGKey(0))["classifier"]["fc1"]["w"])
    cfg = tiny_model_config(head_type="vl")
    cfg.encoder.embed_dim = d
    model = fill_random_(OnePeaceClassifyModel(cfg, 2, use_two_images=True, device="cpu"),
                         torch.Generator().manual_seed(0))
    got = model.classify_head.classifier.fc1.weight.detach().numpy().T
    bound = np.sqrt(6.0 / (3 * d))
    assert got.shape == want.shape == (2 * d, d)
    assert np.abs(got).max() <= bound and np.abs(want).max() <= bound + 1e-6
    assert abs(got.std() / want.std() - 1) < 0.05


def test_export_of_the_two_image_head_reads_back():
    """``model_to_jax`` -> ``params_from_jax`` carries the (d, 2d) fc1,
    and the JAX model on the exported tree gives the port's logits."""
    cfg, jmodel, _, model = _pair("nlvr2", seed=4)
    tree = model_to_jax(model)
    back = params_from_jax(tree)
    state = model.state_dict()
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
    batch, jbatch = _batch(cfg, "nlvr2")
    with torch.no_grad():
        got = model(**{k: torch.as_tensor(v) for k, v in batch.items() if k != "target"})
    want = jmodel(jax.tree.map(jnp.asarray, tree), **jax.tree.map(jnp.asarray, jbatch["net_input"]))
    _close(got, want)


def _head_pt(tmp_path, cfg, classes, d_in=None, **head):
    sd = tf.make_random_state_dict(cfg, seed=5)
    tf.add_classify_head_state(sd, cfg, classes, **head)
    if d_in:
        sd["classify_head.classifier.0.weight"] = np.zeros((cfg.encoder.embed_dim, d_in),
                                                           np.float32)
    path = tmp_path / "head.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return str(path)


def test_a_checkpoint_with_another_head_raises(tmp_path):
    """The hub and ``check_head`` refuse a head that differs from the one
    asked for, naming the entry: a one-image fc1 under NLVR2's two-image
    head, a 3-class head under 4 outputs, attention pooling the model lacks."""
    from chip_smoke import write_bpe_dir

    bpe = write_bpe_dir(tmp_path / "bpe")
    cfg = tiny_model_config(head_type="vl")
    kw = dict(model_type="one_peace_classify", bpe_dir=bpe, model_cfg=cfg, device="cpu")
    one_image = _head_pt(tmp_path, cfg, 2)
    with pytest.raises(ValueError, match=r"classify_head\.classifier\.fc1\.weight"):
        hub.from_pretrained(one_image, num_classes=2, classify_kwargs={"use_two_images": True},
                            **kw)
    three = _head_pt(tmp_path, cfg, 3, d_in=2 * cfg.encoder.embed_dim)
    with pytest.raises(ValueError, match=r"classify_head\.classifier\.fc2\.weight"):
        hub.from_pretrained(three, num_classes=4, classify_kwargs={"use_two_images": True}, **kw)
    pooled = _head_pt(tmp_path, cfg, 4, attn_pooling=True)
    with pytest.raises(ValueError, match=r"classify_head\.attn_pooling\."):
        hub.from_pretrained(pooled, num_classes=4, **kw)
    model = hub.from_pretrained(pooled, num_classes=4, classify_kwargs={"attn_pooling": True},
                                **kw).model
    check_head(model.state_dict(), model)  # its own state fits
