"""Detection fine-tuning in the port against the JAX package, at toy size
(D 32, F 64, 4 heads, 2 layers, 64 px, window 2, a global layer every 2nd,
16 pyramid channels, 4 classes; non-zero shared and decomposed rel-pos
tables): RoIAlign's gradients to the features, ``rpn_loss`` (balanced,
and the 256-anchor subsample with JAX's
random numbers injected), the sampler's counts, ``cascade_box_loss``,
``fcos_loss`` and ``mask_loss``, each with its gradients; the whole
``detector_training_loss`` for the RPN and FCOS proposers, with masks, on
both ``attn_impl`` arms, against ``jax.value_and_grad`` (drop path 0,
deterministic, no jitter): the loss at 1e-5, all the gradients together at
1e-4 and each parameter's at 1e-3 (relative L2).  Through the whole trunk the
two packages' features differ by ~1e-6; a ReLU unit of the heads whose input
lies that close to 0 flips, and moves one parameter's gradient (the mask
head's first conv on this batch) by ~5e-4 while the rest agree to ~1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.vision import det_train as jdt
from one_peace_tpu.vision import rpn as jrpn
from one_peace_tpu.vision.cascade_rcnn import cascade_box_loss as jax_cascade_box_loss
from one_peace_tpu.vision.roi_align import multi_level_roi_align as jax_multi_level_roi_align
from one_peace_tpu.vision.zoo import OnePeaceDetector as JaxDetector
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.vision import det_train as tdt
from one_peace_tpu_torch.vision import rpn as trpn
from one_peace_tpu_torch.vision.cascade_rcnn import cascade_box_loss
from one_peace_tpu_torch.vision.roi_align import multi_level_roi_align
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

GEOMETRY = dict(num_classes=4, image_size=64, fpn_channels=16, embed_dim=32, ffn_embed_dim=64,
                heads=4, layers=2, pretrain_bucket_size=4, window_size=2, global_period=2)
SIZE, M, MASK_STRIDE = 64, 3, 4
LEVELS = ((16, 16), (8, 8), (4, 4), (2, 2))  # p4 ... p32 at 64 px


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=1e-4, name=""):
    """Within tol of the reference's largest magnitude (and tol relative)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-3),
                               err_msg=name)


def _jax_detector(proposer, attn_impl="xla", seed=0):
    """The JAX toy detector and its parameters, with non-zero rel-pos tables."""
    det = JaxDetector(proposer=proposer, checkpoint_activations=False, attn_impl=attn_impl,
                      **GEOMETRY)
    params = jax.tree.map(np.asarray, det.init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    bb = params["backbone"]
    bb["rel_pos_table"] = (rs.randn(*bb["rel_pos_table"].shape) * 0.5).astype(np.float32)
    for group in ("win_layers", "glob_layers"):
        attn = bb[group]["self_attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            attn[name] = (rs.randn(*attn[name].shape) * 0.3).astype(np.float32)
    return det, params


def _port_detector(proposer, params, attn_impl="xla", **kw):
    det = OnePeaceDetector(proposer=proposer, device="cpu", attn_impl=attn_impl,
                           checkpoint_activations=False, **GEOMETRY, **kw)
    det.load_state_dict(params_from_jax(params), strict=True)
    for p in det.parameters():
        p.requires_grad_(True)
    return det


def _batch(seed=1, b=2):
    """Images, GT boxes (one padded slot), labels, valid flags and box-shaped
    uint8 masks at stride 4."""
    rs = np.random.RandomState(seed)
    imgs = rs.randn(b, 3, SIZE, SIZE).astype(np.float32)
    x0, y0 = rs.uniform(0, SIZE / 2, (b, M)), rs.uniform(0, SIZE / 2, (b, M))
    w, h = rs.uniform(8, SIZE / 2, (b, M)), rs.uniform(8, SIZE / 2, (b, M))
    boxes = np.stack([x0, y0, np.minimum(x0 + w, SIZE - 1), np.minimum(y0 + h, SIZE - 1)],
                     -1).astype(np.float32)
    labels = rs.randint(0, GEOMETRY["num_classes"], (b, M))
    valid = np.ones((b, M), bool)
    valid[1, -1] = False
    masks = np.zeros((b, M, SIZE // MASK_STRIDE, SIZE // MASK_STRIDE), np.uint8)
    for i in range(b):
        for j in range(M):
            c0, r0, c1, r1 = (boxes[i, j] / MASK_STRIDE).astype(int)
            masks[i, j, r0:r1 + 1, c0:c1 + 1] = 1
    return imgs, boxes, labels, valid, masks


def _feats(seed=2, b=2, c=16):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in LEVELS]


@pytest.fixture(scope="module")
def rpn_pair():
    return _jax_detector("rpn")


@pytest.fixture(scope="module")
def fcos_pair():
    return _jax_detector("fcos")


def _grads_match(port_module, port_prefix, jax_grads, tol=1e-4):
    """Every parameter gradient of ``port_module`` against the JAX gradient
    tree carried by params_from_jax."""
    want = params_from_jax(jax.tree.map(np.asarray, jax_grads))
    n = 0
    for name, p in port_module.named_parameters():
        key = f"{port_prefix}{name}"
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, want[key], tol, key)
        n += 1
    assert n == len(want), (n, len(want))


def test_roi_align_carries_gradients_to_the_features():
    """The multi-level RoIAlign (boxes over the border and a zero-area pad
    included): the gradient of a weighted sum with respect to every pyramid
    level against jax.grad of the JAX RoIAlign; the pooled level's is
    non-zero."""
    feats = _feats(14)
    _, boxes, _, _, _ = _batch(15)
    rois = np.concatenate([boxes.reshape(-1, 4), [[-6.0, 50.0, 20.0, 70.0], [0, 0, 0, 0]]])
    bidx = np.array([0, 0, 0, 1, 1, 1, 0, 1], np.int32)
    w = np.random.RandomState(16).randn(len(rois), 7, 7, 16).astype(np.float32)
    strides = [4, 8, 16, 32]

    def jloss(fs):
        out = jax_multi_level_roi_align(fs, strides, jnp.asarray(rois), jnp.asarray(bidx),
                                        output_size=7)
        return jnp.sum(out * w)

    want = jax.grad(jloss)([jnp.asarray(f) for f in feats])
    tfeats = [_t(f).requires_grad_() for f in feats]
    out = multi_level_roi_align(tfeats, strides, _t(rois).float(), _t(bidx), output_size=7)
    (out * _t(w)).sum().backward()
    assert float(tfeats[0].grad.abs().sum()) > 0  # these small boxes pool from p4
    for tf, jg in zip(tfeats, want):
        _close(tf.grad, jg, name="roi_align features")


def test_rpn_loss_balanced_matches_jax(rpn_pair):
    """The balanced sampler: loss, metrics, and the gradients of the head's
    parameters and of the features."""
    jdet, params = rpn_pair
    tdet = _port_detector("rpn", params)
    feats = _feats()
    _, boxes, labels, valid, _ = _batch()

    def jloss(p, f):
        return jrpn.rpn_loss(jdet.proposer, p, f, jnp.asarray(boxes), jnp.asarray(labels),
                             jnp.asarray(valid), sampler="balanced")

    (want, jm), (jgp, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params["proposer"], [jnp.asarray(f) for f in feats])
    tfeats = [_t(f).requires_grad_() for f in feats]
    got, m = trpn.rpn_loss(tdet.proposer, tfeats, _t(boxes), _t(labels), _t(valid),
                           sampler="balanced")
    got.backward()
    _close(got, want)
    for key in ("rpn_obj", "rpn_box", "rpn_pos"):
        _close(m[key], jm[key], name=key)
    _grads_match(tdet.proposer, "", jgp)
    for tf, jg in zip(tfeats, jgf):
        _close(tf.grad, jg, name="features")


def test_rpn_loss_subsample_with_jax_draws(rpn_pair, monkeypatch):
    """The 256-anchor subsample: with JAX's uniforms for each image injected
    (the two generators differ), the port selects the same anchors and gives
    the same loss."""
    jdet, params = rpn_pair
    tdet = _port_detector("rpn", params)
    feats = _feats(3)
    _, boxes, labels, valid, _ = _batch(4)
    rng = jax.random.PRNGKey(7)
    want, _ = jrpn.rpn_loss(jdet.proposer, params["proposer"], [jnp.asarray(f) for f in feats],
                            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
                            sampler="subsample", rng=rng)
    n = 3 * sum(h * w for h, w in LEVELS)
    draws = []
    for key in jax.random.split(rng, 2):
        kp, kn = jax.random.split(key)
        draws.append(torch.stack([_t(jax.random.uniform(kp, (n,))),
                                  _t(jax.random.uniform(kn, (n,)))]))
    monkeypatch.setattr(trpn, "_uniforms", lambda gen, n_, device: draws.pop(0))
    got, _ = trpn.rpn_loss(tdet.proposer, [_t(f) for f in feats], _t(boxes), _t(labels),
                           _t(valid), sampler="subsample", generator=torch.Generator())
    assert not draws
    _close(got, want)
    with pytest.raises(ValueError):
        trpn.rpn_loss(tdet.proposer, [_t(f) for f in feats], _t(boxes), _t(labels), _t(valid))


@pytest.mark.parametrize("n_pos,n_neg", [(40, 5000), (300, 5000), (10, 100), (0, 0)])
def test_sample_weights_counts(n_pos, n_neg):
    """At most 128 positives, 256 in all (when there are enough), chosen only
    from the masks, from the generator; the same seed gives the same sample."""
    n = 6000
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(n_pos))
    pos = torch.zeros(n, dtype=torch.bool)
    neg = torch.zeros(n, dtype=torch.bool)
    pos[perm[:n_pos]] = True
    neg[perm[n_pos:n_pos + n_neg]] = True
    wp, wn = trpn._sample_weights(pos, neg, torch.Generator().manual_seed(1))
    sel_p, sel_n = wp.bool(), wn.bool()
    assert int(sel_p.sum()) == min(n_pos, 128)
    assert int(sel_n.sum()) == min(n_neg, 256 - min(n_pos, 128))
    assert not (sel_p & ~pos).any() and not (sel_n & ~neg).any()
    again = trpn._sample_weights(pos, neg, torch.Generator().manual_seed(1))
    assert torch.equal(again[0], wp) and torch.equal(again[1], wn)


def test_cascade_box_loss_matches_jax(rpn_pair):
    """The three stages on jittered GT boxes over the pyramid, one image:
    loss, metrics and the head's gradients."""
    jdet, params = rpn_pair
    tdet = _port_detector("rpn", params)
    feats = [f[:1] for f in _feats(5)]
    _, boxes, labels, valid, _ = _batch(6)
    rs = np.random.RandomState(8)
    props = boxes[1] + rs.uniform(-2, 2, boxes[1].shape).astype(np.float32)
    args = (props, np.zeros(M, np.int32), boxes[1], labels[1], valid[1])

    def jloss(p):
        return jax_cascade_box_loss(jdet.box_head, p, tuple(jnp.asarray(f) for f in feats),
                                    *map(jnp.asarray, args), prop_valid=jnp.asarray(valid[1]))

    (want, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params["box_head"])
    got, m = cascade_box_loss(tdet.box_head, [_t(f) for f in feats], *map(_t, args),
                              prop_valid=_t(valid[1]))
    got.backward()
    _close(got, want)
    for key in jm:
        _close(m[key], jm[key], name=key)
    _grads_match(tdet.box_head, "", jg)


def test_fcos_loss_matches_jax(fcos_pair):
    jdet, params = fcos_pair
    tdet = _port_detector("fcos", params)
    feats = _feats(9)
    _, boxes, labels, valid, _ = _batch(10)

    def jloss(p):
        return jdt.fcos_loss(jdet.proposer, p, [jnp.asarray(f) for f in feats],
                             jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))

    (want, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params["proposer"])
    got, m = tdt.fcos_loss(tdet.proposer, [_t(f) for f in feats], _t(boxes), _t(labels),
                           _t(valid))
    got.backward()
    _close(got, want)
    for key in jm:
        _close(m[key], jm[key], name=key)
    _grads_match(tdet.proposer, "", jg)


def test_mask_loss_matches_jax(rpn_pair):
    """The GT-class mask BCE against the stride-4 GT masks cropped by the
    port's roi_align, padded slots masked out."""
    jdet, params = rpn_pair
    tdet = _port_detector("rpn", params)
    feats = _feats(11)
    _, boxes, labels, valid, masks = _batch(12)
    args = (boxes.reshape(-1, 4), np.repeat(np.arange(2, dtype=np.int32), M),
            masks.reshape(-1, *masks.shape[2:]), labels.reshape(-1), valid.reshape(-1))

    def jloss(p):
        return jdt.mask_loss(jdet.mask_head, p, tuple(jnp.asarray(f) for f in feats),
                             *map(jnp.asarray, args), mask_stride=MASK_STRIDE)

    want, jg = jax.jit(jax.value_and_grad(jloss))(params["mask_head"])
    got = tdt.mask_loss(tdet.mask_head, [_t(f) for f in feats], *map(_t, args),
                        mask_stride=MASK_STRIDE)
    got.backward()
    _close(got, want)
    _grads_match(tdet.mask_head, "", jg)


@pytest.mark.parametrize("proposer,attn_impl", [("rpn", "xla"), ("rpn", "pallas"),
                                                ("fcos", "xla"), ("fcos", "pallas")])
def test_detector_training_loss_matches_jax(proposer, attn_impl, monkeypatch, rpn_pair,
                                            fcos_pair):
    """The whole objective with masks, deterministic, no jitter, drop path 0,
    the balanced RPN sampler: loss, metrics and every parameter's gradient
    against jax.value_and_grad (the "pallas" arm runs the JAX kernels
    interpreted and the port's Function on its plain versions)."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    _, params = rpn_pair if proposer == "rpn" else fcos_pair
    jdet = JaxDetector(proposer=proposer, checkpoint_activations=False, attn_impl=attn_impl,
                       **GEOMETRY)
    tdet = _port_detector(proposer, params, attn_impl)
    imgs, boxes, labels, valid, masks = _batch(13)

    def jloss(p):
        return jdt.detector_training_loss(jdet, p, *map(jnp.asarray, (imgs, boxes, labels, valid,
                                                                     masks)),
                                          mask_stride=MASK_STRIDE, rpn_sampler="balanced")

    (want, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    got, m = tdt.detector_training_loss(tdet, *map(_t, (imgs, boxes, labels, valid, masks)),
                                        mask_stride=MASK_STRIDE, rpn_sampler="balanced",
                                        deterministic=True)
    got.backward()
    _close(got, want, 1e-5)
    assert set(m) == set(jm)
    for key in jm:
        _close(m[key], jm[key], name=key)
    ref = params_from_jax(jax.tree.map(np.asarray, jg))
    names = [name for name, _ in tdet.named_parameters()]
    assert set(names) == set(ref)
    grads = [p.grad.double().flatten() for _, p in tdet.named_parameters()]
    wants = [_t(ref[name]).double().flatten() for name in names]
    for name, g, w in zip(names, grads, wants):
        assert (g - w).norm() <= 1e-3 * w.norm() + 1e-12, name
    g, w = torch.cat(grads), torch.cat(wants)
    assert (g - w).norm() <= 1e-4 * w.norm()
