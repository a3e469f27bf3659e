"""The detection slice's building blocks against the JAX package: the SAME
conv and the transposed conv with asymmetric kernels, GroupNorm, max pool,
RoIAlign (boxes over the border, zero-area pads) and the multi-level
ROIPooler, the learned pyramid, the RPN and FCOS heads' maps, and the host
decode helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.models import components as jc
from one_peace_tpu.vision import adapter as jadapter
from one_peace_tpu.vision import cascade_rcnn as jcr
from one_peace_tpu.vision import det_backbone as jdb
from one_peace_tpu.vision import detection as jdet
from one_peace_tpu.vision import roi_align as jra
from one_peace_tpu.vision import rpn as jrpn
from one_peace_tpu_torch.models import components as tc
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.vision import cascade_rcnn as tcr
from one_peace_tpu_torch.vision import det_backbone as tdb
from one_peace_tpu_torch.vision import detection as tdet
from one_peace_tpu_torch.vision import roi_align as tra
from one_peace_tpu_torch.vision import rpn as trpn

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _load(module, tree):
    """The JAX tree into the port module (every parameter set)."""
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)), strict=True)
    return module


@pytest.mark.parametrize("k,s", [(2, 2), (3, 2), (3, 1), (4, 3), (1, 2)])
@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv_transpose_matches_lax(k, s, padding):
    """An asymmetric (k, k+1) HWIO kernel settles the no-flip mapping."""
    rs = np.random.RandomState(k * 10 + s)
    x = rs.randn(2, 5, 6, 3).astype(np.float32)
    w = rs.randn(k, k + 1, 3, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    want = jax.lax.conv_transpose(x, w, (s, s), padding,
                                  dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = tc.conv_transpose2d(_t(x), _t(w).permute(3, 2, 0, 1), _t(b), s, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (2, 1), (4, 3), (1, 1)])
def test_same_conv_matches_jax(k, s):
    rs = np.random.RandomState(k * 7 + s)
    x = rs.randn(2, 7, 6, 3).astype(np.float32)
    params = {"w": rs.randn(k, k + 1, 3, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    want = jc.conv2d(params, jnp.asarray(x), s, "SAME")
    got = tc.conv2d(_t(x), _t(params["w"]).permute(3, 2, 0, 1), _t(params["b"]), s, "SAME")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("channels", [64, 48, 20])
def test_group_norm_and_max_pool(channels):
    rs = np.random.RandomState(channels)
    x = (rs.randn(2, 5, 6, channels) * 3 + 1).astype(np.float32)
    scale, bias = rs.randn(channels).astype(np.float32), rs.randn(channels).astype(np.float32)
    want = jadapter.group_norm({"scale": scale, "bias": bias}, jnp.asarray(x))
    got = tc.group_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for window, stride in ((2, 2), (1, 2)):
        want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, window, window, 1),
                                     (1, stride, stride, 1), "VALID")
        np.testing.assert_array_equal(tc.max_pool(_t(x), window, stride).numpy(), np.asarray(want))


def _rois(rs, n, size):
    """Boxes inside, over every border, tiny, and zero-area pads."""
    x0 = rs.uniform(-20, size, n)
    y0 = rs.uniform(-20, size, n)
    boxes = np.stack([x0, y0, x0 + rs.uniform(1, size, n), y0 + rs.uniform(1, size, n)], 1)
    boxes[:3] = [[-30, -30, size + 30, size + 30], [size - 2, size - 2, size + 9, size + 5],
                 [3.2, 4.1, 3.3, 4.15]]
    boxes[-4:] = 0.0  # padded proposals
    return boxes.astype(np.float32)


@pytest.mark.parametrize("output_size,scale,ratio", [(7, 1 / 8, 2), (14, 1 / 4, 2), (3, 1.0, 1)])
def test_roi_align(output_size, scale, ratio):
    rs = np.random.RandomState(output_size)
    feats = rs.randn(2, 9, 11, 5).astype(np.float32)
    rois = _rois(rs, 24, 80)
    bidx = rs.randint(0, 2, 24).astype(np.int32)
    want = jax.jit(jra.roi_align, static_argnums=(3, 4, 5))(
        jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(bidx), output_size, scale, ratio)
    got = tra.roi_align(_t(feats), _t(rois), torch.from_numpy(bidx), output_size, scale, ratio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multi_level_roi_align():
    rs = np.random.RandomState(1)
    strides = (4, 8, 16, 32)
    feats = [rs.randn(2, 128 // s, 128 // s, 6).astype(np.float32) for s in strides]
    rois = _rois(rs, 40, 128)
    rois[3:10] *= 4  # large boxes reach the coarse levels
    bidx = rs.randint(0, 2, 40).astype(np.int32)
    want = jax.jit(jra.multi_level_roi_align, static_argnums=1)(
        [jnp.asarray(f) for f in feats], strides, jnp.asarray(rois), jnp.asarray(bidx))
    got = tra.multi_level_roi_align([_t(f) for f in feats], strides, _t(rois),
                                    torch.from_numpy(bidx))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pyramid_matches_jax():
    rs = np.random.RandomState(2)
    jfpn = jdb.SimpleFeaturePyramid(in_dim=32, out_channels=16)
    params = jfpn.init(jax.random.PRNGKey(0))
    f16 = rs.randn(2, 8, 8, 32).astype(np.float32)
    want = jax.jit(jfpn.__call__)(params, jnp.asarray(f16))
    tfpn = _load(tdb.SimpleFeaturePyramid(32, out_channels=16), params)
    got = tfpn(_t(f16))
    assert set(got) == set(want) == {"p4", "p8", "p16", "p32", "p64"}
    for key in want:
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), **TOL)


@pytest.mark.parametrize("kind", ["rpn", "fcos"])
def test_proposer_maps_and_decode(kind):
    rs = np.random.RandomState(3)
    strides = (4, 8, 16, 32)
    feats = [rs.randn(2, 64 // s, 64 // s, 16).astype(np.float32) for s in strides]
    if kind == "rpn":
        jhead, thead = jrpn.RPNHead(16, strides=strides), trpn.RPNHead(16, strides=strides)
    else:
        jhead = jdet.FCOSHead(16, num_classes=5, strides=strides)
        thead = tdet.FCOSHead(16, num_classes=5, strides=strides)
    params = jhead.init(jax.random.PRNGKey(1))
    _load(thead, params)
    want = jax.jit(jhead.__call__)(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = thead([_t(f) for f in feats])
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    dec_j = jhead.decode(want, score_thresh=0.0 if kind == "rpn" else 0.002, max_dets=50)
    dec_t = thead.decode(got, score_thresh=0.0 if kind == "rpn" else 0.002, max_dets=50)
    for a, b in zip(dec_t, dec_j):
        assert len(a["boxes"]) == len(b["boxes"]) > 0
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=1e-5, atol=1e-3)


def test_box_delta_transforms():
    rs = np.random.RandomState(4)
    boxes = np.abs(rs.randn(50, 4) * 30).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2] + 1
    deltas = (rs.randn(50, 4) * 3).astype(np.float32)  # some past the clamps
    np.testing.assert_allclose(trpn.apply_deltas(_t(boxes), _t(deltas)).numpy(),
                               np.asarray(jrpn.apply_deltas(jnp.asarray(boxes),
                                                            jnp.asarray(deltas))), **TOL)
    for weights in jcr.STAGE_DELTA_WEIGHTS:
        np.testing.assert_allclose(
            tcr.apply_deltas(_t(boxes), _t(deltas), weights).numpy(),
            np.asarray(jcr.apply_deltas(jnp.asarray(boxes), jnp.asarray(deltas), weights)), **TOL)
    np.testing.assert_array_equal(trpn.level_anchors(5, 7, 8, (0.5, 1.0, 2.0), 8.0),
                                  jrpn.level_anchors(5, 7, 8, (0.5, 1.0, 2.0), 8.0))


def test_nms_matches_jax():
    rs = np.random.RandomState(5)
    boxes = (rs.rand(300, 4) * 50).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rs.rand(300, 2).astype(np.float32) * 20 + 1
    boxes[:20] -= 60  # negative coordinates
    scores = rs.rand(300).astype(np.float32)
    labels = rs.randint(0, 4, 300)
    np.testing.assert_array_equal(tdet.nms(boxes, scores, 0.5), jdet.nms(boxes, scores, 0.5))
    np.testing.assert_array_equal(tdet.batched_nms(boxes, scores, labels),
                                  jdet.batched_nms(boxes, scores, labels))
    cls_scores = rs.rand(40, 6).astype(np.float32)
    want = jcr.CascadeBoxHead(16, 5).decode(cls_scores, boxes[:40], score_thresh=0.3,
                                            max_dets=20)
    got = tcr.CascadeBoxHead.decode(cls_scores, boxes[:40], score_thresh=0.3, max_dets=20)
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[key], want[key])
