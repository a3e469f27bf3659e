"""The port's detection trunk and ``OnePeaceDetector`` against the JAX
package at toy size (D 32, F 64, 4 heads, 4 layers, 128 px, window 4, a
global layer every 2nd, pretrain bucket 4, non-zero decomposed rel-pos
tables): the stride-16 map on both ``attn_impl`` arms (the Pallas arm
interpreted), the pyramid and proposer maps, the cascade on fixed
proposals, the mask logits (each to 1e-4), ``detect()`` end to end for the
RPN and FCOS proposers, ``load_pretrained`` against ``convert_det_backbone``
and ``params_from_jax`` on the detector tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from test_vision_checkpoint import D, F, HEADS, LAYERS, PRETRAIN_BUCKET, _fake_vision_sd

from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.utils.vision_checkpoint import convert_det_backbone as jax_convert
from one_peace_tpu.vision.zoo import OnePeaceDetector as JaxDetector
from one_peace_tpu_torch.ops import det_attention as tda
from one_peace_tpu_torch.utils import vision_checkpoint as port_vc
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_
from one_peace_tpu_torch.vision.zoo import OnePeaceDetector

GEOMETRY = dict(num_classes=5, image_size=128, fpn_channels=16, embed_dim=D, ffn_embed_dim=F,
                heads=HEADS, layers=LAYERS, pretrain_bucket_size=PRETRAIN_BUCKET, window_size=4,
                global_period=2)


def _close(got, want, tol=1e-4):
    """Within tol of the reference's largest magnitude (and 1e-4 relative)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=tol * max(np.abs(want).max(), 1.0))


def _jax_detector(proposer, seed=0):
    """The JAX detector (XLA attention) with pretrain trunk weights, fresh
    heads and non-zero decomposed rel-pos tables; returns (detector, params)."""
    rs = np.random.RandomState(seed)
    det = JaxDetector(proposer=proposer, checkpoint_activations=False, attn_impl="xla",
                      **GEOMETRY)
    params = det.load_pretrained(_fake_vision_sd(rs), key=jax.random.PRNGKey(seed + 1))
    for group in ("win_layers", "glob_layers"):
        attn = params["backbone"][group]["self_attn"]
        for name in ("rel_pos_h", "rel_pos_w"):
            attn[name] = jnp.asarray(rs.randn(*attn[name].shape).astype(np.float32) * 0.3)
    return det, params


def _port_detector(proposer, params, attn_impl="xla"):
    det = OnePeaceDetector(proposer=proposer, device="cpu", attn_impl=attn_impl, **GEOMETRY)
    det.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return det.eval()


def _images(seed=7, b=2):
    return np.random.RandomState(seed).randn(b, 3, 128, 128).astype(np.float32)


@pytest.fixture(scope="module")
def rpn_pair():
    det, params = _jax_detector("rpn")
    return det, params, _port_detector("rpn", params)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_backbone_matches_jax(attn_impl, rpn_pair, monkeypatch):
    """The stride-16 map; "pallas" runs the JAX kernel interpreted and the
    port's kernel path (its plain version, on the CPU)."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    params = rpn_pair[1]
    jdet = JaxDetector(proposer="rpn", checkpoint_activations=False, attn_impl=attn_impl,
                       **GEOMETRY)
    tdet = _port_detector("rpn", params, attn_impl)
    imgs = _images(1)
    want = jax.jit(jdet.backbone.__call__)(params["backbone"], jnp.asarray(imgs))
    with torch.no_grad():
        got = tdet.backbone(torch.from_numpy(imgs))
    assert got.shape == (2, 8, 8, D)
    _close(got, want)


def test_kernel_path_equals_plain_path_on_cpu(rpn_pair):
    """On CPU tensors both arms are plain PyTorch: the kernel path (Toeplitz
    factor, decomposed factors) and the materialising path agree, and no
    kernel is launched."""
    _, _, det = rpn_pair
    imgs = torch.from_numpy(_images(2))
    before = tda.launches
    with torch.no_grad():
        det.backbone.attn_impl = "pallas"
        kernel_path = det.backbone(imgs)
        det.backbone.attn_impl = "xla"
        plain_path = det.backbone(imgs)
    assert tda.launches == before
    torch.testing.assert_close(kernel_path, plain_path, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [16, 48])
def test_kernel_path_takes_small_grids_on_cpu(rpn_pair, size):
    """Grids of 1 x 1 and 3 x 3 tokens (below the window, padded) go through
    the kernel path's entry too, and agree with the materialising path."""
    _, _, det = rpn_pair
    imgs = torch.from_numpy(np.random.RandomState(size).randn(1, 3, size, size)
                            .astype(np.float32))
    with torch.no_grad():
        det.backbone.attn_impl = "pallas"
        kernel_path = det.backbone(imgs)
        det.backbone.attn_impl = "xla"
        plain_path = det.backbone(imgs)
    assert kernel_path.shape == (1, size // 16, size // 16, D)
    torch.testing.assert_close(kernel_path, plain_path, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("proposer", ["rpn", "fcos"])
def test_features_heads_and_detect_match_jax(proposer, rpn_pair):
    """Pyramid and proposer maps, the cascade on fixed proposals, the mask
    logits, then ``detect()`` with score_thresh=0."""
    jdet, params, tdet = rpn_pair if proposer == "rpn" else (
        *_jax_detector("fcos", seed=3), None)
    if tdet is None:
        tdet = _port_detector("fcos", params)
    imgs = _images(3)
    want_dets = jdet.detect(params, jnp.asarray(imgs), score_thresh=0.0, max_proposals=16,
                            max_dets=8)
    want_pyr, want_outs = jdet._feat_fn(params, jnp.asarray(imgs))
    with torch.no_grad():
        pyr, outs = tdet.features(torch.from_numpy(imgs))
        for key in ("p4", "p8", "p16", "p32", "p64"):
            _close(pyr[key], want_pyr[key])
        for level, want_level in zip(outs, want_outs):
            for got, want in zip(level, want_level):
                _close(got, want)

        feats = tuple(pyr[k] for k in tdet.PYRAMID_KEYS)
        jfeats = tuple(want_pyr[k] for k in jdet.PYRAMID_KEYS)
        rs = np.random.RandomState(5)
        boxes = np.concatenate([rs.rand(12, 2) * 90, np.zeros((12, 2))], 1).astype(np.float32)
        boxes[:, 2:] = boxes[:, :2] + rs.rand(12, 2).astype(np.float32) * 60 + 4
        boxes[-2:] = 0.0  # padded slots
        bidx = np.repeat(np.arange(2, dtype=np.int32), 6)
        scores, refined = tdet.box_head(feats, torch.from_numpy(boxes), torch.from_numpy(bidx))
        jscores, jrefined = jdet.box_head(params["box_head"], jfeats, jnp.asarray(boxes),
                                          jnp.asarray(bidx))
        _close(scores, jscores)
        _close(refined, jrefined)
        masks = tdet.mask_head(feats, torch.from_numpy(boxes), torch.from_numpy(bidx))
        _close(masks, jdet.mask_head(params["mask_head"], jfeats, jnp.asarray(boxes),
                                     jnp.asarray(bidx)))

    got_dets = tdet.detect(torch.from_numpy(imgs), score_thresh=0.0, max_proposals=16,
                           max_dets=8)
    assert len(got_dets) == len(want_dets) == 2
    for got, want in zip(got_dets, want_dets):
        assert len(got["boxes"]) == len(want["boxes"]) > 0
        assert got["masks"].shape == want["masks"].shape == (len(want["boxes"]), 28, 28)
        assert np.isfinite(got["masks"]).all() and np.isfinite(got["boxes"]).all()
        # compare where the score order is not decided by a near tie
        ws = want["scores"]
        gaps = np.abs(np.diff(ws))
        untied = np.ones(len(ws), bool)
        untied[:-1] &= gaps > 1e-5
        untied[1:] &= gaps > 1e-5
        np.testing.assert_allclose(got["scores"], ws, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got["labels"][untied], want["labels"][untied])
        np.testing.assert_allclose(got["boxes"][untied], want["boxes"][untied], rtol=1e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(got["masks"][untied], want["masks"][untied], atol=1e-4)


def test_load_pretrained_matches_convert_det_backbone(tmp_path):
    """From a pretrain-named state dict and from a fairseq .pt: the port's
    copy of convert_det_backbone equals the JAX one, and the loaded trunk
    equals the JAX tree through params_from_jax."""
    rs = np.random.RandomState(4)
    vis = _fake_vision_sd(rs)
    pre = {("encoder_wrapper." + k if k.startswith("image_adapter.")
            else k.replace("encoder.", "encoder_wrapper.fusion_model.")): v
           for k, v in vis.items()}
    pre["text_proj.weight"] = np.zeros((D, D), np.float32)
    jdet = JaxDetector(proposer="rpn", checkpoint_activations=False, **GEOMETRY)
    want_tree = jax.tree.map(np.asarray, jax_convert(pre, jdet.backbone))
    det = fill_random_(OnePeaceDetector(proposer="rpn", device="cpu", **GEOMETRY),
                       torch.Generator().manual_seed(0))
    heads_before = {k: v.clone() for k, v in det.state_dict().items()
                    if not k.startswith("backbone.")}
    got_tree = port_vc.convert_det_backbone(pre, det.backbone)
    jax.tree.map(np.testing.assert_array_equal, got_tree, want_tree)

    path = tmp_path / "one-peace.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in pre.items()}}, path)
    det.load_pretrained(str(path))
    state = det.state_dict()
    for key, value in params_from_jax({"backbone": want_tree}).items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    for key, value in heads_before.items():  # the pyramid and heads keep their values
        assert torch.equal(state[key], value), key
    assert state["backbone.layers.1.self_attn.q_proj.weight"].equal(
        torch.from_numpy(vis["encoder.layers.1.self_attn.q_proj.weight"]))


def test_params_from_jax_covers_the_detector_tree():
    """Every leaf of both JAX detector trees lands on a port parameter of
    the same shape (strict load), in the global/windowed layer order."""
    for proposer in ("rpn", "fcos"):
        jdet = JaxDetector(proposer=proposer, checkpoint_activations=False, **GEOMETRY)
        tree = jax.tree.map(np.asarray, jdet.init(jax.random.PRNGKey(0)))
        state = params_from_jax(tree)
        det = OnePeaceDetector(proposer=proposer, device="cpu", **GEOMETRY)
        det.load_state_dict(state, strict=True)
        assert len(state) == len(det.state_dict())
        # layer 2g + s: s = 0 from win_layers[g, 0], s = 1 from glob_layers[g]
        np.testing.assert_array_equal(
            state["backbone.layers.3.self_attn.q_proj.weight"].numpy(),
            tree["backbone"]["glob_layers"]["self_attn"]["q_proj"]["w"][1].T)
        np.testing.assert_array_equal(
            state["backbone.layers.2.self_attn.rel_pos_h"].numpy(),
            tree["backbone"]["win_layers"]["self_attn"]["rel_pos_h"][1, 0])
        np.testing.assert_array_equal(
            state["fpn.scale_4_0.up1.weight"].numpy(),
            tree["fpn"]["scale_4.0"]["up1"]["w"].transpose(3, 2, 0, 1))


def test_random_weights_cover_the_detector():
    det = fill_random_(OnePeaceDetector(proposer="fcos", device="cpu", **GEOMETRY),
                       torch.Generator().manual_seed(0))
    for name, p in det.named_parameters():
        assert torch.isfinite(p).all(), name
    attn = det.backbone.layers[1].self_attn
    assert attn.rel_pos_h.abs().max() > 0 and attn.rel_pos_w.abs().max() > 0
    assert det.backbone.rel_pos_table.abs().max() > 0
    assert torch.equal(det.proposer.scales, torch.ones(4))
    gn = det.proposer.cls_tower[0].gn
    assert torch.equal(gn.weight, torch.ones_like(gn.weight)) and not gn.bias.any()
