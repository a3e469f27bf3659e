"""The segmenters against the JAX package on the CPU in fp32, at toy size
(d 32, 4 layers in four interaction groups, 4 heads, 64 px crops on a
4 x 4 grid): the ViT-Adapter backbone's four levels, both segmenters'
``logits``, the Mask2Former ``forward_sets`` with its masked-attention
blocked sets equal round by round, the per-layer rel-pos gather against
the all-tables gather, ``load_pretrained`` from a fairseq state with 16-grid
tables (interpolated to the 4-grid) against the JAX load, the mmseg
refusal, ``params_from_jax`` / ``params_to_jax`` on both trees,
``slide_scores`` on a non-square image larger than the crop (tail windows)
against both JAX arms, and ``ms_flip_logits``.

Weights are drawn by the port's ``fill_random_`` and carried to the JAX
side by ``params_to_jax``; tolerance 1e-4 (relative and absolute)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from helpers import tiny_encoder_config, tiny_model_config
from test_torch_port_seg_layers import close, load, noisy
from torch_fixture import make_random_state_dict

from one_peace_tpu.vision import mask2former as jm2f
from one_peace_tpu.vision import zoo as jzoo
from one_peace_tpu_torch.utils.checkpoint import model_to_jax, params_from_jax
from one_peace_tpu_torch.utils.random_weights import fill_random_, init_segmenter_
from one_peace_tpu_torch.vision import mask2former as tm2f
from one_peace_tpu_torch.vision import zoo as tzoo

GRID = 4
ADAPTER_KW = dict(conv_inplane=8, deform_num_heads=4)
M2F_KW = dict(feat_channels=16, num_queries=6, dec_layers=3, dec_heads=4, pixel_layers=2,
              pixel_heads=4)
HEADS = {"upernet": (jzoo.OnePeaceSegmenter, tzoo.OnePeaceSegmenter, dict(channels=16)),
         "mask2former": (jzoo.OnePeaceMask2FormerSegmenter, tzoo.OnePeaceMask2FormerSegmenter,
                         M2F_KW)}


def seg_config():
    cfg = tiny_encoder_config(layers=4)
    cfg.image_adapter.bucket_size = GRID
    cfg.image_adapter.rel_bucket_size = GRID
    return cfg


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


_BUILT = {}


def segmenters(head: str):
    """(JAX segmenter, the port segmenter's seeded weights as the JAX tree,
    the port segmenter), built once per head.  The weights are drawn in the
    port (``fill_random_``: no parameter zero, gammas 0.1), which spares the
    JAX init's time on the CPU; ``test_params_between_packages`` holds the
    JAX init's tree to the port's names."""
    if head not in _BUILT:
        jcls, tcls, kw = HEADS[head]
        jseg = jcls(seg_config(), num_classes=7, **ADAPTER_KW, **kw)
        tseg = fill_random_(tcls(seg_config(), num_classes=7, device="cpu", **ADAPTER_KW, **kw),
                            torch.Generator().manual_seed(1)).eval()
        _BUILT[head] = (jseg, model_to_jax(tseg), tseg)
    return _BUILT[head]


def images(b=2, h=64, w=64, seed=2):
    return np.random.RandomState(seed).randn(b, 3, h, w).astype(np.float32)


_JAX_OUT = {}


def jax_outputs(head: str):
    """The JAX segmenter on ``images()``: (pyramid, head outputs), one
    compile per head; ``logits`` is the head's logits (UperNet) or the
    semantic inference of the last round (Mask2Former), as ``seg.logits``."""
    if head not in _JAX_OUT:
        jseg, params, _ = segmenters(head)

        def run(p, x):
            feats = jseg.backbone(p["backbone"], x)
            return feats, jseg.head(p["head"], feats)

        feats, out = jax.jit(run)(params, images())
        logits = out if head == "upernet" else jm2f.semantic_inference(out[0][-1], out[1][-1])
        _JAX_OUT[head] = {"feats": feats, "out": out, "logits": logits}
    return _JAX_OUT[head]


def test_backbone_levels():
    _, _, tseg = segmenters("upernet")
    want = jax_outputs("upernet")["feats"]
    got = tseg.backbone(_t(images()))
    assert [tuple(f.shape) for f in got] == [(2, s, s, 32) for s in (16, 8, 4, 2)]
    for a, b in zip(got, want):
        close(a, b)


def test_per_layer_gather_equals_all_tables():
    """The backbone gathers each layer's (H, L, L) bias alone; it equals
    that layer's slice of the all-tables gather (bit for bit)."""
    _, _, tseg = segmenters("upernet")
    adapter = tseg.backbone.image_adapter
    assert adapter.rel_pos_table.shape[0] == 4
    every = adapter.rel_pos_bias()
    for i in range(4):
        one = adapter.rel_pos_bias(i)
        assert one.shape == (4, GRID * GRID + 1, GRID * GRID + 1) and one.is_contiguous()
        torch.testing.assert_close(one, every[i], rtol=0, atol=0)


@pytest.mark.parametrize("head", ["upernet", "mask2former"])
def test_logits(head):
    _, _, tseg = segmenters(head)
    want = jax_outputs(head)["logits"]
    got = tseg.logits(_t(images()))
    assert got.shape == (2, 16, 16, 7)
    close(got, want)


def _jax_blocked(mask, hw):
    b, q = mask.shape[:2]
    small = jax.image.resize(jnp.asarray(mask), (b, q, *hw), "bilinear")
    blocked = np.asarray(small).reshape(b, q, -1) < 0.0
    return blocked & ~blocked.all(-1, keepdims=True)


def test_forward_sets_and_blocked_sets():
    """Every round's class and mask predictions within 1e-4, and the keys
    each round blocks for the next round's cross-attention equal."""
    _, _, tseg = segmenters("mask2former")
    want_cls, want_masks = jax_outputs("mask2former")["out"]
    got_cls, got_masks = tseg.forward_sets(_t(images()))
    assert got_cls.shape == (4, 2, 6, 8) and got_masks.shape == (4, 2, 6, 16, 16)
    close(got_cls, want_cls)
    close(got_masks, want_masks)
    shapes = [(2, 2), (4, 4), (8, 8)]  # the pixel decoder's levels, coarse -> fine
    seen = 0
    for j in range(3):
        got = tm2f.blocked_keys(got_masks[j], shapes[j % 3]).numpy()
        want = _jax_blocked(np.asarray(want_masks[j]), shapes[j % 3])
        np.testing.assert_array_equal(got, want)
        seen += int(got.sum())
    assert 0 < seen


def test_blocked_keys_fully_blocked_query_attends_everywhere():
    rs = np.random.RandomState(3)
    mask = rs.randn(2, 5, 9, 7).astype(np.float32)
    mask[0, 1] = -1.0 - np.abs(mask[0, 1])  # blocked everywhere
    got = tm2f.blocked_keys(_t(mask), (3, 4)).numpy()
    np.testing.assert_array_equal(got, _jax_blocked(mask, (3, 4)))
    assert not got[0, 1].any() and got.any()


@pytest.mark.parametrize("head", ["upernet", "mask2former"])
def test_params_between_packages(head):
    """``params_from_jax`` of the JAX init (with noise) fills every parameter
    of the port's segmenter (``load`` is strict), and ``params_to_jax``
    rebuilds the JAX tree, the encoder's layers stacked again."""
    jcls, tcls, kw = HEADS[head]
    jseg = jcls(seg_config(), num_classes=7, init_values=0.5, **ADAPTER_KW, **kw)
    params = noisy(jseg.init(jax.random.PRNGKey(0)), 1)
    tseg = load(tcls(seg_config(), num_classes=7, device="cpu", **ADAPTER_KW, **kw), params)
    back = model_to_jax(tseg)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(back_leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), leaf)
    assert back["backbone"]["encoder"]["layers"]["self_attn"]["q_proj"]["w"].shape == (4, 32, 32)


def _pretrain_state(seed=4):
    cfg = tiny_model_config()
    cfg.encoder.layers = 4
    cfg.encoder.image_adapter.bucket_size = 16
    cfg.encoder.image_adapter.rel_bucket_size = 16
    return make_random_state_dict(cfg, seed=seed)


@pytest.mark.parametrize("head", ["upernet", "mask2former"])
def test_load_pretrained_matches_jax(head):
    """A fairseq state with 16-grid position and rel-pos tables (one table)
    loads into the 4-grid backbone as JAX loads it: the image adapter and
    the encoder layers equal; the rest keeps the port's own values."""
    jcls, tcls, kw = HEADS[head]
    sd = _pretrain_state()
    jseg = jcls(seg_config(), num_classes=7, **ADAPTER_KW, **kw)
    jparams = jseg.load_pretrained(copy.deepcopy(sd))
    want = params_from_jax({"backbone": {k: jparams["backbone"][k]
                                         for k in ("image_adapter", "encoder")}})
    tseg = fill_random_(tcls(seg_config(), num_classes=7, device="cpu", **ADAPTER_KW, **kw),
                        torch.Generator().manual_seed(5))
    fresh = {k: v.clone() for k, v in tseg.state_dict().items()}
    tseg.load_pretrained(copy.deepcopy(sd))
    state = tseg.state_dict()
    assert state["backbone.image_adapter.rel_pos_table"].shape == (4, 7 * 7 + 3, 4)
    assert state["backbone.image_adapter.pos_embed"].shape == (17, 32)
    for name, value in want.items():
        if name in state:
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    loaded = {k for k in want if k in state}
    assert {k for k in state if k.startswith(("backbone.image_adapter.",
                                              "backbone.encoder.layers."))} <= loaded
    for name in state:
        if name not in loaded:
            torch.testing.assert_close(state[name], fresh[name], rtol=0, atol=0)


def test_load_pretrained_refuses_mmseg_checkpoint():
    tseg = tzoo.OnePeaceSegmenter(seg_config(), num_classes=7, channels=16, device="cpu",
                                  **ADAPTER_KW)
    for bad in ({"backbone.spm.stem.1.running_mean": np.zeros((8,), np.float32)},
                {"decode_head.conv_seg.weight": np.zeros((7, 16, 1, 1), np.float32)}):
        with pytest.raises(ValueError, match="mmseg"):
            tseg.load_pretrained(bad)


def test_slide_scores_matches_both_jax_arms():
    """An 80 x 112 image, crop 64, stride 32: a tail window on each axis
    (origins y 0, 16 and x 0, 32, 48), against the JAX scan and the JAX host
    loop; a 48 x 40 image smaller than the crop goes through one padded
    window."""
    jseg, params, tseg = segmenters("upernet")
    for h, w in ((80, 112), (48, 40)):
        x = images(1, h, w, seed=h)
        got = tseg.slide_scores(_t(x), 64, 32)
        assert got.shape == (1, h, w, 7)
        close(got, jseg._slide_logits_host(params, x, 64, 32))
        if h > 64:  # the scan arm compiles once per image size
            close(got, jseg.slide_scores(params, x, 64, 32))
    assert tzoo.OnePeaceSegmenter._slide_origins(80, 112, 64, 32) == \
        jzoo.OnePeaceSegmenter._slide_origins(80, 112, 64, 32) == \
        [(0, 0), (0, 32), (0, 48), (16, 0), (16, 32), (16, 48)]


def test_ms_flip_logits(monkeypatch):
    """Ratios 0.5 (one padded window) and 1.25 (a 2 x 2 grid with tails),
    each with its flip, on a non-square image; the JAX side runs its host
    window loop (one compile)."""
    monkeypatch.setenv("ONE_PEACE_SLIDE_IMPL", "host")
    jseg, params, tseg = segmenters("mask2former")
    x = images(1, 64, 72, seed=6)
    want = jseg.ms_flip_logits(params, x, 64, 32, ratios=(0.5, 1.25))
    got = tseg.ms_flip_logits(_t(x), 64, 32, ratios=(0.5, 1.25))
    assert got.shape == (1, 64, 72, 7)
    close(got, want)


def test_init_segmenter_fills_every_parameter():
    """The seeded init covers every leaf (none left as uninitialised
    memory), zeroes the deformable projections but the offset ring, and
    puts the injectors' gamma at their init_values."""
    tseg = tzoo.OnePeaceMask2FormerSegmenter(seg_config(), num_classes=7, device="cpu",
                                             init_values=0.25, **ADAPTER_KW, **M2F_KW)
    for p in tseg.parameters():
        p.data.fill_(float("nan"))
    init_segmenter_(tseg, torch.Generator().manual_seed(0))
    for name, p in tseg.named_parameters():
        assert torch.isfinite(p).all(), name
    inj = tseg.backbone.injectors[0]
    assert (inj.gamma == 0.25).all() and (inj.attn.sampling_offsets.weight == 0).all()
    assert inj.attn.sampling_offsets.bias.abs().max() == 4.0
    assert torch.isfinite(tseg.logits(_t(images(1)))).all()
