"""The segmentation slice's building blocks against the JAX package, on
the CPU in fp32: the deformable-attention core (points outside the map,
non-square levels) and layer, GroupNorm, the spatial prior module, the
ConvFFN, Injector and Extractor, the UperNet head and its adaptive pooling,
the sine positional encoding and the biased attention of the Mask2Former
decoder, the pixel decoder, ``semantic_inference``, and the resize that
stands for ``jax.image.resize`` up and down on odd sizes.

Weights are the JAX modules' own init with seeded noise added (so that the
zero inits of the offset and weight projections, the gammas and the tables
are not zero), carried into the port by ``params_from_jax``.  Tolerance
1e-4 (relative and absolute) unless a test states another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.vision import adapter as jadapter
from one_peace_tpu.vision import mask2former as jm2f
from one_peace_tpu.vision import ms_deform_attn as jmsda
from one_peace_tpu.vision import upernet as jupernet
from one_peace_tpu_torch.models import components as tc
from one_peace_tpu_torch.utils.checkpoint import params_from_jax
from one_peace_tpu_torch.vision import adapter as tadapter
from one_peace_tpu_torch.vision import mask2former as tm2f
from one_peace_tpu_torch.vision import ms_deform_attn as tmsda
from one_peace_tpu_torch.vision import upernet as tupernet

TOL = dict(rtol=1e-4, atol=1e-4)
PRIOR_SHAPES = [(8, 8), (4, 4), (2, 2)]


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def noisy(tree, seed: int, scale: float = 0.05):
    """The tree's leaves as fp32 numpy arrays with seeded N(0, scale^2) noise."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + scale * rs.randn(*np.shape(x))).astype(
            np.float32), tree)


def load(module, tree):
    """The JAX tree into the port module, every parameter set."""
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module.eval()


def jit(fn, *args):
    """``fn(*args)`` under ``jax.jit`` (faster than eager on the CPU)."""
    return jax.jit(fn)(*args)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("shapes", [[(5, 7)], [(6, 6), (3, 5), (2, 1)]])
def test_ms_deform_attn_core(shapes):
    """Sampling locations in [-0.25, 1.25]: taps outside the map read 0."""
    rs = np.random.RandomState(len(shapes))
    n, lq, m, d, p = 2, 9, 3, 4, 4
    s = sum(h * w for h, w in shapes)
    value = rs.randn(n, s, m, d).astype(np.float32)
    locs = rs.uniform(-0.25, 1.25, (n, lq, m, len(shapes), p, 2)).astype(np.float32)
    w = rs.randn(n, lq, m, len(shapes) * p).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    w = w.reshape(n, lq, m, len(shapes), p)
    outside = (locs < 0) | (locs > 1)
    assert outside.any() and (~outside).any()
    want = jit(lambda v, lo, a: jmsda.ms_deform_attn_core(v, shapes, lo, a), value, locs, w)
    close(tmsda.ms_deform_attn_core(_t(value), shapes, _t(locs), _t(w)), want)


@pytest.mark.parametrize("levels,ratio", [(1, 1.0), (3, 0.5)])
def test_ms_deform_attn_module(levels, ratio):
    rs = np.random.RandomState(levels)
    dim, heads = 16, 4
    shapes = PRIOR_SHAPES[:levels]
    jmod = jmsda.MSDeformAttnModule(dim, levels, heads, 4, ratio)
    params = noisy(jmod.init(jax.random.PRNGKey(levels)), 10 + levels)
    tmod = load(tmsda.MSDeformAttn(dim, levels, heads, 4, ratio, device="cpu"), params)
    query = rs.randn(2, 6, dim).astype(np.float32)
    ref = rs.rand(2, 6, 1, 2).astype(np.float32)
    value = rs.randn(2, sum(h * w for h, w in shapes), dim).astype(np.float32)
    want = jit(lambda p, q, r, v: jmod(p, q, r, v, shapes), params, query, ref, value)
    close(tmod(_t(query), _t(ref), _t(value), shapes), want)


def test_offset_ring_is_the_init():
    jmod = jmsda.MSDeformAttnModule(24, 3, 6, 4)
    want = jmod.init(jax.random.PRNGKey(0))["sampling_offsets"]["b"]
    np.testing.assert_allclose(tmsda.offset_ring(6, 3, 4).numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("channels", [8, 48, 96])
def test_group_norm(channels):
    """NHWC GroupNorm: 8 and 96 channels split in 8 and 32 groups, 48 in
    24 (the largest count <= 32 that divides)."""
    rs = np.random.RandomState(channels)
    x = (rs.randn(2, 5, 3, channels) * 3 + 1).astype(np.float32)
    params = {"scale": rs.randn(channels).astype(np.float32),
              "bias": rs.randn(channels).astype(np.float32)}
    want = jit(jadapter.group_norm, params, x)
    close(tc.group_norm(_t(x), _t(params["scale"]), _t(params["bias"])), want)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_spatial_prior_module(hw):
    jspm = jadapter.SpatialPriorModule(inplanes=8, embed_dim=16)
    params = noisy(jspm.init(jax.random.PRNGKey(1)), 2)
    tspm = load(tadapter.SpatialPriorModule(8, 16, device="cpu"), params)
    x = np.random.RandomState(3).randn(2, *hw, 3).astype(np.float32)
    want = jit(jspm, params, x)
    got = tspm(_t(x))
    assert got[0].shape == (2, hw[0] // 4, hw[1] // 4, 16)
    for a, b in zip(got, want):
        close(a, b)


def test_conv_ffn():
    jffn = jadapter.ConvFFN(16, 12)
    params = noisy(jffn.init(jax.random.PRNGKey(4)), 5)
    tffn = load(tadapter.ConvFFN(16, 12, device="cpu"), params)
    x = np.random.RandomState(6).randn(2, 84, 16).astype(np.float32)
    close(tffn(_t(x), PRIOR_SHAPES), jit(lambda p, x: jffn(p, x, PRIOR_SHAPES), params, x))


def test_injector_and_extractor():
    """The injector reads the three prior levels into 4 x 4 ViT tokens
    (LayerScale-gated), the extractor the tokens back into the priors."""
    rs = np.random.RandomState(7)
    dim, b = 16, 2
    tokens = rs.randn(b, 16, dim).astype(np.float32)
    priors = rs.randn(b, 84, dim).astype(np.float32)
    ref_vit = np.tile(jadapter.get_reference_points([(4, 4)]), (b, 1, 1, 1))
    ref_priors = np.tile(jadapter.get_reference_points(PRIOR_SHAPES), (b, 1, 1, 1))
    np.testing.assert_array_equal(tadapter.reference_points(PRIOR_SHAPES, b, "cpu").numpy(),
                                  ref_priors)

    jinj = jadapter.Injector(dim, num_heads=4, n_levels=3, init_values=0.5)
    params = noisy(jinj.init(jax.random.PRNGKey(8)), 9)
    tinj = load(tadapter.Injector(dim, 4, 4, 3, device="cpu"), params)
    want = jit(lambda p, t, r, c: jinj(p, t, r, c, PRIOR_SHAPES), params, tokens, ref_vit,
               priors)
    close(tinj(_t(tokens), _t(ref_vit), _t(priors), PRIOR_SHAPES), want)

    jext = jadapter.Extractor(dim, num_heads=4, n_levels=1)
    params = noisy(jext.init(jax.random.PRNGKey(10)), 11)
    text = load(tadapter.Extractor(dim, 4, 4, 1, device="cpu"), params)
    want = jit(lambda p, c, r, t: jext(p, c, r, t, [(4, 4)], PRIOR_SHAPES), params, priors,
               ref_priors, tokens)
    close(text(_t(priors), _t(ref_priors), _t(tokens), [(4, 4)], PRIOR_SHAPES), want)


@pytest.mark.parametrize("size,out", [(7, 1), (7, 2), (7, 3), (7, 6), (5, 3), (28, 6)])
def test_adaptive_avg_pool(size, out):
    x = np.random.RandomState(size * out).randn(2, size, size + 1, 5).astype(np.float32)
    want = jit(lambda x: jupernet.adaptive_avg_pool(x, out, out), x)
    close(tupernet.adaptive_avg_pool(_t(x), out, out), want)


def test_upernet_head():
    jhead = jupernet.UperNetHead([16] * 4, channels=8, num_classes=5)
    params = noisy(jhead.init(jax.random.PRNGKey(12)), 13)
    thead = load(tupernet.UperNetHead([16] * 4, channels=8, num_classes=5, device="cpu"), params)
    rs = np.random.RandomState(14)
    feats = [rs.randn(2, s, s, 16).astype(np.float32) for s in (16, 8, 4, 2)]
    want = jit(jhead, params, feats)
    got = thead([_t(f) for f in feats])
    assert got.shape == (2, 16, 16, 5)
    close(got, want)


@pytest.mark.parametrize("h,w,dim", [(4, 4, 16), (3, 7, 32), (1, 1, 8)])
def test_sine_positional_encoding(h, w, dim):
    np.testing.assert_array_equal(tm2f.sine_positional_encoding(h, w, dim),
                                  jm2f.sine_positional_encoding(h, w, dim))


@pytest.mark.parametrize("with_bias", [False, True])
def test_mha(with_bias):
    """The decoder's attention; the bias blocks whole rows of keys (-1e9)
    as the masked cross-attention does."""
    rs = np.random.RandomState(15)
    params = noisy(jm2f.init_mha(jax.random.PRNGKey(16), 16), 17)
    tmha = load(tm2f.MHA(16, device="cpu"), params)
    q = rs.randn(2, 5, 16).astype(np.float32)
    kv = rs.randn(2, 9, 16).astype(np.float32)
    bias = None
    if with_bias:
        bias = np.where(rs.rand(2, 5, 9) < 0.4, -1e9, 0.0).astype(np.float32)
    want = jit(lambda p, q, kv, b: jm2f.mha(p, 4, q, kv, kv, b), params, q, kv, bias)
    close(tmha(4, _t(q), _t(kv), _t(kv), None if bias is None else _t(bias)), want)


def test_pixel_decoder():
    jdec = jm2f.MSDeformAttnPixelDecoder([16] * 4, feat_channels=16, out_channels=12,
                                         num_layers=2, num_heads=4, ffn_dim=32)
    params = noisy(jdec.init(jax.random.PRNGKey(18)), 19)
    tdec = load(tm2f.MSDeformAttnPixelDecoder([16] * 4, 16, 12, num_layers=2, num_heads=4,
                                              ffn_dim=32, device="cpu"), params)
    rs = np.random.RandomState(20)
    feats = [rs.randn(2, s, s, 16).astype(np.float32) for s in (16, 8, 4, 2)]
    want = jit(lambda p, f: jdec(p, f)[:2], params, feats) + (
        [tuple(f.shape[1:3]) for f in (feats[3], feats[2], feats[1])],)
    got = tdec([_t(f) for f in feats])
    close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        close(a, b)
    assert list(got[2]) == [tuple(s) for s in want[2]] == [(2, 2), (4, 4), (8, 8)]


def test_semantic_inference():
    rs = np.random.RandomState(21)
    cls = rs.randn(2, 6, 5).astype(np.float32) * 3
    masks = rs.randn(2, 6, 7, 9).astype(np.float32) * 3
    want = jit(jm2f.semantic_inference, cls, masks)
    close(tm2f.semantic_inference(_t(cls), _t(masks)), want, dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("src,dst", [((7, 5), (13, 9)), ((13, 9), (5, 4)), ((16, 16), (4, 4)),
                                     ((3, 3), (8, 8)), ((9, 14), (9, 5)), ((56, 56), (7, 7))])
def test_resize_linear_matches_jax(src, dst):
    """Up and down (JAX antialiases the downsize), odd sizes, one axis kept,
    over the NHWC axes and over the NCHW ones."""
    rs = np.random.RandomState(src[0] * 31 + dst[1])
    x = rs.randn(2, *src, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 3), "bilinear")
    close(tc.resize_linear(_t(x), dst, (1, 2)), want, dict(rtol=1e-5, atol=1e-5))
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want = jax.image.resize(jnp.asarray(xc), (2, 3, *dst), "bilinear")
    close(tc.resize_linear(_t(xc), dst, (2, 3)), want, dict(rtol=1e-5, atol=1e-5))
