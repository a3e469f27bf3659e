"""The port's detection-trunk attention (``ops/det_attention.py``) and its
rel-pos machinery against the JAX package: ``det_attention_plain`` against
``_xla_reference`` / ``_xla_core`` and the Pallas ``_det_flash_fwd`` in
interpret mode (fp32, 1e-5), the Toeplitz factor, the decomposed factors,
``decomposed_rel_bias`` and ``resize_rel_pos`` (1e-6).  The CUDA kernel
itself is checked on the card (``chip_smoke.py`` phase 11)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.ops import det_attention as jda
from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.vision import det_backbone as jdb
from one_peace_tpu_torch.ops import det_attention as tda
from one_peace_tpu_torch.vision import det_backbone as tdb

HEADS, DH = 4, 16
SRC_BUCKET = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _case(seed, hg, wg, b=2):
    rs = np.random.RandomState(seed)
    l = hg * wg
    q, k, v = (rs.randn(b, l, HEADS, DH).astype(np.float32) for _ in range(3))
    table = (rs.randn((2 * SRC_BUCKET - 1) ** 2 + 3, HEADS) * 0.5).astype(np.float32)
    rel_h = (rs.randn(2 * hg - 1, DH) * 0.3).astype(np.float32)
    rel_w = (rs.randn(2 * wg - 1, DH) * 0.3).astype(np.float32)
    return q, k, v, table, rel_h, rel_w


@pytest.mark.parametrize("toep_on", [True, False])
@pytest.mark.parametrize("decomp_on", [True, False])
@pytest.mark.parametrize("hw", [(8, 8), (4, 6)])
def test_plain_matches_jax_references(interpret, toep_on, decomp_on, hw):
    """Every combination of the two biases, square and non-square grids:
    the plain version against ``_xla_reference`` (which materialises the
    decomposed bias from rel_h/rel_w), ``_xla_core`` (the factors) and the
    interpreted Pallas kernel, output and log-sum-exp."""
    hg, wg = hw
    q, k, v, table, rel_h, rel_w = _case(hg * 10 + wg, hg, wg)
    b, l = q.shape[:2]
    scaling = DH ** -0.5
    bucket = max(hg, wg)
    jtoep = jda.toeplitz_tables(jnp.asarray(table), SRC_BUCKET, bucket)
    jtoep = jtoep[:, bucket - hg:bucket + hg - 1, :wg, :wg] if toep_on else None
    ttoep = tda.toeplitz_tables(_t(table), SRC_BUCKET, bucket)
    ttoep = ttoep[:, bucket - hg:bucket + hg - 1, :wg, :wg].contiguous() if toep_on else None
    flat = [x.reshape(b, l, HEADS * DH) for x in (q, k, v)]
    jbh = jbw = tbh = tbw = None
    if decomp_on:
        jbh, jbw = jda._compute_decomp(jnp.asarray(q), jnp.asarray(rel_h), jnp.asarray(rel_w),
                                       (hg, wg))
        tbh, tbw = tda.compute_decomp(_t(q), _t(rel_h), _t(rel_w), (hg, wg))
        np.testing.assert_allclose(tbh.numpy(), np.asarray(jbh), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tbw.numpy(), np.asarray(jbw), rtol=1e-6, atol=1e-6)

    got, lse = tda.det_attention_plain(*map(_t, flat), ttoep, tbh, tbw, (hg, wg), scaling,
                                       HEADS, with_lse=True)
    jflat = [jnp.asarray(x) for x in flat]
    ref = jda._xla_reference(*jflat, jtoep, jnp.asarray(rel_h) if decomp_on else None,
                             jnp.asarray(rel_w) if decomp_on else None, (hg, wg), scaling, HEADS)
    core = jda._xla_core(*jflat, jtoep, jbh, jbw, (hg, wg), scaling, HEADS)
    kern, jlse = jda._det_flash_fwd(*jflat, jtoep, jbh, jbw, (hg, wg), scaling, HEADS,
                                    with_lse=True)
    for want in (ref, core, kern):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(b, HEADS, l), **TOL)
    plain_only = tda.det_attention_plain(*map(_t, flat), ttoep, tbh, tbw, (hg, wg), scaling,
                                         HEADS)
    assert torch.equal(plain_only, got)


def test_flash_entry_matches_jax_entry(interpret):
    """``det_flash_attention`` (the JAX signature) end to end on the CPU."""
    q, k, v, table, rel_h, rel_w = _case(5, 8, 8)
    toep = tda.toeplitz_tables(_t(table), SRC_BUCKET, 8)
    got = tda.det_flash_attention(_t(q), _t(k), _t(v), toep, _t(rel_h), _t(rel_w), (8, 8),
                                  DH ** -0.5)
    want = jda.det_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jda.toeplitz_tables(jnp.asarray(table), SRC_BUCKET, 8), jnp.asarray(rel_h),
        jnp.asarray(rel_w), (8, 8), DH ** -0.5)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("src,dst", [(4, 8), (4, 4), (4, 3), (16, 4)])
def test_toeplitz_and_shared_bias(src, dst):
    table = np.random.RandomState(src + dst).randn((2 * src - 1) ** 2 + 3, HEADS).astype(
        np.float32)
    got = tda.toeplitz_tables(_t(table), src, dst)
    want = jda.toeplitz_tables(jnp.asarray(table), src, dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    shared = tdb.shared_bias_from_table(_t(table), src, dst)
    np.testing.assert_allclose(shared.numpy(),
                               np.asarray(jdb.shared_bias_from_table(jnp.asarray(table), src, dst)),
                               rtol=1e-6, atol=1e-6)
    # the Toeplitz factor, materialized, is the gathered bias
    np.testing.assert_allclose(tda.bias_from_toeplitz(got, dst, dst).numpy(), shared.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("table_len,size", [(15, 8), (15, 4), (15, 3), (7, 8), (127, 50), (9, 5)])
def test_resize_rel_pos(table_len, size):
    """Up, down (where jax.image.resize antialiases) and the identity."""
    table = np.random.RandomState(table_len + size).randn(table_len, DH).astype(np.float32)
    got = tdb.resize_rel_pos(_t(table), size)
    want = jdb.resize_rel_pos(jnp.asarray(table), size)
    assert got.shape == (2 * size - 1, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw,table_size", [((8, 8), 8), ((4, 6), 8), ((3, 3), 8)])
def test_decomposed_rel_bias(hw, table_size):
    """The plain path's (B, H, L, L) decomposed bias, including a grid
    smaller than the table (the tables are resized first)."""
    rs = np.random.RandomState(hw[0] * 7 + hw[1])
    q = rs.randn(2, hw[0] * hw[1], HEADS, DH).astype(np.float32)
    rel_h = rs.randn(2 * table_size - 1, DH).astype(np.float32)
    rel_w = rs.randn(2 * table_size - 1, DH).astype(np.float32)
    got = tdb.decomposed_rel_bias(_t(q), _t(rel_h), _t(rel_w), hw)
    want = jdb.decomposed_rel_bias(jnp.asarray(q), jnp.asarray(rel_h), jnp.asarray(rel_w), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_window_partition_round_trip():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 10, 10, 3).astype(np.float32))
    parts, pad_hw = tdb.window_partition(x, 4)
    want, want_pad = jdb.window_partition(jnp.asarray(x.numpy()), 4)
    assert pad_hw == want_pad == (12, 12)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(want))
    assert torch.equal(tdb.window_unpartition(parts, 4, pad_hw, (10, 10)), x)


def test_dispatch_and_guards():
    """CPU tensors take the plain version and count no launch; the kernel
    wrapper refuses what the kernel does not take before building anything."""
    q, k, v, table, rel_h, rel_w = _case(3, 4, 4)
    before = tda.launches
    out = tda.det_flash_attention(_t(q), _t(k), _t(v), None, None, None, (4, 4), 0.25)
    assert tda.launches == before and out.shape == q.shape
    flat = [_t(x.reshape(2, 16, HEADS * DH)) for x in (q, k, v)]
    with pytest.raises(ValueError, match="head dim 64"):
        tda._check_kernel_inputs(*flat, None, None, None, (4, 4), HEADS)
    wide = [torch.zeros(2, 16, HEADS * 64) for _ in range(3)]
    with pytest.raises(ValueError, match="grid"):
        tda._check_kernel_inputs(*wide, None, None, None, (4, 5), HEADS)
    with pytest.raises(ValueError, match="bh and bw"):
        tda._check_kernel_inputs(*wide, None, torch.zeros(2, HEADS, 4, 16), None, (4, 4), HEADS)
    with pytest.raises(ValueError, match="toep must be fp32"):
        tda._check_kernel_inputs(*wide, torch.zeros(HEADS, 7, 4, 4, dtype=torch.float64), None,
                                 None, (4, 4), HEADS)
    with pytest.raises(ValueError, match="CUDA device"):
        tda._check_kernel_inputs(*wide, None, None, None, (4, 4), HEADS)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        tda._check_kernel_inputs(*(x.double() for x in wide), None, None, None, (4, 4), HEADS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tda.det_flash_attention(*(x.reshape(2, 16, HEADS, 64).to("meta") for x in wide),
                                None, None, None, (4, 4), 0.125)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The kernel against its plain version at a small global grid, a
    ragged one and a one-row one, bf16 and fp32, with the LSE (the full
    shapes: chip_smoke)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for hg, wg in ((8, 8), (5, 7), (1, 9)):
        l, heads = hg * wg, 2
        toep = torch.randn(heads, 2 * hg - 1, wg, wg, generator=gen, device="cuda")
        bh = torch.randn(2, heads, hg, l, generator=gen, device="cuda")
        bw = torch.randn(2, heads, l, wg, generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v = (torch.randn(2, l, heads * 64, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out, lse = tda.det_attention_cuda(q, k, v, toep, bh, bw, (hg, wg), 0.125, heads,
                                              with_lse=True)
            want, want_lse = tda.det_attention_plain(q, k, v, toep, bh, bw, (hg, wg), 0.125,
                                                     heads, with_lse=True)
            assert (out.float() - want.float()).abs().max().item() <= tol
            assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_path_raises_on_other_head_dims_on_the_card():
    """No plain fallback on the card: a head dim other than 64 raises, from
    the entry and from the trunk's kernel path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    q = torch.randn(2, 16, 4, 32, device="cuda")
    with pytest.raises(ValueError, match="head dim 64"):
        tda.det_flash_attention(q, q, q, None, None, None, (4, 4), 32 ** -0.5)
    trunk = tdb.DetBackbone(embed_dim=128, ffn_embed_dim=256, heads=4, layers=2,
                            bucket_size=4, pretrain_bucket_size=4, window_size=2,
                            global_period=2, device="cuda")
    for p in trunk.parameters():
        torch.nn.init.normal_(p, std=0.02)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim 64"):
        trunk(torch.randn(1, 3, 64, 64, device="cuda"))
