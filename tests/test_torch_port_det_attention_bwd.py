"""The backward of the port's detection-trunk attention against the JAX
package: ``det_attention_bwd_plain`` against the interpreted Pallas
``_det_flash_bwd`` (called with the forward's output and log-sum-exp) and
``jax.vjp`` of ``_xla_core`` (fp32, 2e-4, the JAX package's own bound) for
every bias combination, several q tiles with k tiles of another height,
and a non-square grid; against ``torch.autograd`` of
``det_attention_plain``; ``DetAttentionFunction`` by ``gradcheck`` in fp64;
and ``det_flash_attention``'s gradients with respect to q, k, v, the shared
table (through ``toeplitz_tables``), rel_h and rel_w against ``jax.grad`` of
the JAX ``det_flash_attention`` (interpreted) at 1e-4.  The CUDA kernels
are held to the plain version by the ``cuda``-marked tests (and
``chip_smoke.py`` phase 12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.ops import det_attention as jda
from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu_torch.ops import det_attention as tda

HEADS, DH = 4, 16
SRC_BUCKET = 4
SCALING = DH ** -0.5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _operands(seed, hg, wg, toep_on, decomp_on, b=2):
    """Flat (B, L, H*Dh) q, k, v, the output's cotangent, and the biases'
    factors, numpy fp32 (toep from a random table, bh/bw from random
    decomposed tables)."""
    rs = np.random.RandomState(seed)
    l = hg * wg
    q, k, v, g = (rs.randn(b, l, HEADS * DH).astype(np.float32) for _ in range(4))
    toep = bh = bw = None
    if toep_on:
        table = (rs.randn((2 * SRC_BUCKET - 1) ** 2 + 3, HEADS) * 0.5).astype(np.float32)
        bucket = max(hg, wg)
        full = np.asarray(jda.toeplitz_tables(jnp.asarray(table), SRC_BUCKET, bucket))
        toep = np.ascontiguousarray(full[:, bucket - hg:bucket + hg - 1, :wg, :wg])
    if decomp_on:
        rel_h = (rs.randn(2 * hg - 1, DH) * 0.3).astype(np.float32)
        rel_w = (rs.randn(2 * wg - 1, DH) * 0.3).astype(np.float32)
        jbh, jbw = jda._compute_decomp(jnp.asarray(q.reshape(b, l, HEADS, DH)),
                                       jnp.asarray(rel_h), jnp.asarray(rel_w), (hg, wg))
        bh, bw = np.asarray(jbh), np.asarray(jbw)
    return q, k, v, g, toep, bh, bw


def _close(got, want, tol):
    """Within tol of the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("toep_on", [True, False])
@pytest.mark.parametrize("decomp_on", [True, False])
@pytest.mark.parametrize("hw", [(8, 8), (4, 6)])
def test_plain_backward_matches_pallas_and_vjp(interpret, monkeypatch, toep_on, decomp_on, hw):
    """dq, dk, dv, dtoep, dbh, dbw of the plain version against the
    interpreted Pallas backward (2-row q tiles and 3-row k tiles on the
    8 x 8 grid: several q tiles, ck != c) and jax.vjp of _xla_core."""
    monkeypatch.setenv("ONE_PEACE_DET_BLKQ", "16")
    monkeypatch.setenv("ONE_PEACE_DET_BWD_BLKK", "24")
    hg, wg = hw
    q, k, v, g, toep, bh, bw = _operands(hg * 10 + wg, hg, wg, toep_on, decomp_on)
    b, l = q.shape[:2]
    jargs = [None if x is None else jnp.asarray(x) for x in (q, k, v, toep, bh, bw)]
    out, lse = jda._det_flash_fwd(*jargs, (hg, wg), SCALING, HEADS, with_lse=True)
    pallas = jda._det_flash_bwd(*jargs, out, jnp.asarray(g), lse, (hg, wg), SCALING, HEADS)

    def core(q_, k_, v_, toep_, bh_, bw_):
        return jda._xla_core(q_, k_, v_, toep_, bh_, bw_, (hg, wg), SCALING, HEADS)

    _, vjp = jax.vjp(core, *jargs)
    ref = vjp(jnp.asarray(g))

    targs = [None if x is None else _t(x) for x in (q, k, v, toep, bh, bw)]
    got = tda.det_attention_bwd_plain(*targs, _t(out), _t(g), _t(lse).reshape(b, HEADS, l),
                                      (hg, wg), SCALING, HEADS)
    names = ("dq", "dk", "dv", "dtoep", "dbh", "dbw")
    for name, x, want_p, want_v in zip(names, got, pallas, ref):
        if jargs[names.index(name)] is None:
            assert x is None, name
            continue
        _close(x, want_p, 2e-4)
        _close(x, want_v, 2e-4)


@pytest.mark.parametrize("toep_on,decomp_on", [(True, True), (False, False)])
def test_plain_backward_matches_autograd_of_plain_forward(toep_on, decomp_on):
    """The plain backward equals torch.autograd through det_attention_plain
    (fp32, on a 3 x 5 grid), the log-sum-exp taken from the same forward."""
    hg, wg = 3, 5
    arrays = _operands(7, hg, wg, toep_on, decomp_on)
    q, k, v, g, toep, bh, bw = (None if x is None else _t(x).requires_grad_() for x in arrays)
    leaves = [x for x in (q, k, v, toep, bh, bw) if x is not None]
    out, lse = tda.det_attention_plain(q, k, v, toep, bh, bw, (hg, wg), SCALING, HEADS,
                                       with_lse=True)
    want = torch.autograd.grad(out, leaves, g)
    got = tda.det_attention_bwd_plain(q, k, v, toep, bh, bw, out.detach(), g, lse.detach(),
                                      (hg, wg), SCALING, HEADS)
    got = [x for x in got if x is not None]
    names = [n for n, x in zip(("dq", "dk", "dv", "dtoep", "dbh", "dbw"),
                               (q, k, v, toep, bh, bw)) if x is not None]
    for name, x, y in zip(sorted(names, key=("dq", "dk", "dv", "dtoep", "dbh", "dbw").index),
                          got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5, msg=name)


def test_function_gradcheck_fp64():
    """DetAttentionFunction with compute_decomp outside it, by finite
    differences in fp64 on a 2 x 3 grid, every input of det_flash_attention."""
    gen = torch.Generator().manual_seed(0)
    hg, wg, heads, dh = 2, 3, 2, 4
    l = hg * wg
    q, k, v = (torch.randn(2, l, heads, dh, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    toep = torch.randn(heads, 2 * hg - 1, wg, wg, generator=gen, dtype=torch.float64,
                       requires_grad=True)
    rel_h = torch.randn(2 * hg - 1, dh, generator=gen, dtype=torch.float64, requires_grad=True)
    rel_w = torch.randn(2 * wg - 1, dh, generator=gen, dtype=torch.float64, requires_grad=True)

    def fn(q, k, v, toep, rel_h, rel_w):
        return tda.det_flash_attention(q, k, v, toep, rel_h, rel_w, (hg, wg), 0.4)

    assert torch.autograd.gradcheck(fn, (q, k, v, toep, rel_h, rel_w))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tda.det_flash_attention(q, k, v, None, None, None, (hg, wg), 0.4),
        (q, k, v))


def test_function_skips_gradients_nobody_wants():
    """A bias that needs no gradient gets None, and a forward that needs no
    gradient saves nothing and computes no log-sum-exp."""
    hg, wg = 3, 4
    q, k, v, g, toep, bh, bw = (_t(x) for x in _operands(3, hg, wg, True, True))
    q.requires_grad_()
    out = tda.DetAttentionFunction.apply(q, k, v, toep, bh, bw, (hg, wg), SCALING, HEADS,
                                         True)
    (dq,) = torch.autograd.grad(out, [q], g)
    want = tda.det_attention_bwd_plain(q.detach(), k, v, toep, bh, bw, out.detach(), g,
                                       tda.det_attention_plain(q.detach(), k, v, toep, bh, bw,
                                                               (hg, wg), SCALING, HEADS,
                                                               with_lse=True)[1],
                                       (hg, wg), SCALING, HEADS)[0]
    torch.testing.assert_close(dq, want)
    with torch.no_grad():
        plain = tda.DetAttentionFunction.apply(q, k, v, toep, bh, bw, (hg, wg), SCALING,
                                               HEADS, True)
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, out.detach())


def test_function_writes_lse_only_for_a_gradient(monkeypatch):
    """No log-sum-exp under inference_mode or no_grad with trainable inputs
    (or without an input needing a gradient); with a gradient the forward
    writes it and saves it, and the gradients are those of the plain
    backward on the plain forward's log-sum-exp."""
    calls = []
    plain = tda.det_attention_plain

    def fwd(*args, with_lse=False):
        calls.append(with_lse)
        return plain(*args, with_lse=with_lse)

    monkeypatch.setattr(tda, "det_attention_plain", fwd)
    hg, wg = 3, 4
    q, k, v, g, toep, _, _ = (_t(x) for x in _operands(4, hg, wg, True, True))
    rng = np.random.RandomState(5)
    rel_h, rel_w = (_t(rng.randn(2 * n - 1, DH).astype(np.float32) * 0.1) for n in (hg, wg))
    leaves = [x.reshape(2, hg * wg, HEADS, DH).requires_grad_() for x in (q, k, v)]
    tables = [x.requires_grad_() for x in (toep, rel_h, rel_w)]
    with torch.inference_mode():
        tda.det_flash_attention(*leaves, *tables, (hg, wg), SCALING)
    with torch.no_grad():
        tda.det_flash_attention(*leaves, *tables, (hg, wg), SCALING)
    tda.det_flash_attention(*(x.detach() for x in leaves), *(x.detach() for x in tables),
                            (hg, wg), SCALING)
    assert calls == [False, False, False]
    out = tda.det_flash_attention(*leaves, *tables, (hg, wg), SCALING)
    assert calls[-1] is True
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert saved[-1].shape == (2, HEADS, hg * wg) and saved[-1].dtype == torch.float32
    grads = torch.autograd.grad(out, [*leaves, *tables], g.reshape(out.shape))
    with torch.enable_grad():
        bh, bw = tda.compute_decomp(leaves[0], tables[1], tables[2], (hg, wg))
    flat = [x.reshape(2, hg * wg, HEADS * DH) for x in leaves]
    ref_out, lse = plain(*(x.detach() for x in flat), toep.detach(), bh.detach(), bw.detach(),
                         (hg, wg), SCALING, HEADS, with_lse=True)
    torch.testing.assert_close(saved[-1], lse, rtol=0, atol=0)
    dq, dk, dv, dtoep, dbh, dbw = tda.det_attention_bwd_plain(
        *(x.detach() for x in flat), toep.detach(), bh.detach(), bw.detach(), ref_out, g,
        lse, (hg, wg), SCALING, HEADS)
    dq_decomp, drel_h, drel_w = torch.autograd.grad((bh, bw), [leaves[0], *tables[1:]],
                                                    (dbh, dbw))
    want = [dq.reshape(leaves[0].shape) + dq_decomp, dk.reshape(leaves[1].shape),
            dv.reshape(leaves[2].shape), dtoep, drel_h, drel_w]
    for name, got, ref in zip(("q", "k", "v", "toep", "rel_h", "rel_w"), grads, want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("hw", [(8, 8), (4, 6)])
def test_det_flash_attention_grads_match_jax(interpret, hw):
    """Gradients of a scalar of det_flash_attention with respect to q, k, v,
    the pretrain table (through toeplitz_tables, sliced to the grid), rel_h
    and rel_w, against jax.grad of the JAX det_flash_attention (the Pallas
    forward and backward interpreted), 1e-4."""
    hg, wg = hw
    rs = np.random.RandomState(hg + wg)
    b, l = 2, hg * wg
    q, k, v = (rs.randn(b, l, HEADS, DH).astype(np.float32) for _ in range(3))
    table = (rs.randn((2 * SRC_BUCKET - 1) ** 2 + 3, HEADS) * 0.5).astype(np.float32)
    rel_h = (rs.randn(2 * hg - 1, DH) * 0.3).astype(np.float32)
    rel_w = (rs.randn(2 * wg - 1, DH) * 0.3).astype(np.float32)
    w_out = rs.randn(b, l, HEADS, DH).astype(np.float32)
    bucket = max(hg, wg)

    def jloss(q, k, v, table, rel_h, rel_w):
        toep = jda.toeplitz_tables(table, SRC_BUCKET, bucket)[:, bucket - hg:bucket + hg - 1,
                                                              :wg, :wg]
        out = jda.det_flash_attention(q, k, v, toep, rel_h, rel_w, (hg, wg), SCALING)
        return jnp.sum(out * w_out)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in (q, k, v, table, rel_h, rel_w)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v, table, rel_h, rel_w)]
    tq, tk, tv, ttable, trh, trw = leaves
    toep = tda.toeplitz_tables(ttable, SRC_BUCKET, bucket)[:, bucket - hg:bucket + hg - 1,
                                                            :wg, :wg].contiguous()
    out = tda.det_flash_attention(tq, tk, tv, toep, trh, trw, (hg, wg), SCALING)
    got = torch.autograd.grad((out * _t(w_out)).sum(), leaves)
    for name, x, y in zip(("q", "k", "v", "table", "rel_h", "rel_w"), got, want):
        _close(x, y, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("grid", [(8, 8, True, True), (16, 16, True, False), (5, 7, False, True),
                                  (4, 4, False, False)])
def test_cuda_backward_matches_plain(dtype, grid):
    """Kernels #5 and #6 against the plain version on the card (head dim 64),
    relative to max |plain|: fp32 1e-4, bf16 2e-2; two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the det attention backward is a CUDA kernel")
    hg, wg, toep_on, decomp_on = grid
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, b, l = 4, 2, hg * wg
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, l, heads * 64, generator=gen, device="cuda").to(dt)
               for _ in range(3))
    toep = (torch.randn(heads, 2 * hg - 1, wg, wg, generator=gen, device="cuda")
            if toep_on else None)
    bh = torch.randn(b, heads, hg, l, generator=gen, device="cuda") if decomp_on else None
    bw = torch.randn(b, heads, l, wg, generator=gen, device="cuda") if decomp_on else None
    out, lse = tda.det_attention_cuda(q, k, v, toep, bh, bw, (hg, wg), 0.125, heads,
                                      with_lse=True)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
    args = (q, k, v, toep, bh, bw, out, g, lse, (hg, wg), 0.125, heads)
    got, again = tda.det_attention_bwd_cuda(*args), tda.det_attention_bwd_cuda(*args)
    want = tda.det_attention_bwd_plain(*args)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for x, y, z in zip(got, want, again):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, z)
            err = (x.float() - y.float()).abs().max().item()
            assert err <= tol * y.float().abs().max().item()
