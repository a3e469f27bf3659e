"""The retrieval attention kernels' plan (``ops/flash_attention.py:tile_plan``,
``bwd_plan``), the softmax statistics that the forward hands the backward,
and the dk/dv kernel's d(bias) sum, on the CPU.

The plan is checked by brute force over L in 1..900: the tiles cover every
row and key once, the last is no wider than its keys need, the shared memory
fits, and the one-walk (row block resident) and slab branches hold where
stated.  The plain forward's statistics are held to ``jax.nn.logsumexp`` and
``jnp.max`` of the logits that ``_xla_reference`` forms; the plain backward
fed them to the interpreted Pallas ``_flash_bwd`` and ``jax.vjp`` of
``_xla_reference``.  The d(bias) slab is walked in the kernel's order
(chunks of the batch, q tiles, one owner per element, then the chunks' sum)
in torch against ``flash_attention_bwd_plain``.  ``FlashAttentionFunction``
writes the statistics only when a gradient is taken.  The kernels run on the
card (``chip_smoke.py`` phases 3 and 6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)
from torch.utils.checkpoint import checkpoint

from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu_torch.ops import flash_attention as tfa

TOL = 1e-5
SCALING = 0.25
T = tfa.TILE


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpreter mode on CPU."""
    orig = jfa.pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)


def _inputs(l, bias, mask, b=2, h=4, d=16, seed=0):
    """q, k, v, g (B, L, H*D); rel bias; fp32 key bias (-1e30 at pads)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, l, h * d).astype(np.float32) for _ in range(4))
    rel = None
    if bias == "shared":
        rel = rng.randn(h, l, l).astype(np.float32)
    elif bias == "batched":
        rel = rng.randn(b, h, l, l).astype(np.float32)
    key_bias = None
    if mask:
        key_bias = np.zeros((b, l), np.float32)
        key_bias[1, l - max(1, l // 3):] = jfa.NEG_INF
    return q, k, v, g, rel, key_bias


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("bias", ["shared", "batched", None])
def test_tile_plan_by_brute_force(bias):
    """Every L in 1..900: tiles cover [0, L) once, the last is L's tail
    rounded up to 16, shared memory fits 227 KB, the row block stays
    resident (one walk) exactly when two blocks fit on an SM (L <= 304), a
    shared bias gets the d(bias) slab exactly when it fits beside the dk/dv
    kernel's static shared memory (L <= 752), and
    the batch chunks cover B once."""
    for l in range(1, 901):
        plan = tfa.tile_plan(l)
        widths = [T] * (plan.n_tiles - 1) + [plan.tail]
        covered = torch.zeros(sum(widths), dtype=torch.int64)
        start = 0
        for w in widths:
            covered[start:start + w] += 1
            start += w
        assert bool((covered[:l] == 1).all()) and covered.numel() >= l, l
        last = l - T * (plan.n_tiles - 1)
        assert 0 < last <= plan.tail <= T and plan.tail % 16 == 0 and plan.tail - last < 16, l
        width = sum(widths)
        region = T * (width + 8) * 4 if plan.resident else 2 * T * tfa.STAGE_STRIDE * 4
        assert plan.smem == tfa.TILES_BYTES + region + tfa.SWIZZLE_ALIGN <= tfa.SMEM_PER_BLOCK
        assert plan.resident == (l <= 304), l  # two blocks per SM
        assert 2 * (plan.smem + 1024) <= tfa.SMEM_PER_SM or not plan.resident
        assert plan.stride == (width + 8 if plan.resident else 0)
        assert plan.stride % 16 == 8 or not plan.resident  # float2 fragment accesses: 32 banks
        assert tfa.STAGE_STRIDE % 16 == 8
        if l <= 768:  # the other branch, forced, as tools/flash_attention_ab.py measures it
            assert tfa.tile_plan(l, not plan.resident).resident != plan.resident
        for b in (1, 3, 32, 256):
            bp = tfa.bwd_plan(b, l, 24, bias == "shared")
            assert bp.tiles == plan
            assert bp.dkv_smem + tfa.DKV_STATIC_SMEM <= tfa.SMEM_PER_BLOCK
            assert bp.dkv_slab == (bias == "shared" and l <= 752), (b, l)
            assert bp.dkv_smem == tfa.TILES_BYTES + tfa.SWIZZLE_ALIGN + (
                T * (width + 8) * 4 if bp.dkv_slab else 0)
            if bias != "shared":
                assert (bp.b_chunk, bp.chunks) == (1, b)
            assert bp.chunks * bp.b_chunk >= b > (bp.chunks - 1) * bp.b_chunk


@pytest.mark.parametrize("l,bias,mask", [(37, "shared", True), (71, "batched", True),
                                         (130, None, False)])
def test_plain_stats_match_xla_logits(monkeypatch, l, bias, mask):
    """m = max and 1/l = exp(m - logsumexp) of the logits ``_xla_reference``
    hands to its softmax."""
    q, k, v, _, rel, kb = _inputs(l, bias, mask)
    seen = []
    softmax = jax.nn.softmax

    def record(x, axis=-1):
        seen.append(np.asarray(x))
        return softmax(x, axis=axis)

    monkeypatch.setattr(jax.nn, "softmax", record)
    want_out = jfa._xla_reference(*map(_jax, (q, k, v, rel, kb)), SCALING, 4)
    (logits,) = seen
    out, stats = tfa.flash_attention_plain(*map(_torch, (q, k, v, rel, kb)), SCALING, 4,
                                           with_stats=True)
    assert stats.shape == (2, 2, 4, l) and stats.dtype == torch.float32
    m = np.asarray(jnp.max(logits, axis=-1))
    inv = np.exp(m - np.asarray(jax.nn.logsumexp(logits, axis=-1)))
    np.testing.assert_allclose(stats[0].numpy(), m, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats[1].numpy(), inv, rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)


CASES = [(l, bias, mask) for l in (37, 130) for bias in ("shared", "batched", None)
         for mask in (True, False)]


def _check(got, want):
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("l,bias,mask", CASES)
def test_bwd_plain_from_stats_matches_pallas_and_vjp(interpret, l, bias, mask):
    """The plain backward started from the forward's statistics, against
    the interpreted Pallas backward and jax.vjp of the XLA reference."""
    q, k, v, g, rel, kb = _inputs(l, bias, mask)
    _, stats = tfa.flash_attention_plain(*map(_torch, (q, k, v, rel, kb)), SCALING, 4,
                                         with_stats=True)
    got = tfa.flash_attention_bwd_plain(*map(_torch, (q, k, v, g, rel, kb)), SCALING, 4,
                                        stats=stats)
    _check(got, jfa._flash_bwd(*map(_jax, (q, k, v, g, rel, kb)), SCALING, 4))

    def f(q_, k_, v_, rel_):
        return jfa._xla_reference(q_, k_, v_, rel_, _jax(kb), SCALING, 4)

    _, vjp = jax.vjp(f, *map(_jax, (q, k, v, rel)))
    _check(got, vjp(jnp.asarray(g)))
    without = tfa.flash_attention_bwd_plain(*map(_torch, (q, k, v, g, rel, kb)), SCALING, 4)
    for x, y in zip(got, without):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,l,heads", [(5, 300, 24), (7, 71, 24), (3, 130, 2)])
def test_dbias_slab_sum_in_kernel_order(b, l, heads):
    """A shared bias's d(bias), summed as attn_bwd_dkv does with the slab:
    per (key tile, head, chunk) a 64 x (width + 8) slab starts at zero, each
    batch row of the chunk adds its ds^T tile by tile (element (key, query)
    always at slab[key][query], inside the row's width), the slab is written
    once as plane z; then the planes are added in chunk order."""
    plan = tfa.bwd_plan(b, l, heads, True)
    assert plan.dkv_slab
    q, k, v, g, rel, kb = _inputs(l, "shared", True, b=b, h=heads, d=8, seed=1)
    args = [_torch(x) for x in (q, k, v, g)]
    batched = torch.as_tensor(np.broadcast_to(rel, (b,) + rel.shape).copy())
    ds = tfa.flash_attention_bwd_plain(*args, batched, _torch(kb), SCALING, heads)[3]
    want = tfa.flash_attention_bwd_plain(*args, _torch(rel), _torch(kb), SCALING, heads)[3]
    tiles = plan.tiles
    width = T * (tiles.n_tiles - 1) + tiles.tail
    stride = width + 8
    partial = torch.full((plan.chunks, heads, l, l), float("nan"))
    for z in range(plan.chunks):
        rows = range(z * plan.b_chunk, min(b, (z + 1) * plan.b_chunk))
        for h in range(heads):
            for k0 in range(0, l, T):
                nkeys = min(T, l - k0)
                slab = torch.zeros(T, stride)
                for bi in rows:
                    for it in range(tiles.n_tiles):
                        q0 = it * T
                        w = T if it + 1 < tiles.n_tiles else tiles.tail
                        assert q0 + w <= width < stride
                        tile = torch.zeros(T, w)  # keys x queries; 0 past L
                        nq = min(w, l - q0)
                        tile[:nkeys, :nq] = ds[bi, h, q0:q0 + nq, k0:k0 + nkeys].t()
                        slab[:, q0:q0 + w] += tile
                partial[z, h, :, k0:k0 + nkeys] = slab[:nkeys, :l].t()
    got = partial[0].clone()
    for z in range(1, plan.chunks):
        got += partial[z]
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,bias", [(2056, None), (65535, None), (65536, None),
                                    (65536, "batched"), (200000, None), (65536, "shared")])
def test_dkv_grid_z_stays_within_cuda_limit(b, bias):
    """The dk/dv kernel's chunks sit on grid z, which CUDA caps at 65535:
    without a shared bias one batch row a block up to B = 65535 (2056 is the
    video trunk's temporal attention at B=8: 8 clips x 257 tokens), then
    ceil(B / 65535) rows a block; the chunks cover the batch once, in
    order."""
    plan = tfa.bwd_plan(b, 32, 24, bias == "shared")
    assert plan.chunks <= tfa.GRID_Z_MAX == 65535
    assert plan.chunks * plan.b_chunk >= b > (plan.chunks - 1) * plan.b_chunk
    if bias != "shared":
        assert plan.b_chunk == (1 if b <= 65535 else -(-b // 65535))
        assert not plan.dkv_slab
    covered = torch.zeros(b, dtype=torch.int64)
    for z in range(plan.chunks):
        covered[z * plan.b_chunk:min(b, (z + 1) * plan.b_chunk)] += 1
    assert bool((covered == 1).all())


def _leaves(l=10, b=2, h=4, d=16):
    q, k, v, _, rel, _ = _inputs(l, "shared", False, b=b, h=h, d=d)
    leaves = [torch.tensor(x.reshape(b, l, h, d), requires_grad=True) for x in (q, k, v)]
    return leaves, torch.tensor(rel, requires_grad=True)


def test_function_writes_stats_only_for_a_gradient(monkeypatch):
    """No statistics under inference_mode or no_grad (or without an input
    needing a gradient); with a gradient the forward writes them, saves them
    and the backward starts from them."""
    calls, bwd_stats = [], []
    plain, bwd_plain = tfa.flash_attention_plain, tfa.flash_attention_bwd_plain

    def fwd(*args, with_stats=False):
        calls.append(with_stats)
        return plain(*args, with_stats=with_stats)

    def bwd(*args, stats=None):
        bwd_stats.append(stats)
        return bwd_plain(*args, stats=stats)

    monkeypatch.setattr(tfa, "flash_attention_plain", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", bwd)
    leaves, rel = _leaves()
    with torch.inference_mode():
        tfa.flash_attention(*leaves, rel, None, SCALING)
    with torch.no_grad():
        tfa.flash_attention(*leaves, rel, None, SCALING)
    tfa.flash_attention(*(x.detach() for x in leaves), rel.detach(), None, SCALING)
    assert calls == [False, False, False]
    out = tfa.flash_attention(*leaves, rel, None, SCALING)
    assert calls[-1] is True
    saved = out.grad_fn.next_functions[0][0].saved_tensors
    assert saved[-1].shape == (2, 2, 4, 10) and saved[-1].dtype == torch.float32
    grads = torch.autograd.grad(out.square().sum(), [*leaves, rel])
    assert len(bwd_stats) == 1 and bwd_stats[0] is saved[-1]
    assert all(torch.isfinite(x).all() for x in grads)


def test_remat_recompute_writes_stats(monkeypatch):
    """Under activation checkpointing the recomputed forward writes the
    statistics again and the backward starts from those."""
    calls = []
    plain = tfa.flash_attention_plain

    def fwd(*args, with_stats=False):
        calls.append(with_stats)
        return plain(*args, with_stats=with_stats)

    monkeypatch.setattr(tfa, "flash_attention_plain", fwd)
    leaves, rel = _leaves()
    out = checkpoint(lambda *x: tfa.flash_attention(*x, None, SCALING), *leaves, rel,
                     use_reentrant=False)
    got = torch.autograd.grad(out.square().sum(), [*leaves, rel])
    assert calls == [True, True]
    monkeypatch.setattr(tfa, "flash_attention_plain", plain)
    want = torch.autograd.grad(tfa.flash_attention(*leaves, rel, None, SCALING).square().sum(),
                               [*leaves, rel])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
