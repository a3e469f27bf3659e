"""The det attention forward kernel's plan (``ops/det_attention.py:fwd_plan``)
and the index arithmetic of ``csrc/det_attention_fwd.cu``, on the CPU.

Where the plan stages (wg even and dividing 64), the kernel stages, per
(64-row q tile, 64-key tile) pair, the toep rows the pair touches and bh's
rows of the tile's keys, holds bw in registers, and reads each score's bias
from them; elsewhere it gathers per score through a column table.  Here
``kernel_bias_tile`` does the same in torch -- the same staging, the same
offsets, the same clamps -- and the result is held to
``bias_from_toeplitz`` + the decomposed bias; every offset it forms, masked
columns included, must lie inside what the plan allocates.  The kernel itself
runs on the card (``chip_smoke.py`` phase 11(a))."""

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu_torch.ops import det_attention as tda

T = tda.FWD_TILE


def _tiles(length):
    return range(0, length, T)


def _full_bias(toep, bh, bw, hg, wg):
    """(L, L) toep + bh + bw of one head, in the kernel's order of sums."""
    l = hg * wg
    x = tda.bias_from_toeplitz(toep[None], hg, wg)[0]
    x = x + bh.t().repeat_interleave(wg, dim=1)  # [q, ky] -> [q, key]
    return x + bw.repeat(1, hg)  # [q, kx] -> [q, key]


def kernel_bias_tile(toep, bh, bw, hw, plan, q0, k0):
    """The (64, 64) bias tile of one (batch, head) at (q0, k0) as the bf16
    kernel builds it under ``plan``: rows >= L and keys >= L clamped as the
    kernel clamps them (their values are not used).  toep (2hg-1, wg, wg),
    bh (hg, L), bw (L, wg), fp32.  Returns the tile and asserts every offset
    lies inside the staged buffers (or the operands, for the gather)."""
    hg, wg = hw
    l, s = hg * wg, plan.stride
    rows = torch.arange(T)[:, None]
    cols = torch.arange(T)[None, :]
    qc = torch.clamp(q0 + rows, max=l - 1)  # the kernel's make_row clamp
    r = qc - q0
    ky_lo, ky_hi = k0 // wg, min(k0 + T - 1, l - 1) // wg
    if plan.mode == tda.FWD_GATHER:
        key = torch.clamp(k0 + cols, max=l - 1)
        ky, kx = key // wg, key % wg
        qy, qx = qc // wg, qc % wg
        t_idx = ((qy + hg - 1) * wg + qx) * wg + kx - ky * wg * wg
        h_idx, w_idx = ky * l + qc, qc * wg + kx
        for idx, src in ((t_idx, toep), (h_idx, bh), (w_idx, bw)):
            assert idx.min() >= 0 and idx.max() < src.numel()
        return toep.reshape(-1)[t_idx] + bh.reshape(-1)[h_idx] + bw.reshape(-1)[w_idx]

    # staging: toep rows r0 .. r0 + n - 1 (rows of wg, `stride` apart)
    total = (2 * hg - 1) * wg
    r0 = q0 + (hg - 1 - ky_hi) * wg
    n = min(T + (ky_hi - ky_lo) * wg, total - r0)
    assert 0 <= r0 and 0 < n <= plan.slab_rows
    slab = torch.full((plan.slab_rows, s), float("nan"))
    slab[:n, :wg] = toep.reshape(total, wg)[r0:r0 + n]
    bhs = torch.full((plan.tile_rows, T), float("nan"))
    width = min(T, l - q0)
    assert ky_hi - ky_lo + 1 <= plan.tile_rows
    bhs[:ky_hi - ky_lo + 1, :width] = bh[ky_lo:ky_hi + 1, q0:q0 + width]

    assert wg % 2 == 0 and T % wg == 0
    lw = wg.bit_length() - 1
    ncols = min(T, l - k0)
    span = (ncols - 1) >> lw
    colb = torch.clamp(cols - cols % 2, max=ncols - 2)  # the float2 pair's first column
    kyl = colb >> lw
    t_idx = r * s + (span - kyl) * wg * s + (colb & (wg - 1)) + cols % 2
    h_idx = kyl * T + r
    w_val = bw[qc, cols & (wg - 1)]  # the registers: bw[q, col % wg]
    assert t_idx.min() >= 0 and t_idx.max() < slab.numel()
    assert h_idx.min() >= 0 and h_idx.max() < bhs.numel()
    return slab.reshape(-1)[t_idx] + bhs.reshape(-1)[h_idx] + w_val


@pytest.mark.parametrize("mode", [None, tda.FWD_GATHER])
@pytest.mark.parametrize("hw", [(8, 8), (4, 6), (16, 16), (50, 50), (1, 64)])
def test_kernel_bias_tile_equals_the_bias(hw, mode):
    """Every (q tile, key tile) pair, built the kernel's way under the plan
    (and through the gather, which every grid can take), against the
    materialised toep + bh + bw on the valid rows and keys."""
    hg, wg = hw
    l = hg * wg
    rs = np.random.RandomState(hg * 100 + wg)
    toep = torch.from_numpy(rs.randn(2 * hg - 1, wg, wg).astype(np.float32))
    bh = torch.from_numpy(rs.randn(hg, l).astype(np.float32))
    bw = torch.from_numpy(rs.randn(l, wg).astype(np.float32))
    plan = tda.fwd_plan(hg, wg)
    if mode is not None:
        plan = plan._replace(mode=mode)
    full = _full_bias(toep, bh, bw, hg, wg)
    for q0 in _tiles(l):
        for k0 in _tiles(l):
            got = kernel_bias_tile(toep, bh, bw, hw, plan, q0, k0)
            nq, nk = min(T, l - q0), min(T, l - k0)
            torch.testing.assert_close(got[:nq, :nk], full[q0:q0 + nq, k0:k0 + nk],
                                       rtol=0, atol=1e-6)


def test_plans_of_the_main_path():
    """The 1024 px global grid stages one 64 x 64 slab per tile pair, its
    windows 7 displacements of 16 x 16; the ragged 800 px grid and a wide
    80 x 80 one gather; the bias-free launch stages nothing."""
    glob = tda.fwd_plan(64, 64)
    assert glob == tda.FwdPlan(tda.FWD_SLAB, 1, 1, 64, 72, 71168)
    win = tda.fwd_plan(16, 16)
    assert (win.mode, win.tile_rows, win.n_disp, win.slab_rows, win.stride) == (
        tda.FWD_SLAB, 4, 7, 112, 24)
    assert tda.fwd_plan(50, 50).mode == tda.fwd_plan(80, 80).mode == tda.FWD_GATHER
    assert tda.fwd_plan(8, 8).tile_rows == 8
    assert tda.fwd_plan(64, 64, False, False).smem_bytes == 2 * 2 * T * 64 * 2 + 1024


def _sample_grids():
    rs = np.random.RandomState(7)
    grids = {(int(a), int(b)) for a, b in rs.randint(1, 97, (40, 2))}
    return sorted(grids | {(64, 64), (16, 16), (50, 50), (1, 64), (8, 8), (80, 80), (96, 96),
                           (1, 1), (96, 1), (2, 96), (8, 120)})


@pytest.mark.parametrize("hw", _sample_grids())
def test_plan_covers_every_tile_pair(hw):
    """Brute force over the tile pairs of a seeded sample of grids with hg, wg
    in 1..96: the toep rows each pair touches lie in the staged range, its
    displacements qy - ky in n_disp of them, its key rows in tile_rows; the
    shared memory fits a block; the kernel stages exactly where every key
    tile holds whole grid rows with one column pattern."""
    hg, wg = hw
    l = hg * wg
    for has_toep, has_decomp in ((True, True), (True, False), (False, True), (False, False)):
        plan = tda.fwd_plan(hg, wg, has_toep, has_decomp)
        assert plan.smem_bytes <= 227 * 1024  # what a block may have on an H100
        assert plan.stride >= wg and plan.stride % 16 == 8
        regular = wg % 2 == 0 and T % wg == 0
        assert plan.mode == (tda.FWD_SLAB if regular else tda.FWD_GATHER)
        assert plan.smem_bytes == tda._fwd_smem_bytes(plan.mode, has_toep, has_decomp,
                                                      plan.tile_rows, plan.slab_rows, plan.stride)
    plan = tda.fwd_plan(hg, wg)
    q = torch.arange(l)
    qy, qx = q // wg, q % wg
    total = (2 * hg - 1) * wg
    tiles = list(_tiles(l))
    rs = np.random.RandomState(hg * 97 + wg)
    pick = tiles if len(tiles) <= 12 else sorted(
        {tiles[0], tiles[-1], *rs.choice(tiles, 10, replace=False).tolist()})
    for q0 in pick:
        qs = slice(q0, min(q0 + T, l))
        for k0 in tiles:
            ks = slice(k0, min(k0 + T, l))
            # every (q, key) of the pair, from the definition
            flat = ((qy[qs, None] - qy[None, ks] + hg - 1) * wg + qx[qs, None]).reshape(-1)
            disp = (qy[qs, None] - qy[None, ks]).reshape(-1)
            ky_lo, ky_hi = int(qy[ks].min()), int(qy[ks].max())
            r0 = q0 + (hg - 1 - ky_hi) * wg
            n = min(T + (ky_hi - ky_lo) * wg, total - r0)
            assert int(flat.min()) >= r0 and int(flat.max()) < r0 + n <= total
            assert n <= plan.slab_rows
            assert int(disp.max() - disp.min()) + 1 <= plan.n_disp
            assert ky_hi - ky_lo + 1 <= plan.tile_rows
