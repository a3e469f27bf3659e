"""The det attention backward kernels' plan (``ops/det_attention.py:bwd_plan``)
and the index and reduction arithmetic of ``csrc/det_attention_bwd.cu``, on
the CPU.

Where the plan stages (wg in 8, 16, 32, 64), pass 1 (one block per q tile,
walking the key tiles) reads toep from a slab of rows staged per tile pair,
bw from registers loaded once, and bh from the tile's staged grid rows (at
wg = 64 folded into the row's lse), and sums dbw in the registers of the
thread owning (q, kx) and dbh per grid row in registers and two quad
shuffles; pass 2 (one block per key tile, walking the q tiles, keys as rows)
reads the same slab transposed, the q tile's staged bw rows, and a table of
lse - bh.  Here the walks are done in torch with the kernels' offsets,
clamps and order of sums, held to ``bias_from_toeplitz`` + the decomposed
bias and to ``det_attention_bwd_plain``'s dbh and dbw; every offset must lie
inside what the plan allocates.  The kernels run on the card
(``chip_smoke.py`` phase 12(a))."""

import shutil

import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu_torch.ops import build
from one_peace_tpu_torch.ops import det_attention as tda

T = tda.FWD_TILE
GRIDS = [(8, 8), (16, 16), (32, 32), (1, 64), (64, 64), (3, 16), (5, 32)]


def _tiles(length):
    return range(0, length, T)


def _pairs(length, seed, most=6):
    """The tiles of a grid, or its first, last and a seeded sample of the
    rest when there are more than `most`."""
    tiles = list(_tiles(length))
    if len(tiles) <= most:
        return tiles
    rs = np.random.RandomState(seed)
    return sorted({tiles[0], tiles[-1], *rs.choice(tiles[1:-1], most - 2, replace=False).tolist()})


def _operands(hg, wg, seed):
    l = hg * wg
    rs = np.random.RandomState(seed)
    toep = torch.from_numpy(rs.randn(2 * hg - 1, wg, wg).astype(np.float32))
    bh = torch.from_numpy(rs.randn(hg, l).astype(np.float32))
    bw = torch.from_numpy(rs.randn(l, wg).astype(np.float32))
    return toep, bh, bw


def _full_bias(toep, bh, bw, hg, wg):
    """(L, L) toep + bh + bw of one head."""
    x = tda.bias_from_toeplitz(toep[None], hg, wg)[0]
    x = x + bh.t().repeat_interleave(wg, dim=1)  # [q, ky] -> [q, key]
    return x + bw.repeat(1, hg)  # [q, kx] -> [q, key]


def _thread_coords():
    """Per element (row, col) of a 64 x 64 tile in the mma accumulator layout:
    j (8-column group), t (column pair in the quad), c (column in the pair)."""
    col = torch.arange(T)
    return col // 8, (col % 8) // 2, col % 2


def _stage(src, r0, rows, stride, width):
    """``stage_rows_f32``: rows r0 .. r0 + rows - 1 of the (total, width)
    matrix into rows `stride` apart (NaN in the padding), zeros outside it."""
    total = src.shape[0]
    out = torch.full((rows, stride), float("nan"))
    out[:, :width] = 0.0
    fr = torch.arange(r0, r0 + rows)
    ok = (fr >= 0) & (fr < total)
    out[ok, :width] = src[fr[ok]]
    return out


def _stage_bh(bh, ky_lo, nr, q0, hg, l):
    """``stage_bh``: bh rows ky_lo .. ky_lo + nr - 1, queries q0 .. q0 + 63,
    zeros outside the grid."""
    out = torch.zeros(nr, T)
    for y in range(nr):
        if ky_lo + y < hg:
            width = min(T, l - q0)
            out[y, :width] = bh[ky_lo + y, q0:q0 + width]
    return out


def pass1_bias_tile(toep, bh, bw, hw, plan, q0, k0):
    """The (64, 64) bias tile of one (batch, head) at (q0, k0) as pass 1
    reads it: a float2 of the staged slab at toff[r] + ((nr - 1 - kyl) << lw)
    * q_stride + (8j & (wg - 1)), bw from the registers loaded once (rows
    clamped to L - 1), bh from the staged grid rows (at nr = 1 the kernel
    subtracts it from the row's lse; here it is added back).  Asserts every
    offset lies inside the staged buffers.  Rows and keys >= L are garbage
    the kernel masks."""
    hg, wg = hw
    l, qs, nr = hg * wg, plan.q_stride, plan.tile_rows
    lw = wg.bit_length() - 1
    ky_lo = k0 >> lw
    slab = _stage(toep.reshape(-1, wg), q0 + (hg - nr - ky_lo) * wg, plan.slab_rows, qs, wg)
    bhs = _stage_bh(bh, ky_lo, nr, q0, hg, l)
    j, t, c = _thread_coords()
    rl = torch.arange(T)[:, None]
    kyl = (8 * j) >> lw
    toff = rl * qs + 2 * t
    t_idx = toff + ((nr - 1 - kyl) << lw) * qs + ((8 * j) & (wg - 1)) + c
    assert t_idx.min() >= 0 and t_idx.max() < plan.slab_rows * qs
    assert ((t_idx % qs) < wg).all()  # never the padding
    h_idx = kyl * T + rl
    assert h_idx.max() < nr * T
    bw_row = torch.clamp(q0 + rl, max=l - 1)
    w_val = bw[bw_row, 8 * (j & (wg // 8 - 1)) + 2 * t + c]
    return slab.reshape(-1)[t_idx] + w_val + bhs.reshape(-1)[h_idx]


def pass2_bias_tile(toep, bh, bw, hw, plan, k0, q0):
    """The (64 keys, 64 queries) bias tile at (k0, q0) as pass 2 reads it:
    the slab (staged as in pass 1, at k_stride) at toff[r] + (8j + c) *
    k_stride, bw's staged rows at woff[r] + (8j + c) * k_stride, and bh from
    the q tile's table of lse - bh (lse = 0 here, so the bias is slab + bw -
    table).  Asserts every offset lies inside the staged buffers."""
    hg, wg = hw
    l, ks, nr = hg * wg, plan.k_stride, plan.tile_rows
    lw = wg.bit_length() - 1
    ky_lo = k0 >> lw
    slab = _stage(toep.reshape(-1, wg), q0 + (hg - nr - ky_lo) * wg, plan.slab_rows, ks, wg)
    bws = _stage(bw, q0, T, ks, wg)
    table = torch.zeros(nr + 1, T)  # lse - bh per grid row y of the key tile; then delta
    width, rows = min(T, l - q0), min(nr, hg - ky_lo)
    table[:rows, :width] = -bh[ky_lo:ky_lo + rows, q0:q0 + width]
    j, t, c = _thread_coords()
    kr = torch.arange(T)[:, None]
    y, kx = kr >> lw, kr & (wg - 1)
    toff = (((nr - 1 - y) << lw) + 2 * t) * ks + kx
    woff = 2 * t * ks + kx
    loff = y * T + 2 * t
    t_idx, w_idx, l_idx = toff + (8 * j + c) * ks, woff + (8 * j + c) * ks, loff + 8 * j + c
    assert t_idx.min() >= 0 and t_idx.max() < plan.slab_rows * ks
    assert w_idx.max() < T * ks and l_idx.max() < nr * T
    assert ((t_idx % ks) < wg).all() and ((w_idx % ks) < wg).all()
    return slab.reshape(-1)[t_idx] + bws.reshape(-1)[w_idx] - table.reshape(-1)[l_idx]


@pytest.mark.parametrize("hw", GRIDS)
def test_pass1_walk_reads_the_bias(hw):
    """The (q tile, key tile) pairs (all, or the first, last and a seeded
    sample) read pass 1's way equal the materialised toep + bh + bw on the
    valid rows and keys."""
    hg, wg = hw
    l = hg * wg
    toep, bh, bw = _operands(hg, wg, hg * 100 + wg)
    plan = tda.bwd_plan(hg, wg)
    assert plan.mode == tda.BWD_SLAB
    full = _full_bias(toep, bh, bw, hg, wg)
    for q0 in _pairs(l, wg):
        for k0 in _pairs(l, hg):
            got = pass1_bias_tile(toep, bh, bw, hw, plan, q0, k0)
            nq, nk = min(T, l - q0), min(T, l - k0)
            torch.testing.assert_close(got[:nq, :nk], full[q0:q0 + nq, k0:k0 + nk],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", GRIDS)
def test_pass2_walk_reads_the_bias(hw):
    """The (key tile, q tile) pairs read pass 2's way (keys as rows) equal
    the transposed materialised bias on the valid keys and queries."""
    hg, wg = hw
    l = hg * wg
    toep, bh, bw = _operands(hg, wg, hg * 100 + wg + 1)
    plan = tda.bwd_plan(hg, wg)
    full = _full_bias(toep, bh, bw, hg, wg)
    for k0 in _pairs(l, wg):
        for q0 in _pairs(l, hg):
            got = pass2_bias_tile(toep, bh, bw, hw, plan, k0, q0)
            nk, nq = min(T, l - k0), min(T, l - q0)
            torch.testing.assert_close(got[:nk, :nq], full[q0:q0 + nq, k0:k0 + nk].t(),
                                       rtol=0, atol=1e-5)


def pass1_bias_sums(ds, hw):
    """dbh (hg, L) and dbw (L, wg) from one (batch, head)'s fp32 ds (L, L)
    summed as pass 1 sums them: dbw[q, kx] in the owner thread's registers
    over the key tiles and, within a tile, over the 8-column groups j with
    8j = kx mod wg, in ascending order; dbh[ky, q] per tile, thread t of
    the quad adding its columns 2t, 2t + 1 of each group j of grid row ky
    in order, then (x0 + x1) + (x2 + x3) across the quad (xor 1, then xor
    2), written once."""
    hg, wg = hw
    l = hg * wg
    lw = wg.bit_length() - 1
    nr, nj = T // wg, wg // 8
    dbh = torch.full((hg, l), float("nan"))
    dbw = torch.full((l, wg), float("nan"))
    for q0 in _tiles(l):
        rows = slice(q0, min(q0 + T, l))
        acc = torch.zeros(rows.stop - q0, wg)
        for k0 in _tiles(l):
            tile = torch.zeros(rows.stop - q0, T)
            tile[:, :min(T, l - k0)] = ds[rows, k0:k0 + T]  # keys >= L get p = 0
            for j in range(8):
                kx0 = 8 * (j & (nj - 1))
                acc[:, kx0:kx0 + 8] += tile[:, 8 * j:8 * j + 8]
            x = torch.zeros(rows.stop - q0, nr, 4)
            for j in range(8):
                for c in range(2):
                    x[:, (8 * j) >> lw] += tile[:, 8 * j + 2 * torch.arange(4) + c]
            sums = (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])
            ky_lo = k0 >> lw
            for y in range(nr):
                if ky_lo + y < hg:
                    dbh[ky_lo + y, rows] = sums[:, y]
        dbw[rows] = acc
    return dbh, dbw


def _plain_ds(q, k, v, bh, bw, out, dout, lse, hw, scaling):
    """ds as ``det_attention_bwd_plain`` forms it, (B, H, L, L)."""
    b, l, hdim = q.shape
    qh, kh, vh, gh, oh = (x.reshape(b, l, 1, hdim) for x in (q, k, v, dout, out))
    p = torch.exp(tda._biased_logits(qh, kh, None, bh, bw, hw, scaling) - lse[..., None])
    delta = (gh * oh).sum(-1).transpose(1, 2)
    return p * (torch.einsum("bqhd,bkhd->bhqk", gh, vh) - delta[..., None])


@pytest.mark.parametrize("hw", GRIDS)
def test_pass1_sums_equal_the_plain_bias_gradients(hw):
    """On the same ds, pass 1's walk (kernel order) gives
    ``det_attention_bwd_plain``'s dbh and dbw to 1e-6 relative to the sums
    of the magnitudes they add (a one-row grid's dbh, the sum of ds over all
    keys, is 0 up to rounding, so its own magnitude is no scale)."""
    hg, wg = hw
    l = hg * wg
    rs = np.random.RandomState(hg * 7 + wg)
    q, k, v, dout = (torch.from_numpy(rs.randn(1, l, 16).astype(np.float32)) for _ in range(4))
    bh = torch.from_numpy(0.5 * rs.randn(1, 1, hg, l).astype(np.float32))
    bw = torch.from_numpy(0.5 * rs.randn(1, 1, l, wg).astype(np.float32))
    out, lse = tda.det_attention_plain(q, k, v, None, bh, bw, hw, 0.25, 1, with_lse=True)
    _, _, _, _, dbh, dbw = tda.det_attention_bwd_plain(q, k, v, None, bh, bw, out, dout, lse,
                                                        hw, 0.25, 1)
    ds = _plain_ds(q, k, v, bh, bw, out, dout, lse, hw, 0.25)[0, 0]
    got_h, got_w = pass1_bias_sums(ds, hw)
    mag = ds.abs().view(hg, wg, hg, wg)  # [qy, qx, ky, kx]
    scale_h = mag.sum(-1).reshape(l, hg).t().max().item()
    scale_w = mag.sum(-2).reshape(l, wg).max().item()
    for got, want, scale in ((got_h, dbh[0, 0], scale_h), (got_w, dbw[0, 0], scale_w)):
        assert torch.isfinite(got).all()  # every element written
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)


def test_plans_of_the_main_path():
    """The 1024 px global grid stages one 64-row slab per tile pair and fits
    two blocks per SM in every pass; its windows stage 4 grid rows a tile,
    and their dtoep pass fits three blocks per SM; the ragged 800 px grid, an
    80 x 80 one and grids narrower than 8 gather."""
    per_sm = 228 * 1024  # shared memory of an H100 SM; each block also reserves 1 KB
    glob = tda.bwd_plan(64, 64)
    assert glob[:5] == (tda.BWD_SLAB, 1, 64, 72, 68)
    assert max(glob.dq_smem, glob.dkv_smem, glob.dtoep_smem) <= per_sm // 2 - 1024
    win = tda.bwd_plan(16, 16)
    assert win[:5] == (tda.BWD_SLAB, 4, 112, 24, 20)
    assert win.dtoep_smem <= per_sm // 3 - 1024
    for hw in ((50, 50), (80, 80), (4, 4), (2, 2), (8, 12)):
        assert tda.bwd_plan(*hw).mode == tda.BWD_GATHER


def _sample_grids():
    rs = np.random.RandomState(8)
    grids = {(int(a), int(b)) for a, b in rs.randint(1, 97, (40, 2))}
    return sorted(grids | {(64, 64), (16, 16), (32, 32), (8, 8), (1, 64), (50, 50), (80, 80),
                           (96, 96), (1, 1), (96, 8), (2, 96), (3, 16), (96, 64)})


@pytest.mark.parametrize("hw", _sample_grids())
def test_plan_covers_every_tile_pair(hw):
    """Brute force over the tile pairs of a seeded sample of grids with hg, wg
    in 1..96: shared memory fits a block and matches the layouts; the plan
    stages exactly where a 64-key tile is whole grid rows of a width
    divisible by 8; there, for every valid (query, key) of a pair, the
    staged slab row that pass 1 and pass 2 read is toep's row (qy - ky + hg
    - 1) * wg + qx (never a zero-filled one), and every offset lies inside
    the slab; the grid rows a tile holds are 64 // wg."""
    hg, wg = hw
    l = hg * wg
    for has_toep, has_decomp in ((True, True), (True, False), (False, True), (False, False)):
        plan = tda.bwd_plan(hg, wg, has_toep, has_decomp)
        assert max(plan.dq_smem, plan.dkv_smem, plan.dtoep_smem) <= 227 * 1024
        assert plan.q_stride >= wg and plan.q_stride % 16 == 8
        assert plan.k_stride >= wg and plan.k_stride % 16 == 4
        staged = wg in (8, 16, 32, 64)
        assert plan.mode == (tda.BWD_SLAB if staged else tda.BWD_GATHER)
        assert plan[5:] == tda._bwd_smem_bytes(plan.mode, has_toep, has_decomp, wg,
                                               plan.tile_rows, plan.slab_rows, plan.q_stride,
                                               plan.k_stride)
    plan = tda.bwd_plan(hg, wg)
    if plan.mode != tda.BWD_SLAB:
        return
    lw, nr = wg.bit_length() - 1, plan.tile_rows
    assert nr == T // wg and plan.slab_rows == T + (nr - 1) * wg
    total = (2 * hg - 1) * wg
    tiles = list(_tiles(l))
    rs = np.random.RandomState(hg * 97 + wg)
    pick = tiles if len(tiles) <= 8 else sorted(
        {tiles[0], tiles[-1], *rs.choice(tiles, 6, replace=False).tolist()})
    a = torch.arange(T)
    for q0 in pick:
        for k0 in pick:
            ky_lo = k0 >> lw
            r0 = q0 + (hg - nr - ky_lo) * wg
            q, key = q0 + a[:, None], k0 + a[None, :]
            valid = (q < l) & (key < l)
            want = (q // wg - key // wg + hg - 1) * wg + q % wg
            # pass 1: slab row rl + (nr - 1 - kyl) * wg; pass 2 reads the same row
            row = a[:, None] + (nr - 1 - (a[None, :] >> lw)) * wg
            assert row.min() >= 0 and row.max() < plan.slab_rows
            assert (r0 + row)[valid].eq(want[valid]).all()
            assert ((r0 + row)[valid] >= 0).all() and ((r0 + row)[valid] < total).all()


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """The kernels share ``csrc/wgmma_tiles.cuh``: a changed header (or a new
    one) gives every library a new name, so a stale build is never reused;
    an unchanged tree gives the same name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("det_attention_fwd", "det_attention_bwd", "int8_matmul")
    before = {n: build.library_path(n) for n in names}
    assert before == {n: build.library_path(n) for n in names}
    header = csrc / "wgmma_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: build.library_path(n) for n in names}
    assert all(edited[n] != before[n] for n in names)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build.library_path(n) != edited[n] for n in names)
