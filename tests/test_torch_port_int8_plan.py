"""The int8 GEMM kernel's index arithmetic, in torch on the CPU: the launch
plan (``gemm_plan``: tile, ring, shared memory, persistent grid, raster
group) and its walk over the output tiles, and an emulation of the kernel's
operand and epilogue paths (csrc/int8_matmul.cu): the 128-byte-swizzled,
zero-filled TMA boxes of x_q and w_q, read back at the addresses the wgmma
descriptors and their k32 steps give, summed in int32, then scaled in the
kernel's order and written as its two epilogues write them (TMA stores of
swizzled boxes, or thread stores through staging rows).
The emulation must equal ``int8_matmul_plain`` bit for bit, and the JAX
package's Pallas ``int8_matmul`` run in interpret mode."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cores  # noqa: F401  (torch's threads split between xdist workers)

from one_peace_tpu.ops import flash_attention as jfa
from one_peace_tpu.ops.quant_pallas import int8_matmul as jax_int8_matmul
from one_peace_tpu_torch.ops import int8_matmul as im

SHAPES = [(13, 100, 70), (260, 520, 515), (129, 272, 257), (300, 1536, 384)]  # (M, K, N)
SWIZZLE_ROW = 128  # bytes of K per box row


def _walk(plan):
    """Every block's tiles, in the order the kernel's blocks take them."""
    tiles = plan.tiles_m * plan.tiles_n
    return [[im.tile_coords(plan, t) for t in range(b, tiles, plan.grid)]
            for b in range(plan.grid)]


def _sampled_shapes():
    rng = np.random.RandomState(0)
    shapes = [(1, 1, 16), (64, 16, 6144), (127, 1536, 255), (128, 1536, 256),
              (4100, 1536, 6144), (65792, 1536, 6144), (65792, 6144, 1536),
              (16032, 6144, 1536), (1025, 48, 2049)]
    shapes += [(int(rng.randint(1, 5000)), int(rng.randint(1, 400)) * 16,
                int(rng.randint(1, 7000))) for _ in range(24)]
    return shapes


@pytest.mark.parametrize("num_sms", [132, 114, 66, 16, 7, 2, 1, 10 ** 6])
def test_plan_walk_covers_every_tile_once(num_sms):
    """Over sampled shapes (ragged M, N, K; M below one tile; tile counts
    that are no multiple of the SMs) and SM counts down to one and up to
    more than any shape's tiles, the blocks' walks cover every output tile
    exactly once, the grid is one block per SM or per tile, whichever is
    fewer, and the shared memory is the kernel's and fits."""
    for m, k, n in _sampled_shapes():
        plan = im.gemm_plan(m, n, k, num_sms)
        assert (plan.tile_m, plan.tile_n, plan.stages) == (im.GEMM_TILE_M, im.GEMM_TILE_N,
                                                           im.GEMM_STAGES)
        assert plan.smem_bytes == im.gemm_smem_bytes() <= im.SMEM_LIMIT
        assert plan.tiles_m == -(-m // 128) and plan.tiles_n == -(-n // 256)
        tiles = plan.tiles_m * plan.tiles_n
        assert plan.grid == min(tiles, num_sms)
        assert 1 <= plan.group <= plan.tiles_m
        seen = list(itertools.chain.from_iterable(_walk(plan)))
        assert len(seen) == tiles and len(set(seen)) == tiles
        assert all(0 <= mt < plan.tiles_m and 0 <= nt < plan.tiles_n for mt, nt in seen)


def test_plan_raster_groups():
    """Tiles in flight together share a few M-tiles: each raster group of
    ``group`` M-tiles is walked M fastest, its last group shorter."""
    plan = im.gemm_plan(10 * 128 + 5, 3 * 256, 1536, 132)
    assert (plan.tiles_m, plan.tiles_n, plan.group) == (11, 3, 8)
    order = [im.tile_coords(plan, t) for t in range(33)]
    assert order[:9] == [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (0, 1)]
    assert order[24:] == [(8, 0), (9, 0), (10, 0), (8, 1), (9, 1), (10, 1), (8, 2), (9, 2),
                          (10, 2)]


def test_plan_rejects_empty_problems():
    for args in ((0, 8, 16, 132), (8, 0, 16, 132), (8, 8, 0, 132), (8, 8, 16, 0)):
        with pytest.raises(ValueError):
            im.gemm_plan(*args)


def _box(a, r0, k0, rows):
    """The shared memory bytes of one TMA box: rows [r0, r0 + rows) x bytes
    [k0, k0 + 128) of the (R, K) int8 operand a, zeros beyond its edges,
    16-byte chunk c of box row r at r * 128 + ((c ^ (r & 7)) << 4)."""
    box = torch.zeros(rows, SWIZZLE_ROW, dtype=torch.int8)
    part = a[r0:r0 + rows, k0:k0 + SWIZZLE_ROW]
    box[:part.shape[0], :part.shape[1]] = part
    r = torch.arange(rows)[:, None]
    c = torch.arange(SWIZZLE_ROW)[None, :]
    addr = r * SWIZZLE_ROW + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)
    smem = torch.zeros(rows * SWIZZLE_ROW, dtype=torch.int8)
    smem[addr.reshape(-1)] = box.reshape(-1)
    return smem


def _desc_read(smem, row0, rows, ks):
    """The (rows, 32) int8 operand a wgmma k32 step ks reads through
    ``sw128_desc(tile + row0 * 128) + 2 * ks``: row r at the start + 1024
    (r >> 3) + 128 (r & 7) + byte, then the 128-byte swizzle, which XORs
    address bits 4-6 with bits 7-9."""
    r = torch.arange(rows)[:, None]
    b = torch.arange(32)[None, :]
    addr = row0 * SWIZZLE_ROW + 32 * ks + 1024 * (r >> 3) + 128 * (r & 7) + b
    return smem[addr ^ (((addr >> 7) & 7) << 4)]


@functools.lru_cache(maxsize=None)
def _operands(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x_q = torch.as_tensor(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w_q = torch.as_tensor(rng.randint(-127, 128, (n, k)).astype(np.int8))
    sx = torch.as_tensor((rng.rand(m) * 0.01 + 1e-4).astype(np.float32))
    sw = torch.as_tensor((rng.rand(n) * 0.01 + 1e-4).astype(np.float32))
    bias = torch.as_tensor(rng.randn(n).astype(np.float32))
    return x_q, w_q, sx, sw, bias


@functools.lru_cache(maxsize=None)
def _tile_sums(m, k, n):
    """{(m0, consumer): (64, 256) int32 sums} over the persistent walk, each
    from the TMA boxes of the wrapper's K (padded to a multiple of 16) read
    through the descriptors, four k32 steps per 128-byte stage."""
    x_q, w_q = _operands(m, k, n)[:2]
    kp = -(-k // 16) * 16
    x_q = torch.nn.functional.pad(x_q, (0, kp - k))
    w_q = torch.nn.functional.pad(w_q, (0, kp - k))
    plan = im.gemm_plan(m, n, kp, 132)
    sums = {}
    for block in _walk(plan):
        for mt, nt in block:
            m0, n0 = mt * plan.tile_m, nt * plan.tile_n
            acc = [torch.zeros(64, plan.tile_n, dtype=torch.int32) for _ in range(2)]
            for k0 in range(0, kp, SWIZZLE_ROW):
                a = _box(x_q, m0, k0, plan.tile_m)
                b = _box(w_q, n0, k0, plan.tile_n)
                for ks in range(SWIZZLE_ROW // 32):
                    bk = _desc_read(b, 0, plan.tile_n, ks).double()
                    for c in range(2):
                        ak = _desc_read(a, 64 * c, 64, ks).double()
                        acc[c] += (ak @ bk.T).to(torch.int32)  # exact: |.| < 2^53
            for c in range(2):
                sums[(m0 + 64 * c, n0)] = acc[c]
    return sums


TID = torch.arange(128)
WARP, G, T = TID >> 5, (TID & 31) >> 2, TID & 3


def _registers(acc):
    """(128 threads, 128) int32: d[4j + c] of thread tid is row 16w + g +
    8 (c >> 1), column 8j + 2t + (c & 1) of the warpgroup's (64, 256) sums."""
    i = torch.arange(128)
    j, c = i >> 2, i & 3
    return acc[(16 * WARP + G)[:, None] + 8 * (c >> 1)[None, :],
               (8 * j + (c & 1))[None, :] + 2 * T[:, None]]


def _scale(v, sx, sw, bias, rows, cols):
    y = v.float() * sx[rows] * sw[cols]
    return y if bias is None else y + bias[cols]


def _write_tile_tma(acc, m0, n0, sx, sw, bias, out, written):
    """One consumer's epilogue by TMA stores, 128 threads at once: per pass
    one box of 64 rows x 128 bytes, each thread's pairs scaled (acc * sx) *
    sw (+ b) in fp32 and written at their 128-byte-swizzled place; the
    store then copies box row r, column c to out[m0 + r, c0 + c], clipped
    at the edges."""
    m, n = out.shape
    size = out.element_size()
    box_cols = 128 // size
    regs = _registers(acc)
    r = torch.arange(64)[:, None]
    c = torch.arange(box_cols)[None, :]
    for pass_ in range(256 // box_cols):
        box = torch.full((64 * 128 // size,), float("nan"), dtype=out.dtype)
        for jj in range(box_cols // 8):
            j = pass_ * (box_cols // 8) + jj
            cols = n0 + 8 * j + 2 * T
            byte = (8 * jj + 2 * T) * size
            for h in range(2):
                row = 16 * WARP + G + 8 * h
                for e in range(2):
                    y = _scale(regs[:, 4 * j + 2 * h + e], sx, sw, bias,
                               (m0 + row).clamp(max=m - 1), (cols + e).clamp(max=n - 1))
                    at = row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15) + e * size
                    box[at // size] = y.to(out.dtype)
        byte = c * size
        image = box[(r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)) // size]
        rr, cc = m0 + r.expand_as(image), n0 + pass_ * box_cols + c.expand_as(image)
        keep = (rr < m) & (cc < n)
        out[rr[keep], cc[keep]] = image[keep]
        written[rr[keep], cc[keep]] += 1


def _write_tile_threads(acc, m0, n0, sx, sw, bias, out, written):
    """One consumer's epilogue by thread stores (out's rows not a multiple
    of 16 bytes), 128 threads at once: the sums from the accumulator layout
    into staging rows of 40 int32, 32 columns at a time (int2 writes), read
    back as int4 along rows, scaled (acc * sx) * sw (+ b) in fp32 and
    stored as 4 outputs per thread."""
    m, n = out.shape
    tid, warp, g, t = TID, WARP, G, T
    regs = _registers(acc)
    col = (tid & 7) * 4
    for q in range(256 // 32):
        stage = torch.full((64 * 40,), -2 ** 31, dtype=torch.int32)
        for jj in range(4):
            for h in range(2):
                pos = (16 * warp + g + 8 * h) * 40 + jj * 8 + 2 * t
                stage[pos] = regs[:, 4 * (4 * q + jj) + 2 * h]
                stage[pos + 1] = regs[:, 4 * (4 * q + jj) + 2 * h + 1]
        for p in range(4):
            r = 16 * p + (tid >> 3)
            rows, cols = m0 + r[:, None], n0 + 32 * q + col[:, None] + torch.arange(4)[None, :]
            vals = stage[r[:, None] * 40 + col[:, None] + torch.arange(4)[None, :]]
            keep = (rows < m) & (cols < n)
            rr, cc, v = rows.expand_as(cols)[keep], cols[keep], vals[keep]
            out[rr, cc] = _scale(v, sx, sw, bias, rr, cc).to(out.dtype)
            written[rr, cc] += 1


def _emulate(m, k, n, out_dtype, with_bias):
    x_q, w_q, sx, sw, bias = _operands(m, k, n)
    out = torch.zeros(m, n, dtype=out_dtype)
    written = torch.zeros(m, n, dtype=torch.int32)
    write = _write_tile_tma if n * out.element_size() % 16 == 0 else _write_tile_threads
    for (m0, n0), acc in _tile_sums(m, k, n).items():
        write(acc, m0, n0, sx, sw, bias if with_bias else None, out, written)
    assert torch.equal(written, torch.ones_like(written))  # every output once
    return out


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_emulated_kernel_is_bit_equal_to_plain(m, k, n, out_dtype, with_bias):
    x_q, w_q, sx, sw, bias = _operands(m, k, n)
    want = im.int8_matmul_plain(x_q, w_q, sx, sw, bias if with_bias else None, out_dtype)
    got = _emulate(m, k, n, out_dtype, with_bias)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", SHAPES[:3])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_emulated_kernel_matches_pallas_interpret(monkeypatch, m, k, n, out_dtype):
    """The emulation against the Pallas kernel itself, interpreted (it has
    no bias; ``quantized_linear`` adds it outside)."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    x_q, w_q, sx, sw, _ = _operands(m, k, n)
    want = jax_int8_matmul(jnp.asarray(x_q.numpy()), jnp.asarray(w_q.numpy().T),
                           jnp.asarray(sx.numpy()), jnp.asarray(sw.numpy()),
                           out_dtype=getattr(jnp, out_dtype))
    got = _emulate(m, k, n, getattr(torch, out_dtype), False)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
