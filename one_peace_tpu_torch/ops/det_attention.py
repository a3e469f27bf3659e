"""The detection trunk's attention, forward and backward: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``one_peace_tpu/ops/det_attention.py`` (the Pallas TPU kernels
``_det_flash_fwd`` and the two passes of ``_det_flash_bwd``, under one
``custom_vjp``).  The trunk's layers attend over a grid of tokens (the
64 x 64 stride-16 grid at 1024 px in the global layers, 16 x 16 windows in
the others) with two additive biases:

- the shared rel-pos bucket bias, which depends only on the displacement
  between query and key, so its (H, L, L) form is block-Toeplitz: it enters
  as the factor ``toep[h, qy - ky + hg - 1, qx, kx]`` (``toeplitz_tables``),
  (H, 2hg-1, wg, wg) fp32, 50 MB at 64 x 64 against 1.6 GB gathered;
- the decomposed rel pos of detectron2's ``add_decomposed_rel_pos``,
  ``bh[b, h, ky, q] + bw[b, h, q, kx]`` (``compute_decomp``), computed from
  the unscaled q.

``det_flash_attention`` keeps the JAX signature and runs
``DetAttentionFunction``: CUDA tensors go to the kernels
(``csrc/det_attention_fwd.cu``, ``csrc/det_attention_bwd.cu``, built by
``ops/build.py`` at their first launch), CPU tensors to the plain versions,
in both directions, in fp32, bf16 or fp16 (q, k, v and the output; the biases,
their cotangents and the log-sum-exp are fp32 in every case).  There is no
fallback on the card: whatever the kernels do not take (a head dim other
than 64) raises.  ``compute_decomp`` stays
outside the Function, as in JAX, so the gradients of rel_h, rel_w and the
decomposed bias's share of dq come from autograd chained onto dbh and dbw.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.interpolate import bicubic_resize_matrix
from .build import DTYPE_CODES, build_library

HEAD_DIM = 64  # the only head dim the kernel takes (every shipped config)

# Kernel launches since the caller last set them to 0.  Only the CUDA
# wrappers add to them, once per call that the runtime accepted:
# ``launches`` for the forward kernel, ``bwd_launches`` for the backward
# (each call launches pass 1, the dtoep pass when there is a Toeplitz factor,
# and pass 2).
launches = 0
bwd_launches = 0


def interpolate_rel_table(table: torch.Tensor, src_bucket: int, dst_bucket: int) -> torch.Tensor:
    """Bicubic-resize the (2*src-1)^2+3 pretrain table to (2*dst-1)^2+3 with
    torch's ``F.interpolate`` weights (a = -0.75); the 3 CLS rows pass
    through."""
    if src_bucket == dst_bucket:
        return table
    src, dst = 2 * src_bucket - 1, 2 * dst_bucket - 1
    heads = table.shape[-1]
    grid = table[:-3].reshape(src, src, heads).float()
    w = torch.from_numpy(bicubic_resize_matrix(src, dst)).to(table.device)
    grid = torch.einsum("ri,ijh,cj->rch", w, grid, w)
    return torch.cat([grid.reshape(dst * dst, heads), table[-3:].float()], 0)


def toeplitz_tables(table: torch.Tensor, src_bucket: int, dst_bucket: int) -> torch.Tensor:
    """Pretrain rel table ((2*src-1)^2+3, heads) -> Toeplitz factor
    (heads, 2*dst-1, dst, dst) fp32: toep[h, dyi, qx, kx] =
    grid[h, dyi, qx-kx+dst-1], where grid is the bicubic-interpolated
    (2*dst-1, 2*dst-1) value grid (the CLS rows dropped: the trunk has no
    CLS token)."""
    d = 2 * dst_bucket - 1
    resized = interpolate_rel_table(table, src_bucket, dst_bucket)
    grid = resized[:-3].reshape(d, d, -1).permute(2, 0, 1)  # (heads, d, d)
    pos = torch.arange(dst_bucket, device=table.device)
    idx = pos[:, None] - pos[None, :] + dst_bucket - 1  # (dst, dst) in [0, d)
    return grid[:, :, idx].float().contiguous()


def bias_from_toeplitz(toep: torch.Tensor, hg: int, wg: int) -> torch.Tensor:
    """(heads, 2hg-1, wg, wg) -> the materialized (heads, L, L) bias."""
    pos = torch.arange(hg, device=toep.device)
    rows = toep[:, pos[:, None] - pos[None, :] + hg - 1]  # (heads, hg, hg, wg, wg)
    return rows.permute(0, 1, 3, 2, 4).reshape(toep.shape[0], hg * wg, hg * wg)


def compute_decomp(qh: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                   hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """bh (B, H, hg, L) [ky-major] and bw (B, H, L, wg), fp32 (fp64 for
    fp64 q), from the unscaled q (B, L, H, dh) and tables of (2hg-1, dh) /
    (2wg-1, dh), the products in q's dtype."""
    hg, wg = hw
    b, l, heads, dh = qh.shape
    qg = qh.reshape(b, hg, wg, heads, dh)
    pos_h = torch.arange(hg, device=qh.device)
    pos_w = torch.arange(wg, device=qh.device)
    rh = rel_h[pos_h[:, None] - pos_h[None, :] + hg - 1].to(qh.dtype)  # (hg, hg, dh) [qy, ky]
    rw = rel_w[pos_w[:, None] - pos_w[None, :] + wg - 1].to(qh.dtype)
    acc = _acc_dtype(qh)
    bh = torch.einsum("bhwnc,hkc->bnkhw", qg, rh).reshape(b, heads, hg, l).to(acc)
    bw = torch.einsum("bhwnc,wkc->bnhwk", qg, rw).reshape(b, heads, l, wg).to(acc)
    return bh, bw


def det_attention_plain(q, k, v, toep, bh, bw, hw: Tuple[int, int], scaling: float,
                        heads: int, with_lse: bool = False):
    """Plain version on the (B, L, H*Dh) layout (``_xla_core``): fp32 logits,
    ``* scaling``, + the Toeplitz bias, + bh + bw, fp32 softmax, probabilities
    cast to q's dtype before p.v.  With ``with_lse`` also the row
    log-sum-exp (B, H, L) fp32."""
    b, l, hdim = q.shape
    dh = hdim // heads
    qh, kh, vh = (x.reshape(b, l, heads, dh) for x in (q, k, v))
    logits = _biased_logits(qh, kh, toep, bh, bw, hw, scaling)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, l, hdim)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the CPU gradient checks)."""
    return torch.promote_types(x.dtype, torch.float32)


def _biased_logits(qh, kh, toep, bh, bw, hw, scaling):
    """fp32 (B, H, L, L) logits of (B, L, H, Dh) q and k, with the biases."""
    b, l, heads, _ = qh.shape
    hg, wg = hw
    acc = _acc_dtype(qh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.to(acc), kh.to(acc)) * scaling
    if toep is not None:
        logits += bias_from_toeplitz(toep, hg, wg)[None]
    if bh is not None:
        grid = logits.view(b, heads, l, hg, wg)
        grid += bh.transpose(2, 3)[..., None]
        grid += bw[..., None, :]
    return logits


def det_attention_bwd_plain(q, k, v, toep, bh, bw, out, dout, lse, hw: Tuple[int, int],
                            scaling: float, heads: int):
    """Plain version of the backward (``_make_bwd_dq_kernel`` and
    ``_make_bwd_dkv_kernel``'s formula) on the (B, L, H*Dh) layout, from the
    forward's ``out`` and row log-sum-exp ``lse`` (B, H, L) and the output's
    cotangent ``dout``.  Returns (dq, dk, dv, dtoep, dbh, dbw): the first
    three in q's dtype, the bias cotangents fp32 (None for an absent bias).

    p = exp(s - lse) from the fp32 logits; delta = rowsum(dout * out);
    dv = p^T dout with p in dout's dtype; ds = p (dout v^T - delta);
    dq = ds k * scaling and dk = ds^T q * scaling with ds in q's dtype;
    dbh = ds summed over kx, dbw over ky, and dtoep over the batch and over
    the (qy, ky) pairs of each displacement (``bias_from_toeplitz``'s
    transpose)."""
    b, l, hdim = q.shape
    hg, wg = hw
    dh = hdim // heads
    acc = _acc_dtype(q)
    qh, kh, vh, gh, oh = (x.reshape(b, l, heads, dh) for x in (q, k, v, dout, out))
    p = torch.exp(_biased_logits(qh, kh, toep, bh, bw, hw, scaling) - lse[..., None])
    gf = gh.to(acc)
    delta = (gf * oh.to(acc)).sum(-1).transpose(1, 2)  # (B, H, L)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).to(acc), gf)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vh.to(acc)) - delta[..., None])
    del p
    dsc = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsc, kh.to(acc)) * scaling
    dk = torch.einsum("bhqk,bqhd->bkhd", dsc, qh.to(acc)) * scaling
    del dsc
    dtoep = dbh = dbw = None
    grid = ds.view(b, heads, l, hg, wg)
    if bh is not None:
        dbh = grid.sum(-1).transpose(2, 3).contiguous()  # (B, H, hg, L)
        dbw = grid.sum(-2)  # (B, H, L, wg)
    if toep is not None:
        pos = torch.arange(hg, device=q.device)
        idx = (pos[:, None] - pos[None, :] + hg - 1).reshape(-1)  # (qy, ky) -> dy
        blocks = ds.sum(0).view(heads, hg, wg, hg, wg).permute(0, 1, 3, 2, 4)
        dtoep = torch.zeros(heads, 2 * hg - 1, wg, wg, dtype=acc, device=q.device)
        dtoep.index_add_(1, idx, blocks.reshape(heads, hg * hg, wg, wg))
    return (*(x.to(q.dtype).reshape(b, l, hdim) for x in (dq, dk, dv)), dtoep, dbh, dbw)


# How the 2-byte (bf16 or fp16) forward kernel reads the bias
# (``csrc/det_attention_fwd.cu``):
# per score from device memory, or from a slab of toep and bh's rows staged in
# shared memory per tile pair with bw held in registers.
FWD_GATHER, FWD_SLAB = 0, 1
FWD_TILE = 64  # query rows of a block and keys of a K/V tile


class FwdPlan(NamedTuple):
    """The 2-byte forward kernel's plan for one grid and set of biases."""
    mode: int        # FWD_GATHER or FWD_SLAB
    tile_rows: int   # the most grid rows one 64-token tile spans
    n_disp: int      # the most displacements qy - ky of any (q tile, key tile) pair
    slab_rows: int   # toep rows (wg floats each) staged per tile pair
    stride: int      # floats per staged toep row
    smem_bytes: int  # the launch's dynamic shared memory


def _fwd_smem_bytes(mode: int, has_toep: bool, has_decomp: bool, tile_rows: int,
                    slab_rows: int, stride: int) -> int:
    """``smem_layout`` of ``det_attention_fwd.cu``: K and V tiles (2-byte,
    double-buffered, 128-byte swizzled rows), then the toep slab and bh's
    rows (double-buffered) or the gather's column table, and 1024 bytes to
    align the tiles to the swizzle's 1024-byte atom."""
    n = 2 * 2 * FWD_TILE * HEAD_DIM * 2 + 1024
    if mode == FWD_SLAB:
        n += 2 * slab_rows * stride * 4 if has_toep else 0
        n += 2 * tile_rows * FWD_TILE * 4 if has_decomp else 0
    elif has_toep or has_decomp:
        n += 2 * 3 * FWD_TILE * 4
    return n


@functools.lru_cache(maxsize=None)
def fwd_plan(hg: int, wg: int, has_toep: bool = True, has_decomp: bool = True) -> FwdPlan:
    """Plan the 2-byte forward kernel on an (hg, wg) grid.  A (q tile at q0,
    key tile) pair whose keys span grid rows ky_lo..ky_hi reads toep's flat
    rows (qy - ky + hg - 1) * wg + qx = q + (hg - 1 - ky) * wg: the
    64 + (ky_hi - ky_lo) * wg rows from q0 + (hg - 1 - ky_hi) * wg on.  Where
    wg is even and divides 64 (the 64 x 64 grid, the 16 x 16 windows) every
    key tile holds whole grid rows with one column pattern: the kernel stages
    those rows in rows of a stride = 8 mod 16 floats (conflict-free float2
    reads of an mma fragment) with bh's rows, and holds bw in registers.  On
    other grids it gathers per score: staging there too, with bw's rows in
    shared memory and a per-tile column table, ran 2.3x (80 x 80) and 4.3x
    (50 x 50) slower than the gather on the card, at one block per SM."""
    l = hg * wg
    tile_rows = max((min(q0 + FWD_TILE, l) - 1) // wg - q0 // wg + 1
                    for q0 in range(0, l, FWD_TILE))
    n_disp = min(2 * tile_rows - 1, 2 * hg - 1)
    slab_rows = min(FWD_TILE + (tile_rows - 1) * wg, (2 * hg - 1) * wg)
    stride = wg + (8 - wg) % 16
    mode = FWD_SLAB if wg % 2 == 0 and FWD_TILE % wg == 0 else FWD_GATHER
    return FwdPlan(mode, tile_rows, n_disp, slab_rows, stride,
                   _fwd_smem_bytes(mode, has_toep, has_decomp, tile_rows, slab_rows, stride))


# How the 2-byte backward kernels read the bias (``csrc/det_attention_bwd.cu``):
# per score from device memory, or staged per tile in shared memory (toep's
# rows, bh's rows, and bw's in pass 2 and the dtoep pass) and registers (bw
# in pass 1), with dbh and dbw summed in registers.
BWD_GATHER, BWD_SLAB = 0, 1
TILE_BYTES = FWD_TILE * HEAD_DIM * 2  # a 128-byte-swizzled 2-byte Q/K/V/G tile
SWIZZLE_ALIGN = 1024  # the 2-byte kernels align their shared memory to the swizzle's atom


class BwdPlan(NamedTuple):
    """The 2-byte backward kernels' plan for one grid and set of biases."""
    mode: int        # BWD_GATHER or BWD_SLAB
    tile_rows: int   # grid rows of a 64-key tile (BWD_SLAB: 64 // wg)
    slab_rows: int   # toep rows staged per tile pair: 64 + (tile_rows - 1) * wg
    q_stride: int    # floats per staged row in pass 1: = 8 mod 16
    k_stride: int    # floats per staged row in pass 2: = 4 mod 16
    dq_smem: int     # dynamic shared memory of pass 1, pass 2 and the dtoep pass
    dkv_smem: int
    dtoep_smem: int


def dtoep_cols(wg: int) -> int:
    """Slab columns of one dtoep block's tile: 16, 32 or 64."""
    return 16 if wg <= 16 else 32 if wg <= 32 else 64


def _bwd_smem_bytes(mode: int, has_toep: bool, has_decomp: bool, wg: int, tile_rows: int,
                    slab_rows: int, q_stride: int, k_stride: int) -> Tuple[int, int, int]:
    """``dq_layout``, ``dkv_layout`` and ``dtoep_layout`` of
    ``det_attention_bwd.cu`` for a 2-byte type: six swizzled tiles each in passes 1
    and 2, then the staged bias (double-buffered in pass 1, single in pass
    2, with the q tile's lse, delta and bh rows) or the gather's ds
    staging, dbw sums and position tables; eight tiles and two item tables
    in the dtoep pass, with each item's bw rows; and 1024 bytes to align
    the tiles to the swizzle's atom where wgmma reads them (all but the
    dtoep pass's 16- and 32-wide items)."""
    tiles = 6 * TILE_BYTES
    if mode == BWD_SLAB:
        dq = (tiles + (2 * slab_rows * q_stride * 4 if has_toep else 0)
              + (2 * tile_rows * FWD_TILE * 4 if has_decomp else 0))
        dkv = (tiles + (slab_rows * k_stride * 4 if has_toep else 0)
               + (FWD_TILE * k_stride * 4 if has_decomp else 0)
               + 2 * (tile_rows + 2) * FWD_TILE * 4)
    else:
        staging = FWD_TILE * (FWD_TILE + 1) * 4
        dq = tiles + staging + (FWD_TILE * wg * 4 if has_decomp else 0) + 2 * 4 * FWD_TILE * 4
        dkv = tiles + 2 * 5 * FWD_TILE * 4 + staging
    cols = dtoep_cols(wg)
    bw_stride = 16 if cols == 16 else cols + 8
    dtoep = 8 * TILE_BYTES + 2 * 6 * FWD_TILE * 4 + (
        2 * FWD_TILE * bw_stride * 4 if has_decomp else 0)
    return dq + SWIZZLE_ALIGN, dkv + SWIZZLE_ALIGN, dtoep + (SWIZZLE_ALIGN if cols == 64 else 0)


@functools.lru_cache(maxsize=None)
def bwd_plan(hg: int, wg: int, has_toep: bool = True, has_decomp: bool = True) -> BwdPlan:
    """Plan the 2-byte backward kernels on an (hg, wg) grid.  Where wg is 8, 16,
    32 or 64 (the 64 x 64 grid, its 16 x 16 windows) a 64-token tile is
    64 // wg whole grid rows with one column pattern, so the kernels stage
    the bias: per (q tile at q0, key tile at ky_lo) pair toep's flat rows
    q + (hg - 1 - ky) * wg, the 64 + (64 // wg - 1) * wg rows from
    q0 + (hg - 64 // wg - ky_lo) * wg on (rows outside the factor are zeros),
    padded to a stride = 8 mod 16 floats for pass 1's float2 reads and = 4
    mod 16 for pass 2's scalar reads (both conflict-free); pass 1 holds bw
    and the dbw sums in registers and sums dbh per grid row in registers;
    pass 2 stages the q tile's bw rows and folds bh into its lse.  Narrower
    even grids would put the column pairs of one 8-key group in several grid
    rows, and ragged ones have no fixed column pattern: they gather per
    score (``fwd_plan`` found staging there lost at one block per SM)."""
    mode = BWD_SLAB if wg in (8, 16, 32, 64) else BWD_GATHER
    tile_rows = FWD_TILE // wg if mode == BWD_SLAB else 0
    slab_rows = FWD_TILE + (tile_rows - 1) * wg if mode == BWD_SLAB else 0
    q_stride, k_stride = wg + (8 - wg) % 16, wg + (4 - wg) % 16
    return BwdPlan(mode, tile_rows, slab_rows, q_stride, k_stride,
                   *_bwd_smem_bytes(mode, has_toep, has_decomp, wg, tile_rows, slab_rows,
                                    q_stride, k_stride))


@functools.lru_cache(maxsize=None)
def _library(which: str = "fwd") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(f"det_attention_{which}")))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if which == "fwd":
        lib.one_peace_det_attention_fwd.argtypes = [p] * 8 + [i] * 5 + [f] + [i] * 7 + [p]
        lib.one_peace_det_attention_fwd.restype = i
        lib.one_peace_det_error_string.argtypes = [i]
        lib.one_peace_det_error_string.restype = ctypes.c_char_p
    else:
        lib.one_peace_det_attention_bwd.argtypes = [p] * 15 + [i] * 5 + [f] + [i] * 7 + [p]
        lib.one_peace_det_attention_bwd.restype = i
        lib.one_peace_det_bwd_error_string.argtypes = [i]
        lib.one_peace_det_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, toep, bh, bw, hw, heads: int) -> None:
    """Raise on anything the kernel does not take (it has no fallback)."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"det attention kernel takes bf16, fp16 or fp32, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, L, H*Dh) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, hdim = q.shape
    hg, wg = hw
    if hdim != heads * HEAD_DIM:
        raise ValueError(f"det attention kernel takes head dim {HEAD_DIM} only; got "
                         f"{hdim} lanes over {heads} heads")
    if hg * wg != l:
        raise ValueError(f"grid {hg} x {wg} does not hold L = {l} tokens")
    if (bh is None) != (bw is None):
        raise ValueError("bh and bw come together")
    expected = {"toep": (heads, 2 * hg - 1, wg, wg), "bh": (b, heads, hg, l),
                "bw": (b, heads, l, wg)}
    for name, x in (("toep", toep), ("bh", bh), ("bw", bw)):
        if x is not None and (x.dtype != torch.float32 or tuple(x.shape) != expected[name]):
            raise ValueError(f"{name} must be fp32 {expected[name]}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    tensors = [x for x in (q, k, v, toep, bh, bw) if x is not None]
    for x in tensors:
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"det attention kernel needs every input on one CUDA device; "
                             f"got {[str(t.device) for t in tensors]}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("det attention kernel needs contiguous, 16-byte aligned inputs")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def det_attention_cuda(q, k, v, toep, bh, bw, hw: Tuple[int, int], scaling: float,
                       heads: int, with_lse: bool = False):
    """Launch the forward kernel; arguments and results as
    ``det_attention_plain``."""
    global launches
    _check_kernel_inputs(q, k, v, toep, bh, bw, hw, heads)
    lib = _library()
    b, l, _ = q.shape
    plan = fwd_plan(hw[0], hw[1], toep is not None, bh is not None)
    out = torch.empty_like(q)
    lse = (torch.empty(b, heads, l, dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = lib.one_peace_det_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(toep), _ptr(bh), _ptr(bw),
        out.data_ptr(), _ptr(lse), b, l, heads, hw[0], hw[1], float(scaling),
        DTYPE_CODES[q.dtype], plan.mode, plan.tile_rows, plan.slab_rows, plan.stride,
        plan.smem_bytes, q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"det attention kernel launch failed: "
                           f"{lib.one_peace_det_error_string(err).decode()} ({err})")
    launches += 1
    return (out, lse) if with_lse else out


def det_attention_bwd_cuda(q, k, v, toep, bh, bw, out, dout, lse, hw: Tuple[int, int],
                           scaling: float, heads: int, need_dtoep: bool = True,
                           passes: int = 7):
    """Launch the backward kernels; arguments and results as
    ``det_attention_bwd_plain`` (dtoep is None when ``need_dtoep`` is
    False).  delta = rowsum(dout * out) is one small torch op here, as the
    JAX package computes it in XLA outside the Pallas calls.  ``passes``
    times one kernel alone (a bit mask: 1 pass 1, 2 the dtoep pass, 4
    pass 2); the outputs of the others are then left unwritten."""
    global bwd_launches
    _check_kernel_inputs(q, k, v, toep, bh, bw, hw, heads)
    b, l, _ = q.shape
    for name, x in (("out", out), ("dout", dout)):
        if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} must match q: {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"det attention kernel needs a contiguous, 16-byte aligned {name}")
    if (lse.dtype != torch.float32 or lse.shape != (b, heads, l) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be contiguous fp32 ({b}, {heads}, {l}) on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    lib = _library("bwd")
    plan = bwd_plan(hw[0], hw[1], toep is not None, bh is not None)
    delta = (dout.float() * out.float()).view(b, l, heads, HEAD_DIM).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dtoep = torch.empty_like(toep) if toep is not None and need_dtoep else None
    dbh = torch.empty_like(bh) if bh is not None else None
    dbw = torch.empty_like(bw) if bw is not None else None
    err = lib.one_peace_det_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(toep), _ptr(bh), _ptr(bw), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(dtoep), _ptr(dbh), _ptr(dbw), b, l, heads, hw[0], hw[1],
        float(scaling), DTYPE_CODES[q.dtype], passes, plan.mode, plan.dq_smem,
        plan.dkv_smem, plan.dtoep_smem, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"det attention backward kernel launch failed: "
                           f"{lib.one_peace_det_bwd_error_string(err).decode()} ({err})")
    bwd_launches += 1
    return dq, dk, dv, dtoep, dbh, dbw


class DetAttentionFunction(torch.autograd.Function):
    """The det attention on the (B, L, H*Dh) layout with its gradient
    (``_det_attention_core``'s ``custom_vjp``): the kernels for CUDA
    tensors, the plain versions for CPU tensors.  When a gradient will be
    taken (an input needs one) the forward also writes the row log-sum-exp
    and saves it with its inputs and output; under ``no_grad`` or
    ``inference_mode`` nothing extra is written.  The backward recomputes
    the probabilities from them.  A bias that is absent, or needs no
    gradient, gets None."""

    @staticmethod
    def forward(ctx, q, k, v, toep, bh, bw, hw, scaling: float, heads: int,
                grad_wanted: bool):
        # grad_wanted: torch.is_grad_enabled() at the call (inside forward
        # grad mode is off, and needs_input_grad ignores no_grad and
        # inference_mode)
        fwd = det_attention_plain if q.device.type == "cpu" else det_attention_cuda
        if not (grad_wanted and any(ctx.needs_input_grad[:6])):
            return fwd(q, k, v, toep, bh, bw, hw, scaling, heads)
        out, lse = fwd(q, k, v, toep, bh, bw, hw, scaling, heads, with_lse=True)
        ctx.save_for_backward(q, k, v, toep, bh, bw, out, lse)
        ctx.hw, ctx.scaling, ctx.heads = hw, scaling, heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, toep, bh, bw, out, lse = ctx.saved_tensors
        need = ctx.needs_input_grad
        args = (q, k, v, toep, bh, bw, out, g.contiguous(), lse, ctx.hw, ctx.scaling, ctx.heads)
        if q.device.type == "cpu":
            grads = det_attention_bwd_plain(*args)
        else:
            grads = det_attention_bwd_cuda(*args, need_dtoep=need[3])
        return (*(x if want else None for x, want in zip(grads, need[:6])),
                None, None, None, None)


def det_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    toep: Optional[torch.Tensor],
    rel_h: Optional[torch.Tensor],
    rel_w: Optional[torch.Tensor],
    hw: Tuple[int, int],
    scaling: float,
) -> torch.Tensor:
    """Public entry (the JAX signature): q/k/v (B, L, heads, dh) with
    L = hw[0] * hw[1]; toep from ``toeplitz_tables`` sliced to the grid, or
    None; rel_h / rel_w the layer's decomposed tables resized to the grid,
    or None.  Returns (B, L, heads, dh) through ``DetAttentionFunction``: the
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"det attention runs on cuda or cpu tensors, not {q.device}")
    b, l, heads, dh = q.shape
    bh = bw = None
    if rel_h is not None:
        bh, bw = compute_decomp(q, rel_h, rel_w, hw)
    q3, k3, v3 = (x.reshape(b, l, heads * dh) for x in (q, k, v))
    out = DetAttentionFunction.apply(q3, k3, v3, toep, bh, bw, tuple(hw), scaling, heads,
                                     torch.is_grad_enabled())
    return out.reshape(b, l, heads, dh)
