"""Fused bias-aware attention, forward and backward: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``one_peace_tpu/ops/flash_attention.py`` (the Pallas TPU
kernels ``_flash_fwd`` and ``_flash_bwd`` under one ``custom_vjp``).  The
kernel sources are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``; their headers say what bounds them on an
H100 and how the design answers that.  ``tile_plan`` and ``bwd_plan`` give
the bf16 kernels' tiles, walks and shared memory for a sequence length; the
C side checks each launch against them.

``flash_attention`` runs ``FlashAttentionFunction``, a
``torch.autograd.Function`` that sends CUDA tensors to the kernels and CPU
tensors to the plain versions, in both directions.  When a gradient will be
taken, the forward also returns each query row's softmax statistics (its
max m and 1 / sum) and the backward starts from them.  On the card there is
no fallback: an input the kernels do not take (head dim other than 64, a
dtype other than bf16, fp16 or fp32) raises.  bf16 and fp16 run the same
wgmma kernels (templated on the element type, on the same plans); fp32 runs
the CUDA-core kernels of the test path.  Each kernel is compiled with
``nvcc`` at its first launch by ``ops/build.py`` and loaded through
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .build import DTYPE_CODES, build_library

NEG_INF = -1e30  # additive key bias at padded keys, as the TPU kernel's
HEAD_DIM = 64  # the only head dim the kernel takes (every shipped config)
TILE = 64  # query rows of a q tile, keys of a key tile
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448  # the most shared memory a block may use on an H100 (227 KB)
SMEM_PER_SM = 233472  # an SM's shared memory for blocks, 1 KB of it reserved per block
GRID_Z_MAX = 65535  # CUDA's limit on a grid's z extent: the dk/dv kernel's batch chunks
SWIZZLE_ALIGN = 1024  # the bf16 kernels align their tiles to the swizzle's atom
TILES_BYTES = 4 * TILE * HEAD_DIM * 2  # four 128-byte-swizzled bf16 tiles (K, V or Q, G; x2)
STAGE_STRIDE = TILE + 8  # floats per row of a two-walk kernel's staged bias tile
DKV_STATIC_SMEM = 2 * 3 * TILE * 4  # the dk/dv kernel's static shared rows' statistics (st)

_SOURCES = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd"}

# Kernel launches since the caller last set them to 0.  Only the CUDA
# wrappers add to them, once per launch that the runtime accepted:
# ``launches`` for the forward kernel, ``bwd_launches`` for the backward.
launches = 0
bwd_launches = 0


class TilePlan(NamedTuple):
    """How the bf16 kernels tile a sequence of L tokens."""
    n_tiles: int    # 64-row q tiles and 64-key tiles: ceil(L / 64)
    tail: int       # the last tile's width: its L - 64 (n_tiles - 1) keys rounded up to 16
    resident: bool  # one walk: the row block's scores (forward) or p32 (backward's dq
    #                 kernel) stay in shared memory; else two walks over the key tiles
    stride: int     # floats per row of that region: the padded width + 8 (0: two walks,
    #                 whose staged bias tiles have STAGE_STRIDE)
    smem: int       # dynamic shared memory of the forward and of the dq kernel


@functools.lru_cache(maxsize=None)
def tile_plan(l: int, resident: Optional[bool] = None) -> TilePlan:
    """Plan the bf16 forward and the backward's dq kernel for L tokens.  Key
    tiles are 64 wide but the last, which is only as wide as its keys
    (a multiple of 16, the depth of a wgmma step).  A block (64 query rows)
    keeps its scores for all keys, bias and key bias added, in a shared
    region of 64 rows of the padded width + 8 floats (= 8 mod 16: the float2
    accesses of an mma fragment hit 32 banks) beside double-buffered K and V
    tiles, where two such blocks fit on an SM (L <= 304): one q.k^T and one
    bias read per score.  Longer sequences walk the key tiles twice, the bias
    staged a tile ahead in two buffers of 64 x STAGE_STRIDE floats: with the
    row block resident at L=500 the kernel ran one block per SM and lost to
    the first port (1.015 against 0.753 ms per layer on an H100 80GB HBM3 at
    700 W, PERF.md).  ``resident`` forces a branch
    (a measurement of the other one); the default picks as above."""
    if l < 1:
        raise ValueError(f"sequence length must be positive, got {l}")
    n = -(-l // TILE)
    tail = -(-(l - TILE * (n - 1)) // 16) * 16
    width = TILE * (n - 1) + tail
    one_walk = TILES_BYTES + TILE * (width + 8) * 4 + SWIZZLE_ALIGN
    if resident is None:
        resident = 2 * (one_walk + 1024) <= SMEM_PER_SM
    if resident:
        if one_walk > SMEM_PER_BLOCK:
            raise ValueError(f"the row block of L = {l} does not fit in shared memory")
        return TilePlan(n, tail, True, width + 8, one_walk)
    return TilePlan(n, tail, False, 0, TILES_BYTES + 2 * TILE * STAGE_STRIDE * 4 + SWIZZLE_ALIGN)


class BwdPlan(NamedTuple):
    """The bf16 backward's plan for one batch, length, head count and bias."""
    tiles: TilePlan  # the dq kernel's (and the dk/dv kernel's q tiles)
    dkv_slab: bool   # a shared bias's d(bias) is summed over the block's batch rows in a
    #                  shared slab of 64 keys x (padded width + 8) floats, written once per
    #                  chunk; else read, added and written in device memory per batch row
    dkv_smem: int    # dynamic shared memory of the dk/dv kernel
    b_chunk: int     # batch rows per dk/dv block (1 unless the bias is shared or B > 65535)
    chunks: int      # dk/dv blocks per (key tile, head): ceil(B / b_chunk), on grid z


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, l: int, heads: int, shared_bias: bool) -> BwdPlan:
    """Plan the bf16 backward.  With a shared (H, L, L) bias each dk/dv block
    walks a chunk of the batch and sums its keys' d(bias) columns in shared
    memory where the slab fits beside the kernel's static shared memory
    (L <= 752: from L = 753 to 768 the padded width of 768 leaves the block
    1,536 bytes over its 227 KB, and the launch is refused); the chunks are
    as many as fill
    the card once (blocks per SM from the shared memory, at most 2, times 132
    SMs, over n_tiles * heads blocks a chunk), and their partial sums are
    added by a third kernel in chunk order.  Without a shared bias each
    block takes one batch row, unless that puts more than ``GRID_Z_MAX``
    blocks on grid z (the temporal attention of a video trunk runs B = clips
    x tokens sequences): then each takes ceil(B / 65535) rows, one after the
    other, as a shared bias's chunk does."""
    tiles = tile_plan(l)
    width = TILE * (tiles.n_tiles - 1) + tiles.tail
    slab = TILES_BYTES + TILE * (width + 8) * 4 + SWIZZLE_ALIGN
    dkv_slab = shared_bias and slab + DKV_STATIC_SMEM <= SMEM_PER_BLOCK
    dkv_smem = slab if dkv_slab else TILES_BYTES + SWIZZLE_ALIGN
    if not shared_bias:
        b_chunk = -(-b // GRID_Z_MAX)
        return BwdPlan(tiles, False, dkv_smem, b_chunk, -(-b // b_chunk))
    per_sm = max(1, min(2, SMEM_PER_SM // (dkv_smem + DKV_STATIC_SMEM + 1024)))
    want = max(1, min(b, SM_COUNT * per_sm // (tiles.n_tiles * heads)))
    b_chunk = -(-b // want)
    return BwdPlan(tiles, dkv_slab, dkv_smem, b_chunk, -(-b // b_chunk))


def _logits(q, k, rel_bias, key_bias, scaling: float, heads: int) -> torch.Tensor:
    """(B, H, L, L) fp32 scores: q.k^T * scaling + rel_bias + key_bias."""
    b, l, hdim = q.shape
    dh = hdim // heads
    qh = q.reshape(b, l, heads, dh).float()
    kh = k.reshape(b, l, heads, dh).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scaling
    if rel_bias is not None:
        logits = logits + (rel_bias if rel_bias.ndim == 4 else rel_bias[None])
    if key_bias is not None:
        logits = logits + key_bias[:, None, None, :]
    return logits


def softmax_stats(logits: torch.Tensor) -> torch.Tensor:
    """(2, B, H, L) fp32: each row's max m and 1 / sum(exp(s - m))."""
    m = logits.amax(-1)
    return torch.stack([m, 1.0 / torch.exp(logits - m[..., None]).sum(-1)])


def flash_attention_plain(q, k, v, rel_bias, key_bias, scaling: float, heads: int,
                          with_stats: bool = False):
    """Plain version on the (B, L, H*Dh) layout (``_xla_reference``): fp32
    logits, ``* scaling``, + rel_bias (H, L, L) or (B, H, L, L), + key_bias
    (B, L), fp32 softmax, probabilities cast to q's dtype before p.v.  With
    ``with_stats`` also ``softmax_stats`` of the logits."""
    b, l, hdim = q.shape
    logits = _logits(q, k, rel_bias, key_bias, scaling, heads)
    vh = v.reshape(b, l, heads, hdim // heads)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, l, hdim)
    return (out, softmax_stats(logits)) if with_stats else out


def flash_attention_bwd_plain(q, k, v, g, rel_bias, key_bias, scaling: float, heads: int,
                              stats: Optional[torch.Tensor] = None):
    """Plain version of the backward (``_make_bwd_kernel``'s formula) on the
    (B, L, H*Dh) layout.  g is the cotangent of the output; ``stats``, if
    given, the forward's ``softmax_stats``.  Returns dq, dk, dv in q's dtype
    and d(rel_bias) in fp32 with rel_bias's shape (summed over B for a
    shared (H, L, L) bias), or None without a bias.

    p32 = softmax(s) in fp32 (exp(s - m) / l from the statistics) and p =
    p32 in q's dtype; dv = p^T g and dp = g v^T with fp32 sums; ds = p32
    (dp - sum(dp p32)); dsc = ds * scaling in q's dtype; dq = dsc k, dk =
    dsc^T q; d(bias) = ds."""
    b, l, hdim = q.shape
    dh = hdim // heads
    qh, kh, vh, gh = (x.reshape(b, l, heads, dh).float() for x in (q, k, v, g))
    logits = _logits(q, k, rel_bias, key_bias, scaling, heads)
    if stats is None:
        p32 = torch.softmax(logits, dim=-1)
    else:
        p32 = torch.exp(logits - stats[0][..., None]) * stats[1][..., None]
    p = p32.to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    dsc = (ds * scaling).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", dsc, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsc, qh)
    dbias = None
    if rel_bias is not None:
        dbias = ds if rel_bias.ndim == 4 else ds.sum(0)
    return (*(x.to(q.dtype).reshape(b, l, hdim) for x in (dq, dk, dv)), dbias)


@functools.lru_cache(maxsize=None)
def _library(which: str = "fwd") -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(_SOURCES[which])))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if which == "fwd":
        lib.one_peace_flash_attention_fwd.argtypes = [p] * 4 + [i] + [p] * 3 + [i] * 3 + [f] + [
            i] * 7 + [p]
        lib.one_peace_flash_attention_fwd.restype = i
        lib.one_peace_cuda_error_string.argtypes = [i]
        lib.one_peace_cuda_error_string.restype = ctypes.c_char_p
    else:
        lib.one_peace_flash_attention_bwd.argtypes = [p] * 5 + [i] + [p] * 8 + [i] * 3 + [f] + [
            i] * 11 + [p]
        lib.one_peace_flash_attention_bwd.restype = i
        lib.one_peace_bwd_error_string.argtypes = [i]
        lib.one_peace_bwd_error_string.restype = ctypes.c_char_p
        lib.one_peace_bwd_dkv_static_smem.restype = i
        static = lib.one_peace_bwd_dkv_static_smem()
        if static != DKV_STATIC_SMEM:  # bwd_plan would plan a slab that does not fit
            raise RuntimeError(f"the dk/dv kernel has {static} bytes of static shared memory; "
                               f"bwd_plan counts DKV_STATIC_SMEM = {DKV_STATIC_SMEM}")
    return lib


def _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads: int) -> None:
    """Raise on anything the kernel does not take (it has no fallback)."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"attention kernel takes bf16, fp16 or fp32, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, L, H*Dh) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, hdim = q.shape
    if hdim != heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIM} only; got "
                         f"{hdim} lanes over {heads} heads")
    if rel_bias is not None:
        if rel_bias.dtype != torch.float32 or rel_bias.shape not in (
                (heads, l, l), (b, heads, l, l)):
            raise ValueError(f"rel_bias must be fp32 (H, L, L) or (B, H, L, L), got "
                             f"{rel_bias.dtype} {tuple(rel_bias.shape)}")
    if key_bias is not None and (key_bias.dtype != torch.float32
                                 or key_bias.shape != (b, l)):
        raise ValueError(f"key_bias must be fp32 (B, L), got {key_bias.dtype} "
                         f"{tuple(key_bias.shape)}")
    tensors = [x for x in (q, k, v, rel_bias, key_bias) if x is not None]
    for x in tensors:
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"attention kernel needs every input on one CUDA device; "
                             f"got {[str(t.device) for t in tensors]}")
        if not x.is_contiguous():
            raise ValueError("attention kernel needs contiguous inputs")
        if x.data_ptr() % 16:
            raise ValueError("attention kernel needs 16-byte aligned inputs")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def flash_attention_cuda(q, k, v, rel_bias, key_bias, scaling: float, heads: int,
                         with_stats: bool = False):
    """Launch the kernel on the (B, L, H*64) layout; arguments as
    ``flash_attention_plain``.  Returns a new (B, L, H*64) tensor, and with
    ``with_stats`` the rows' (2, B, H, L) fp32 statistics (``softmax_stats``),
    written by the same launch."""
    global launches
    _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads)
    lib = _library()
    b, l, _ = q.shape
    plan = tile_plan(l)
    out = torch.empty_like(q)
    stats = (torch.empty(2, b, heads, l, dtype=torch.float32, device=q.device)
             if with_stats else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.one_peace_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(rel_bias),
        int(rel_bias is not None and rel_bias.ndim == 4), _ptr(key_bias), out.data_ptr(),
        _ptr(stats), b, l, heads, float(scaling), DTYPE_CODES[q.dtype],
        plan.n_tiles, plan.tail, int(plan.resident), plan.stride, plan.smem,
        q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.one_peace_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return (out, stats) if with_stats else out


def flash_attention_bwd_cuda(q, k, v, g, rel_bias, key_bias, scaling: float, heads: int,
                             stats: Optional[torch.Tensor] = None, passes: int = 3):
    """Launch the backward kernels; arguments and results as
    ``flash_attention_bwd_plain``.  The bf16 and fp16 kernels start from
    the forward's ``stats``; without them the forward kernel is launched to
    write them (and counted as a forward launch).  The fp32 kernels find
    the statistics themselves.  ``passes`` times one kernel alone (a bit
    mask: 1 the dq kernel, 2 the dk/dv kernel with its chunk sum); the
    outputs of the other are then left unwritten."""
    global bwd_launches
    _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads)
    if g.dtype != q.dtype or g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g must match q: {g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("attention kernel needs a contiguous, 16-byte aligned g")
    b, l, _ = q.shape
    if q.dtype == torch.float32:
        stats = torch.empty(2, b, heads, l, dtype=torch.float32, device=q.device)
    elif stats is None:
        _, stats = flash_attention_cuda(q, k, v, rel_bias, key_bias, scaling, heads,
                                        with_stats=True)
    elif (stats.dtype != torch.float32 or stats.shape != (2, b, heads, l)
          or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"stats must be contiguous fp32 (2, {b}, {heads}, {l}) on "
                         f"{q.device}, got {stats.dtype} {tuple(stats.shape)} on "
                         f"{stats.device}")
    lib = _library("bwd")
    plan = bwd_plan(b, l, heads, rel_bias is not None and rel_bias.ndim == 3)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dbias = None if rel_bias is None else torch.empty_like(rel_bias)
    dsum = torch.empty(b, heads, l, dtype=torch.float32, device=q.device)  # rowsum(dp * p32)
    partial = None
    if rel_bias is not None and rel_bias.ndim == 3 and plan.chunks > 1:
        partial = torch.empty(plan.chunks, *rel_bias.shape, dtype=torch.float32,
                              device=q.device)
    t = plan.tiles
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.one_peace_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _ptr(rel_bias),
        int(rel_bias is not None and rel_bias.ndim == 4), _ptr(key_bias),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias), _ptr(partial),
        stats.data_ptr(), dsum.data_ptr(), b, l, heads, float(scaling), DTYPE_CODES[q.dtype],
        passes,
        t.n_tiles, t.tail, int(t.resident), t.stride, t.smem, int(plan.dkv_slab),
        plan.dkv_smem, plan.b_chunk, q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: "
                           f"{lib.one_peace_bwd_error_string(err).decode()} ({err})")
    bwd_launches += 1
    return dq, dk, dv, dbias


class FlashAttentionFunction(torch.autograd.Function):
    """Fused attention on the (B, L, H*Dh) layout with its gradient
    (``_flash_attention_core``'s ``custom_vjp``): the forward and backward
    kernels for CUDA tensors, their plain versions for CPU tensors.  When a
    gradient will be taken (an input needs one) the forward also writes the
    rows' softmax statistics and saves them with the inputs; under
    ``no_grad`` or ``inference_mode`` nothing extra is written.  The
    backward recomputes the probabilities from q, k, the biases and the
    statistics.  The key bias takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, rel_bias, key_bias, scaling: float, heads: int,
                grad_wanted: bool):
        # grad_wanted: torch.is_grad_enabled() at the call (inside forward
        # grad mode is off, and needs_input_grad ignores no_grad and
        # inference_mode)
        fwd = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
        if not (grad_wanted and any(ctx.needs_input_grad[:4])):
            return fwd(q, k, v, rel_bias, key_bias, scaling, heads)
        out, stats = fwd(q, k, v, rel_bias, key_bias, scaling, heads, with_stats=True)
        ctx.save_for_backward(q, k, v, rel_bias, key_bias, stats)
        ctx.scaling, ctx.heads = scaling, heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_bias, key_bias, stats = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd_cuda
        dq, dk, dv, dbias = bwd(q, k, v, g.contiguous(), rel_bias, key_bias,
                                ctx.scaling, ctx.heads, stats=stats)
        return dq, dk, dv, dbias, None, None, None, None


def kernel_bias(rel_bias: torch.Tensor) -> torch.Tensor:
    """``rel_bias`` as the kernels take it: fp32, contiguous, 16-byte
    aligned (a layer's table of a per-layer stack, or a ``tp`` rank's heads
    of a shared bias, is a view that may start at an odd L off alignment:
    copied then)."""
    rel_bias = rel_bias.float().contiguous()
    return rel_bias.clone() if rel_bias.data_ptr() % 16 else rel_bias


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    key_padding_mask: Optional[torch.Tensor],
    scaling: float,
) -> torch.Tensor:
    """Public entry; layouts match ``ops.attention.multihead_attention``:
    q/k/v (B, L, H, D), rel_bias (H, L, L)/(B, H, L, L)/None, mask (B, L)
    True at padding.  The (B, L, H, D) <-> (B, L, H*D) reshapes are views."""
    b, l, h, d = q.shape
    q3, k3, v3 = (x.reshape(b, l, h * d) for x in (q, k, v))
    key_bias = None
    if key_padding_mask is not None:
        key_bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                               device=key_padding_mask.device)
        key_bias.masked_fill_(key_padding_mask, NEG_INF)
    if rel_bias is not None:
        rel_bias = kernel_bias(rel_bias)
    out = FlashAttentionFunction.apply(q3, k3, v3, rel_bias, key_bias, scaling, h,
                                       torch.is_grad_enabled())
    return out.reshape(b, l, h, d)
