"""Fused bias-aware attention, forward and backward: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``one_peace_tpu/ops/flash_attention.py`` (the Pallas TPU
kernels ``_flash_fwd`` and ``_flash_bwd`` under one ``custom_vjp``).  The
kernel sources are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``; their headers say what bounds them on an
H100 and how the design answers that.

``flash_attention`` runs ``FlashAttentionFunction``, a
``torch.autograd.Function`` that sends CUDA tensors to the kernels and CPU
tensors to the plain versions, in both directions.  On the card there is no
fallback: an input the kernels do not take (head dim other than 64, a dtype
other than bf16 or fp32) raises.  Each kernel is compiled with ``nvcc`` at
its first launch by ``ops/build.py`` and loaded through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .build import build_library

NEG_INF = -1e30  # additive key bias at padded keys, as the TPU kernel's
HEAD_DIM = 64  # the only head dim the kernel takes (every shipped config)
_DKV_BLOCKS = 4 * 132  # dk/dv blocks to aim for: about four per SM of an H100

_SOURCES = {"fwd": "flash_attention_fwd", "bwd": "flash_attention_bwd"}

# Kernel launches since the caller last set them to 0.  Only the CUDA
# wrappers add to them, once per launch that the runtime accepted:
# ``launches`` for the forward kernel, ``bwd_launches`` for the backward.
launches = 0
bwd_launches = 0


def flash_attention_plain(q, k, v, rel_bias, key_bias, scaling: float, heads: int):
    """Plain version on the (B, L, H*Dh) layout (``_xla_reference``): fp32
    logits, ``* scaling``, + rel_bias (H, L, L) or (B, H, L, L), + key_bias
    (B, L), fp32 softmax, probabilities cast to q's dtype before p.v."""
    b, l, hdim = q.shape
    dh = hdim // heads
    qh = q.reshape(b, l, heads, dh).float()
    kh = k.reshape(b, l, heads, dh).float()
    vh = v.reshape(b, l, heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scaling
    if rel_bias is not None:
        logits = logits + (rel_bias if rel_bias.ndim == 4 else rel_bias[None])
    if key_bias is not None:
        logits = logits + key_bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, l, hdim)


def flash_attention_bwd_plain(q, k, v, g, rel_bias, key_bias, scaling: float, heads: int):
    """Plain version of the backward (``_make_bwd_kernel``'s formula) on the
    (B, L, H*Dh) layout.  g is the cotangent of the output.  Returns dq, dk,
    dv in q's dtype and d(rel_bias) in fp32 with rel_bias's shape (summed
    over B for a shared (H, L, L) bias), or None without a bias.

    p32 = softmax(s) in fp32 and p = p32 in q's dtype; dv = p^T g and
    dp = g v^T with fp32 sums; ds = p32 (dp - sum(dp p32)); dsc =
    ds * scaling in q's dtype; dq = dsc k, dk = dsc^T q; d(bias) = ds."""
    b, l, hdim = q.shape
    dh = hdim // heads
    qh, kh, vh, gh = (x.reshape(b, l, heads, dh).float() for x in (q, k, v, g))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scaling
    if rel_bias is not None:
        logits = logits + (rel_bias if rel_bias.ndim == 4 else rel_bias[None])
    if key_bias is not None:
        logits = logits + key_bias[:, None, None, :]
    p32 = torch.softmax(logits, dim=-1)
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
        lib.one_peace_flash_attention_fwd.argtypes = [p, p, p, p, i, p, p, i, i, i, f, i, i, p]
        lib.one_peace_flash_attention_fwd.restype = i
        lib.one_peace_cuda_error_string.argtypes = [i]
        lib.one_peace_cuda_error_string.restype = ctypes.c_char_p
    else:
        lib.one_peace_flash_attention_bwd.argtypes = [
            p, p, p, p, p, i, p, p, p, p, p, p, p, i, i, i, f, i, i, i, p]
        lib.one_peace_flash_attention_bwd.restype = i
        lib.one_peace_bwd_error_string.argtypes = [i]
        lib.one_peace_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads: int) -> None:
    """Raise on anything the kernel does not take (it has no fallback)."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bf16 or fp32, not {q.dtype}")
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


def flash_attention_cuda(q, k, v, rel_bias, key_bias, scaling: float, heads: int):
    """Launch the kernel on the (B, L, H*64) layout; arguments as
    ``flash_attention_plain``.  Returns a new (B, L, H*64) tensor."""
    global launches
    _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads)
    lib = _library()
    b, l, _ = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.one_peace_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if rel_bias is None else rel_bias.data_ptr(),
        int(rel_bias is not None and rel_bias.ndim == 4),
        None if key_bias is None else key_bias.data_ptr(),
        out.data_ptr(), b, l, heads, float(scaling),
        int(q.dtype == torch.bfloat16), q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.one_peace_cuda_error_string(err).decode()} ({err})")
    launches += 1
    return out


def flash_attention_bwd_cuda(q, k, v, g, rel_bias, key_bias, scaling: float, heads: int):
    """Launch the backward kernels; arguments and results as
    ``flash_attention_bwd_plain``."""
    global bwd_launches
    _check_kernel_inputs(q, k, v, rel_bias, key_bias, heads)
    if g.dtype != q.dtype or g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g must match q: {g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("attention kernel needs a contiguous, 16-byte aligned g")
    lib = _library("bwd")
    b, l, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dbias = None if rel_bias is None else torch.empty_like(rel_bias)
    # per query row: softmax max, 1 / softmax sum, sum(dp * p32)
    stats = torch.empty(3, b, heads, l, dtype=torch.float32, device=q.device)
    # a shared bias's d(bias) is summed over chunks of the batch, one chunk
    # per dk/dv block, sized for about _DKV_BLOCKS blocks; the chunks'
    # partial sums are added by a second kernel
    b_chunk, partial = b, None
    if rel_bias is not None and rel_bias.ndim == 3:
        blocks = -(-l // 64) * heads
        b_chunk = -(-b // min(b, max(1, -(-_DKV_BLOCKS // blocks))))
        chunks = -(-b // b_chunk)
        if chunks > 1:
            partial = torch.empty(chunks, *rel_bias.shape, dtype=torch.float32,
                                  device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.one_peace_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        None if rel_bias is None else rel_bias.data_ptr(),
        int(rel_bias is not None and rel_bias.ndim == 4),
        None if key_bias is None else key_bias.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if dbias is None else dbias.data_ptr(),
        None if partial is None else partial.data_ptr(), stats.data_ptr(),
        b, l, heads, float(scaling), int(q.dtype == torch.bfloat16), b_chunk,
        q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: "
                           f"{lib.one_peace_bwd_error_string(err).decode()} ({err})")
    bwd_launches += 1
    return dq, dk, dv, dbias


class FlashAttentionFunction(torch.autograd.Function):
    """Fused attention on the (B, L, H*Dh) layout with its gradient
    (``_flash_attention_core``'s ``custom_vjp``): the forward and backward
    kernels for CUDA tensors, their plain versions for CPU tensors.  The
    backward recomputes the softmax from q, k and the biases; only the
    inputs are saved.  The key bias takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, rel_bias, key_bias, scaling: float, heads: int):
        ctx.save_for_backward(q, k, v, rel_bias, key_bias)
        ctx.scaling, ctx.heads = scaling, heads
        fwd = flash_attention_plain if q.device.type == "cpu" else flash_attention_cuda
        return fwd(q, k, v, rel_bias, key_bias, scaling, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_bias, key_bias = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd_cuda
        dq, dk, dv, dbias = bwd(q, k, v, g.contiguous(), rel_bias, key_bias,
                                ctx.scaling, ctx.heads)
        return dq, dk, dv, dbias, None, None, None


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
        rel_bias = rel_bias.float().contiguous()
    out = FlashAttentionFunction.apply(q3, k3, v3, rel_bias, key_bias, scaling, h)
    return out.reshape(b, l, h, d)
