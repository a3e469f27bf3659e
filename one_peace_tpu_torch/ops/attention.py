"""Bias-aware multi-head attention (counterpart of
``one_peace_tpu/ops/attention.py``).

The relative-position bias stays (H, L, L) or (B, H, L, L) and the key
padding mask (B, L); they are combined inside the op:

- ``xla``: the plain version (the oracle) — fp32 logits, the bias and a
  ``finfo(fp32).min`` key mask, fp32 softmax, probabilities cast to q's
  dtype before p.v;
- ``pallas``: the fused kernel of ``ops/flash_attention.py`` for a CUDA
  tensor, the plain version for a CPU tensor;
- ``ring``: ring attention over the current layout's ``sp`` ranks
  (``ops/ring_attention.py``) under exactly the JAX package's conditions:
  ``sp`` > 1, L divisible by ``sp``, as many queries as keys, no bias or a
  3-D one, no pipeline (``pp`` = 1), and the global batch divisible by the
  data ranks (the heads divide by ``tp``: ``parallel.mesh.check_split``).
  The layer's activations stay whole on every ``sp`` rank: q/k/v enter the
  ring through ``tensor_parallel.slice_from`` (the gradient all-gathered)
  and the output leaves it through ``gather_to`` (the gradient's own chunk
  kept), so that every ``sp`` rank holds the same tensors and gradients
  outside it.  Where the ring does not engage, JAX takes its XLA path and
  the port ``flash_attention`` (the kernel on a CUDA tensor).

Shapes: q, k, v are ``(B, L, H, Dh)``; output ``(B, L, H, Dh)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention
from ..parallel.data import current_rows
from ..parallel.mesh import current_layout

NEG_INF = float(torch.finfo(torch.float32).min)


def _combine_bias(rel_bias: Optional[torch.Tensor],
                  key_padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The full additive fp32 bias (B, H, Lq, Lk); padded keys get
    ``finfo(fp32).min``."""
    bias = None
    if rel_bias is not None:
        bias = rel_bias.float()
        if bias.ndim == 3:
            bias = bias[None]
    if key_padding_mask is not None:
        pad = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                          device=key_padding_mask.device)
        pad = pad.masked_fill(key_padding_mask, NEG_INF)[:, None, None, :]
        bias = pad if bias is None else bias + pad
    return bias


def attention_plain(q, k, v, rel_bias, key_padding_mask, scaling: float) -> torch.Tensor:
    """The oracle (``multihead_attention``'s XLA branch).  q and k are upcast
    before the product: a bf16 product would round logits of +-10 to steps
    of 0.06."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scaling
    bias = _combine_bias(rel_bias, key_padding_mask)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _ring(q, k, v, rel_bias, key_padding_mask, scaling: float) -> Optional[torch.Tensor]:
    """Ring attention over the layout's ``sp`` ranks, or None where it does
    not engage."""
    from ..parallel.tensor_parallel import Shard, gather_to, slice_from
    from .ring_attention import ring_attention

    layout = current_layout()
    if layout is None or layout.size("sp") == 1:
        return None
    n = layout.size("sp")
    if q.shape[1] % n or q.shape[1] != k.shape[1]:
        return None
    if rel_bias is not None and rel_bias.ndim != 3:
        return None  # batch-dependent bias tiles are not ring-sliced
    if layout.size("pp") > 1:
        return None  # the pipeline's stages run whole sequences
    rows = current_rows()
    if (q.shape[0] if rows is None else rows.total) % layout.size("data"):
        return None
    sp = Shard(layout.group("sp"), layout.rank("sp"), n)
    chunks = [slice_from(t, 1, sp) for t in (q, k, v)]
    out = ring_attention(*chunks, rel_bias, key_padding_mask, scaling, sp, layout.ranks["sp"])
    return gather_to(out, 1, sp)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    key_padding_mask: Optional[torch.Tensor],
    scaling: float,
    impl: str = "pallas",
) -> torch.Tensor:
    """Softmax attention with additive relative-position bias.

    Args:
      q/k/v: (B, L, H, Dh)
      rel_bias: (H, L, L) or (B, H, L, L) additive bias, or None
      key_padding_mask: (B, L) bool, True at padding positions, or None
      scaling: query scale (head_dim ** -0.5)
      impl: 'pallas' (the fused kernel on a CUDA tensor, the plain version
        on a CPU tensor) | 'xla' (always the plain version) | 'ring' (ring
        attention over the ``sp`` ranks where it engages, else 'pallas')
    """
    if impl == "ring":
        out = _ring(q, k, v, rel_bias, key_padding_mask, scaling)
        if out is not None:
            return out
        impl = "pallas"
    if impl == "pallas":
        return flash_attention(q, k, v, rel_bias, key_padding_mask, scaling)
    if impl == "xla":
        return attention_plain(q, k, v, rel_bias, key_padding_mask, scaling)
    raise ValueError(f"unknown attn_impl {impl!r}")
