"""Bias-aware multi-head attention (counterpart of
``one_peace_tpu/ops/attention.py``).

The relative-position bias stays (H, L, L) or (B, H, L, L) and the key
padding mask (B, L); they are combined inside the op:

- ``xla``: the plain version (the oracle) — fp32 logits, the bias and a
  ``finfo(fp32).min`` key mask, fp32 softmax, probabilities cast to q's
  dtype before p.v;
- ``pallas``: the fused kernel of ``ops/flash_attention.py`` for a CUDA
  tensor, the plain version for a CPU tensor;
- ``ring``: sequence-parallel attention, not ported yet.

Shapes: q, k, v are ``(B, L, H, Dh)``; output ``(B, L, H, Dh)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention

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
        on a CPU tensor) | 'xla' (always the plain version) | 'ring'
    """
    if impl == "pallas":
        return flash_attention(q, k, v, rel_bias, key_padding_mask, scaling)
    if impl == "xla":
        return attention_plain(q, k, v, rel_bias, key_padding_mask, scaling)
    if impl == "ring":
        raise NotImplementedError("attn_impl='ring' (sequence-parallel attention) "
                                  "is not ported to PyTorch yet")
    raise ValueError(f"unknown attn_impl {impl!r}")
