"""Int8 serving path (counterpart of ``one_peace_tpu/ops/quant.py``).

Weights are quantized offline, symmetric absmax per output channel; the
activations dynamically, per row.  ``y = (x_q @ w_q^T) * sx * sw + b``, the
sum in int32 and the rest in fp32, then one cast to x's dtype.  Opt-in at
load time (``hub.from_pretrained(..., quantize="ffn" | "ffn_attn")``), which
calls ``quantize_ffn_`` on the model.

The int8 weight is kept as (out, in), K contiguous, the layout the GEMM
reads (the transpose of the JAX package's (in, out) ``w_q``).  On a CUDA
tensor the row quantize and the GEMM are the hand-written kernels of
``ops/int8_matmul.py``, always; on a CPU tensor their plain versions.
Serving only: the int8 path takes no gradient, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from . import int8_matmul as im


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> int8 weight (out, in) and the per-output-channel
    fp32 scale (out,): ``scale = max(absmax / 127, 1e-8)``, round half to
    even, clip to +-127.  The same arithmetic as the row quantize, with the
    output channels as rows."""
    return im.int8_quantize_rows_plain(w)


def _gemm(rows: Tuple[torch.Tensor, torch.Tensor], like: torch.Tensor, w_q: torch.Tensor,
          w_scale: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The GEMM on quantized rows of ``like`` (..., in) -> (..., out) in
    ``like``'s dtype, the bias added in fp32 before the one cast."""
    x_q, sx = rows
    y = im.int8_matmul(x_q, w_q, sx, w_scale, None if bias is None else bias.float(),
                       out_dtype=like.dtype)
    return y.reshape(*like.shape[:-1], w_q.shape[0])


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return im.int8_quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dynamic-activation int8 linear: x (..., in) -> (..., out)."""
    return _gemm(_quantize_rows(x), x, w_q, w_scale, bias)


class QuantizedLinear(nn.Module):
    """A ``Linear`` served in int8: buffers ``w_q`` (out, in) int8 and
    ``w_scale`` (out,) fp32, and the original bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.register_buffer("w_q", torch.empty(out_features, in_features, dtype=torch.int8,
                                                device=device))
        self.register_buffer("w_scale", torch.empty(out_features, dtype=torch.float32,
                                                    device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device, dtype=dtype),
                                  requires_grad=False) if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Module) -> "QuantizedLinear":
        out_f, in_f = linear.weight.shape
        q = cls(in_f, out_f, bias=False, device=linear.weight.device)
        q.w_q, q.w_scale = quantize_weight(linear.weight)
        q.bias = linear.bias
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quantized_linear(x, self.w_q, self.w_scale, self.bias)

    def on_rows(self, rows: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """The layer on ``x`` whose rows are already quantized (``rows``)."""
        return _gemm(rows, x, self.w_q, self.w_scale, self.bias)


def is_quantized(module: nn.Module) -> bool:
    return isinstance(module, QuantizedLinear)


def shared_input_linears(x: torch.Tensor, *linears: nn.Module) -> List[torch.Tensor]:
    """Each of ``linears`` applied to the same x.  The quantized ones share
    one row quantize of x: the int8 rows and scales are those each would
    compute, so the result is the JAX package's (which quantizes x once per
    projection)."""
    rows = _quantize_rows(x) if any(map(is_quantized, linears)) else None
    return [lin.on_rows(rows, x) if is_quantized(lin) else lin(x) for lin in linears]


def quantize_ffn_(model: nn.Module, include_attn: bool = False) -> nn.Module:
    """Swap the ``wi_0``/``wi_1``/``wo`` linears of every modality FFN
    (``*_ffn``) for ``QuantizedLinear``s, in place (``quantize_ffn_params``).
    ``include_attn`` also swaps the self-attention ``q_proj``/``k_proj``/
    ``v_proj``/``out_proj``; per-head gains and the Magneto LN stay as they
    are.  Quantizes the weights in their current dtype, so cast the model to
    its serving dtype first (as ``hub.from_pretrained`` does); serving only,
    the int8 path takes no gradient.  Returns ``model``.

    ``vision.zoo.quantize_serving_params`` is this function (the JAX
    package's ``vision/zoo.quantize_serving_params``): on a zoo model it
    swaps the det and video trunks' ``image_ffn`` and the seg stack's
    ``backbone.encoder`` FFNs, and the heads and adapters stay as they are.
    On the card each such layer then runs the int8 GEMM (#3) three times
    behind two row quantizes (3b)."""
    for name, module in list(model.named_modules()):
        leaf = name.rsplit(".", 1)[-1]
        names = ()
        if leaf.endswith("_ffn") and hasattr(module, "wi_0"):
            names = ("wi_0", "wi_1", "wo")
        elif include_attn and leaf == "self_attn" and hasattr(module, "q_proj"):
            names = ("q_proj", "k_proj", "v_proj", "out_proj")
        for attr in names:
            lin = getattr(module, attr)
            if not is_quantized(lin):
                setattr(module, attr, QuantizedLinear.from_linear(lin))
    return model
