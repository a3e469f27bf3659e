"""Weights carried across from the JAX package.

``params_from_jax`` turns the JAX package's parameter tree (nested dicts and
lists of numpy arrays, as ``utils/checkpoint_convert.convert_retrieval_model``
or ``model.init`` give it) into this package's ``state_dict``.
``load_npz`` reads the JAX package's flat ``.npz`` export
(``utils/native_checkpoint.save_params``) with numpy alone and converts it.

Layout rules:

- a dense ``w`` (in, out) becomes ``weight`` (out, in), a conv2d ``w``
  (kh, kw, in, out) becomes (out, in, kh, kw), a conv1d ``w``
  (k, in / groups, out) becomes (out, in / groups, k); ``b`` becomes ``bias``;
- a LayerNorm's ``scale`` becomes ``weight``;
- an int8 ``w_q`` (in, out) of ``quantize_ffn_params`` becomes ``w_q``
  (out, in), the layout of ``ops.quant.QuantizedLinear``; ``w_scale`` keeps
  its name;
- the stacked ``fusion/layers`` tree (leading ``layers`` axis) becomes one
  module per layer, and lists become numbered modules.

The same walk carries any tree of the parameters' structure, such as a
gradient tree, or the optimizer's ``decay_mask`` and ``layer_decay_scales``
trees: with ``num_layers`` given, a stacked leaf without a leading layer
axis (a bool, a 0-d scale) goes to every layer, and a leaf of fewer than two
dimensions keeps its layout.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

_CONV_PERMUTE = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _to_torch(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as the JAX side stores it
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _index(node: Any, i: int) -> Any:
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return node if np.ndim(node) == 0 else node[i]


def params_from_jax(tree: Dict[str, Any],
                    num_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> ``state_dict`` of ``OnePeaceRetrievalModel``
    (or the same names for a tree of that structure)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        elif isinstance(node, dict) and path[-2:] == ("fusion", "layers"):
            first = node
            while isinstance(first, dict):
                first = next(iter(first.values()))
            for i in range(num_layers if np.ndim(first) == 0 else len(first)):
                walk(_index(node, i), path + (str(i),))
        elif isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (key,))
        else:
            leaf = _to_torch(node)
            name = path[-1]
            if name == "w":
                if leaf.ndim >= 2:
                    leaf = leaf.permute(*_CONV_PERMUTE[leaf.ndim]).contiguous()
                name = "weight"
            elif name == "w_q" and leaf.ndim == 2:
                leaf = leaf.T.contiguous()
            elif name == "b":
                name = "bias"
            elif name == "scale":
                name = "weight"
            out[".".join(path[:-1] + (name,))] = leaf

    walk(tree, ())
    return out


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read the JAX package's flat ``.npz`` export (keys joined with "/",
    bf16 leaves stored as uint16 views listed in ``__bf16_keys__``) and
    return the port's ``state_dict``."""
    with np.load(path) as data:
        bf16_keys = (set(json.loads(data["__bf16_keys__"].tobytes()))
                     if "__bf16_keys__" in data.files else set())
        flat = {}
        for key in data.files:
            if key in ("__metadata__", "__bf16_keys__"):
                continue
            arr = data[key]
            flat[key] = (torch.from_numpy(arr).view(torch.bfloat16)
                         if key in bf16_keys else torch.from_numpy(arr))
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return params_from_jax(root)
