"""Weights carried across from the JAX package.

``params_from_jax`` turns the JAX package's parameter tree (nested dicts and
lists of numpy arrays, as ``utils/checkpoint_convert.convert_retrieval_model``
or ``model.init`` give it) into this package's ``state_dict``;
``params_to_jax`` is its inverse for the retrieval model, so that a ``.npz``
the port exports reads in either package.  ``load_npz`` reads the flat
``.npz`` layout (``utils/native_checkpoint.load_params``) and converts it.

Layout rules:

- a dense ``w`` (in, out) becomes ``weight`` (out, in), a conv2d ``w``
  (kh, kw, in, out) becomes (out, in, kh, kw), a conv1d ``w``
  (k, in / groups, out) becomes (out, in / groups, k); ``b`` becomes ``bias``;
- a LayerNorm's ``scale`` becomes ``weight``;
- an int8 ``w_q`` (in, out) of ``quantize_ffn_params`` becomes ``w_q``
  (out, in), the layout of ``ops.quant.QuantizedLinear``; ``w_scale`` keeps
  its name;
- the stacked ``fusion/layers`` tree (leading ``layers`` axis) becomes one
  module per layer, and lists become numbered modules;
- the detection trunk's ``win_layers`` (groups, period-1, ...) and
  ``glob_layers`` (groups, ...) become ``layers.{g * period + s}``, the global
  layer last in each period; a transposed conv's HWIO ``w`` becomes
  (out, in, kh, kw) like any conv (``models.components.conv_transpose2d``
  takes that layout); a "." in a key becomes "_" (``scale_4.0`` ->
  ``scale_4_0``).

The same walk carries any tree of the parameters' structure, such as a
gradient tree, or the optimizer's ``decay_mask`` and ``layer_decay_scales``
trees: with ``num_layers`` given, a stacked leaf without a leading layer
axis (a bool, a 0-d scale) goes to every layer, and a leaf of fewer than two
dimensions keeps its layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_CONV_PERMUTE = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_CONV_UNPERMUTE = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


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


def _leading(node: Any, n: int) -> tuple:
    """The first n dims of the first leaf of a stacked tree."""
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.shape(node)[:n]


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
        elif isinstance(node, dict) and "win_layers" in node and "glob_layers" in node:
            win, glob = node["win_layers"], node["glob_layers"]
            nwin = _leading(win, 2)[1]
            for g in range(_leading(glob, 1)[0]):
                for s in range(nwin):
                    walk(_index(_index(win, g), s), path + ("layers", str(g * (nwin + 1) + s)))
                walk(_index(glob, g), path + ("layers", str(g * (nwin + 1) + nwin)))
            for key, child in node.items():
                if key not in ("win_layers", "glob_layers"):
                    walk(child, path + (key,))
        elif isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (key.replace(".", "_"),))
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


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The retrieval model's ``state_dict`` -> the JAX package's parameter
    tree, the inverse of ``params_from_jax``: ``weight`` of two or more
    dimensions becomes ``w`` in the JAX layout, a one-dimensional
    ``weight`` (a LayerNorm's) becomes ``scale`` and its ``bias`` stays
    ``bias``, any other ``bias`` becomes ``b``, ``w_q`` goes back to
    (in, out); the fusion layers are stacked on a leading layer axis, and
    modules numbered 0..n-1 become lists.  Leaves are numpy arrays, except
    bf16 ones, which stay bf16 tensors (numpy has no bf16 of its own;
    ``native_checkpoint.save_params`` takes both)."""
    root: Dict[str, Any] = {}
    for key, value in state.items():
        *parents, name = key.split(".")
        leaf = value.detach().cpu()
        siblings = ".".join(parents + ["weight"])
        if name == "weight":
            if leaf.ndim >= 2:
                leaf = leaf.permute(*_CONV_UNPERMUTE[leaf.ndim]).contiguous()
                name = "w"
            else:
                name = "scale"
        elif name == "bias" and not (siblings in state and state[siblings].ndim == 1):
            name = "b"
        elif name == "w_q" and leaf.ndim == 2:
            leaf = leaf.T.contiguous()
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()

    def stack(layers: Dict[str, Any]) -> Any:
        first = layers["0"]
        if isinstance(first, dict):
            return {k: stack({i: v[k] for i, v in layers.items()}) for k in first}
        items = [layers[str(i)] for i in range(len(layers))]
        if isinstance(first, torch.Tensor):
            return torch.stack(items)
        return np.stack(items)

    def listify(node: Any, path: tuple) -> Any:
        if not isinstance(node, dict):
            return node
        if path[-2:] == ("fusion", "layers"):
            return stack(node)
        keys = list(node)
        if keys and all(k.isdigit() for k in keys) and \
                sorted(int(k) for k in keys) == list(range(len(keys))):
            return [listify(node[str(i)], path + (str(i),)) for i in range(len(keys))]
        return {k: listify(v, path + (k,)) for k, v in node.items()}

    return listify(root, ())


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read the JAX package's flat ``.npz`` export (keys joined with "/",
    bf16 leaves stored as uint16 views listed in ``__bf16_keys__``) and
    return the port's ``state_dict``."""
    from .native_checkpoint import load_params

    return params_from_jax(load_params(path))
