"""Weights carried across from the JAX package.

``params_from_jax`` turns the JAX package's parameter tree (nested dicts and
lists of numpy arrays, as ``utils/checkpoint_convert.convert_retrieval_model``
or ``model.init`` give it) into this package's ``state_dict``;
``params_to_jax`` is its inverse, so that a ``.npz`` the port exports reads in
either package; ``model_to_jax`` applies it with the layout a model declares
(the detector's ``jax_layout``).  ``load_npz`` reads the flat
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


def params_to_jax(state: Dict[str, torch.Tensor], periods: Optional[Dict[str, int]] = None,
                  names: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """A ``state_dict`` -> the JAX package's parameter tree, the inverse of
    ``params_from_jax``: ``weight`` of two or more dimensions becomes ``w``
    in the JAX layout (conv and transposed-conv kernels HWIO), a
    one-dimensional ``weight`` (a LayerNorm's or GroupNorm's) becomes
    ``scale`` and its ``bias`` stays ``bias``, any other ``bias`` becomes
    ``b``, ``w_q`` goes back to (in, out); the fusion layers are stacked on a
    leading layer axis, and modules numbered 0..n-1 become lists.

    ``periods`` maps a module list of the detection trunk (``"backbone.layers"``)
    to its global period p: its layers ``g * p + s`` are stacked back into
    ``win_layers`` (groups, p - 1, ...) and ``glob_layers`` (groups, ...)
    beside it.  ``names`` maps a module's path to its key in the JAX tree
    (``"fpn.scale_4_0"`` -> ``"scale_4.0"``).  Leaves are numpy arrays,
    except bf16 ones, which stay bf16 tensors (numpy has no bf16 of its own;
    ``native_checkpoint.save_params`` takes both)."""
    periods, names = periods or {}, names or {}
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
        for i, part in enumerate(parents):
            node = node.setdefault(names.get(".".join(parents[:i + 1]), part), {})
        node[name] = leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()

    def stack(items: list) -> Any:
        first = items[0]
        if isinstance(first, dict):
            return {k: stack([item[k] for item in items]) for k in first}
        return torch.stack(items) if isinstance(first, torch.Tensor) else np.stack(items)

    def numbered(node: Dict[str, Any]) -> list:
        return [node[str(i)] for i in range(len(node))]

    def regroup(layers: list, period: int) -> Dict[str, Any]:
        if period < 2:
            # the JAX tree keeps (groups, 0, ...) windowed leaves, whose
            # shapes the state_dict does not hold
            raise NotImplementedError("a trunk without windowed layers (global period 1)")
        groups = [layers[g:g + period] for g in range(0, len(layers), period)]
        return {"win_layers": stack([stack(group[:-1]) for group in groups]),
                "glob_layers": stack([group[-1] for group in groups])}

    def listify(node: Any, path: tuple) -> Any:
        if not isinstance(node, dict):
            return node
        if path[-2:] == ("fusion", "layers"):
            return stack(numbered(node))
        keys = list(node)
        if keys and all(k.isdigit() for k in keys) and \
                sorted(int(k) for k in keys) == list(range(len(keys))):
            return [listify(node[str(i)], path + (str(i),)) for i in range(len(keys))]
        out: Dict[str, Any] = {}
        for k, v in node.items():
            period = periods.get(".".join(path + (k,)))
            if period:
                out.update(regroup(numbered(v), period))
            else:
                out[k] = listify(v, path + (k,))
        return out

    return listify(root, ())


def model_to_jax(model: torch.nn.Module) -> Dict[str, Any]:
    """``params_to_jax`` of ``model.state_dict()`` with the layout the model
    declares through a ``jax_layout()`` method (the detector's trunk period
    and pyramid names), if it has one."""
    layout = model.jax_layout() if hasattr(model, "jax_layout") else {}
    return params_to_jax(model.state_dict(), **layout)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read the JAX package's flat ``.npz`` export (keys joined with "/",
    bf16 leaves stored as uint16 views listed in ``__bf16_keys__``) and
    return the port's ``state_dict``."""
    from .native_checkpoint import load_params

    return params_from_jax(load_params(path))
