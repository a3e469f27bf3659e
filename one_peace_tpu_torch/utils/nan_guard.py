"""Locate the first non-finite intermediate (counterpart of
``one_peace_tpu/utils/nan_guard.py``, fairseq's NanDetector).

The trainer skips an update whose gradient norm is not finite; this is the
post-mortem: run the offending batch again through ``probe_modules`` with
one thunk per stage, to name the first stage that produces NaN or Inf, and
read the gradient norm of each top-level subtree with
``grad_norms_by_subtree``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def _float_leaves(out: Any) -> List[torch.Tensor]:
    """The floating tensors of ``out`` (a tensor, or dicts, lists and tuples
    of them), in ``jax.tree.leaves``'s order: dicts by sorted key."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _float_leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [x for v in out for x in _float_leaves(v)]
    return []


def probe_modules(probes: List[Tuple[str, Callable[[], Any]]]) -> List[Dict]:
    """Run the named thunks in order; report each one's finiteness and
    statistics per floating output (``absmax``, ``nan_frac``, in fp32),
    stopping after the first non-finite one."""
    report = []
    for name, thunk in probes:
        with torch.no_grad():
            out = thunk()
        stats, bad = {}, False
        for i, leaf in enumerate(_float_leaves(out)):
            arr = leaf.detach().float()
            finite = bool(torch.isfinite(arr).all()) if arr.numel() else True
            stats[f"out{i}"] = {
                "finite": finite,
                "absmax": float(arr.abs().max()) if arr.numel() else 0.0,
                "nan_frac": float(torch.isnan(arr).float().mean()) if arr.numel() else 0.0,
            }
            bad = bad or not finite
        report.append({"name": name, "bad": bad, "stats": stats})
        if bad:
            break
    return report


def grad_norms_by_subtree(grads: Dict[str, Any]) -> Dict[str, float]:
    """The global L2 norm of each top-level entry of ``grads`` (a tensor, or
    nested dicts and lists of tensors), as ``optax.global_norm`` takes it:
    the square root of the sum of squares, in fp32."""
    return {key: float(torch.sqrt(sum((x.float() ** 2).sum() for x in _float_leaves(sub))
                                  if _float_leaves(sub) else torch.zeros(())))
            for key, sub in grads.items()}
