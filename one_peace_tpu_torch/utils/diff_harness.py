"""Layer-by-layer activation diffing harness.

SURVEY.md §7 hard part 1: numerics drift across 40 layers compounds; when
a converted checkpoint's outputs disagree with a reference run, this
utility localizes the first diverging layer.

Usage: run the JAX encoder with return_all_hiddens=True and compare each
layer's hidden state against reference activations (recorded from torch or
another JAX build):

    report = diff_layer_states(jax_hiddens, ref_hiddens)
    # [{'layer': 0, 'max_abs': ..., 'cosine': ...}, ...]
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def diff_layer_states(got: Sequence, want: Sequence,
                      names: Sequence[str] = ()) -> List[Dict]:
    """Per-layer comparison stats; ``got``/``want`` are sequences (or a
    stacked leading-axis array) of per-layer activations."""
    report = []
    n = len(got)
    for i in range(n):
        a = np.asarray(got[i], np.float64).ravel()
        b = np.asarray(want[i], np.float64).ravel()
        cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))
        report.append({
            "layer": names[i] if names else i,
            "max_abs": float(np.max(np.abs(a - b))),
            "rel_rms": float(np.sqrt(np.mean((a - b) ** 2))
                             / max(np.sqrt(np.mean(b ** 2)), 1e-12)),
            "cosine": cos,
        })
    return report


def first_divergence(report: List[Dict], cos_threshold: float = 1 - 1e-4):
    """First layer whose cosine drops below threshold, or None."""
    for row in report:
        if row["cosine"] < cos_threshold:
            return row
    return None
