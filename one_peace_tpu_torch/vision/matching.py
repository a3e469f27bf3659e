"""Bipartite matching for the Mask2Former set loss (counterpart of
``one_peace_tpu/vision/matching.py``).

The JAX package assigns with a fixed-shape auction in lax ops because a host
callback does not belong in a pjit program on the TPU.  The port uses the
reference's own assignment instead: mmdet's ``MaskHungarianAssigner`` calls
``scipy.optimize.linear_sum_assignment`` on the host.  Every cost matrix of
a step (each prediction level of each image) comes to the host in one
fetch, and the columns go back to the device in one copy.

The contract is ``auction_assign``'s: a (K, N) cost with K <= N and a (K,)
row_valid in, (K,) distinct columns out, minimising the valid rows' total
cost; a padded row gets one of the columns the valid rows left, in
ascending order.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from torch.profiler import record_function


def assign(cost: np.ndarray, row_valid: np.ndarray) -> np.ndarray:
    """One (K, N) cost matrix -> (K,) int64 distinct columns; the optimum
    over the valid rows, the padded rows given the leftover columns."""
    k, n = cost.shape
    if k > n:
        raise ValueError(f"cost {cost.shape}: more rows than columns")
    col = np.empty(k, np.int64)
    rows = np.flatnonzero(row_valid)
    r, c = linear_sum_assignment(cost[rows].astype(np.float64))
    col[rows[r]] = c
    col[np.flatnonzero(~row_valid)] = np.setdiff1d(np.arange(n), c)[:k - len(rows)]
    return col


def hungarian_assign(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Cost matrices (..., K, N) and row_valid (..., K) on any device ->
    (..., K) int64 columns on that device.  One fetch to the host for all
    of them, ``assign`` on each, one copy back.  The assignment carries no
    gradient."""
    lead = cost.shape[:-2]
    with record_function("hungarian_assign"):  # the host's share of an update
        costs = cost.detach().float().cpu().numpy().reshape((-1,) + tuple(cost.shape[-2:]))
        valid = row_valid.detach().cpu().numpy().astype(bool).reshape(costs.shape[:2])
        cols = np.stack([assign(c, v) for c, v in zip(costs, valid)])
        return torch.from_numpy(cols.reshape(lead + (cost.shape[-2],))).to(cost.device)
