"""Cross-process merge for the evaluation reducers (counterpart of
``one_peace_tpu/metrics/gather.py``, which gathers over JAX processes).

- ``gather_ragged``: every process's rows of a host array, concatenated in
  rank order (the reference's padded ``all_gather``); the identity with one
  process;
- ``allsum``: a scalar or fixed-shape host array summed over the processes
  (the merge of counter-style reducers); the identity with one process.

Both go through ``torch.distributed`` (``all_gather_object``: NCCL on the
card, gloo on the CPU) over the data ranks (``parallel.mesh.data_group``:
a ``tp``, ``sp`` or ``pp`` replica scored the same rows and is not merged
again), and fail if a collective does.

The JAX reducers gather only when a global that nothing sets says the data
was process-sharded.  Here the merge keys on the ``num_shards`` of the
iterator the evaluation ran over (``eval_gather_ragged`` /
``eval_allsum``): a sharded evaluation is merged, and ranks that were each
fed the whole set are replicas, which merging would count once per rank.
Every rank must call a merge, with or without rows of its own.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..parallel.mesh import data_group, data_rank_world


def _world() -> int:
    return data_rank_world()[1]


def gather_ragged(local: np.ndarray) -> np.ndarray:
    """Concatenate a variable-length leading-dim array from every process in
    rank order; identity with one process.  A process without rows may pass
    an empty array of any shape."""
    local = np.asarray(local)
    if _world() == 1:
        return local
    parts = [None] * _world()
    dist.all_gather_object(parts, local, group=data_group())
    parts = [np.asarray(p) for p in parts if np.asarray(p).size]
    return np.concatenate(parts) if parts else local


def allsum(local) -> np.ndarray:
    """Sum a scalar or fixed-shape array across processes (identity with one
    process)."""
    local = np.asarray(local)
    if _world() == 1:
        return local
    parts = [None] * _world()
    dist.all_gather_object(parts, local, group=data_group())
    return np.sum(np.stack([np.asarray(p) for p in parts]), axis=0)


def eval_gather_ragged(local: np.ndarray, num_shards: int) -> np.ndarray:
    return gather_ragged(local) if num_shards > 1 else np.asarray(local)


def eval_allsum(local, num_shards: int) -> np.ndarray:
    return allsum(local) if num_shards > 1 else np.asarray(local)
