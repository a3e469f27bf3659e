"""Relative-position bucket index tables.

A copy of ``one_peace_tpu/models/rel_pos.py``: importing that module runs
``one_peace_tpu/models/__init__.py``, which imports JAX.  The tests hold the
two copies equal.  Host-side numpy precomputation — the tables are
deterministic functions of the config, never trained, and small.

Semantics match the reference exactly:
- 1-D log-bucketed distances for text/audio (ref: adapter/text.py:18-29,
  adapter/audio.py:20-32) with the CLS row/col remapped to 3 dedicated
  buckets (text.py:64-67).
- 2-D relative coordinates for images (ref: adapter/image.py:19-34).
"""

from __future__ import annotations

import math

import numpy as np


def make_token_bucket_position(bucket_size: int, max_position: int = 1024) -> np.ndarray:
    """1-D relative position -> bucket index, shape (max_position, max_position).

    Buckets: exact relative position within +/- bucket_size//2, then
    log-spaced out to max_position (ref: adapter/text.py:18-29).
    Output values lie in [0, 2*bucket_size-2].
    """
    context_pos = np.arange(max_position, dtype=np.int64)[:, None]
    memory_pos = np.arange(max_position, dtype=np.int64)[None, :]
    relative_pos = context_pos - memory_pos
    sign = np.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = np.where(
        (relative_pos < mid) & (relative_pos > -mid), mid - 1, np.abs(relative_pos)
    )
    # log-bucket the tail; np.errstate silences log(0) that is masked out below
    with np.errstate(divide="ignore"):
        log_pos = mid + np.ceil(
            np.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1)
        ).astype(np.int64)
    bucket_pos = np.where(abs_pos <= mid, relative_pos, log_pos * sign).astype(np.int64)
    return bucket_pos + bucket_size - 1


def make_token_bucket_position_with_cls(bucket_size: int, max_position: int = 1024) -> np.ndarray:
    """Token bucket table with row/col 0 (CLS) remapped to 3 extra buckets
    (ref: adapter/text.py:64-67, adapter/audio.py:103-106).

    Table is indexed by positions *including* the prepended CLS token; the
    embedding table for it has 2*bucket_size-1+3 rows.
    """
    num_rel_dis = 2 * bucket_size - 1
    rp = make_token_bucket_position(bucket_size, max_position)
    rp[0, :] = num_rel_dis
    rp[:, 0] = num_rel_dis + 1
    rp[0, 0] = num_rel_dis + 2
    return rp


def make_image_bucket_position(bucket_size: int) -> np.ndarray:
    """2-D relative position -> bucket index over a (bucket_size x bucket_size)
    grid plus a CLS token, shape (bs*bs+1, bs*bs+1)
    (ref: adapter/image.py:19-34).

    The embedding table for it has (2*bs-1)**2 + 3 rows; the last three are
    CLS-to-patch, patch-to-CLS and CLS-to-CLS.
    """
    num_relative_distance = (2 * bucket_size - 1) ** 2 + 3
    coords_h = np.arange(bucket_size)
    coords_w = np.arange(bucket_size)
    coords = np.stack(np.meshgrid(coords_h, coords_w, indexing="ij"))  # 2, H, W
    coords_flatten = coords.reshape(2, -1)  # 2, H*W
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.transpose(1, 2, 0)  # HW, HW, 2
    relative_coords[:, :, 0] += bucket_size - 1
    relative_coords[:, :, 1] += bucket_size - 1
    relative_coords[:, :, 0] *= 2 * bucket_size - 1
    rp = np.zeros((bucket_size**2 + 1, bucket_size**2 + 1), dtype=np.int64)
    rp[1:, 1:] = relative_coords.sum(-1)
    rp[0, 0:] = num_relative_distance - 3
    rp[0:, 0] = num_relative_distance - 2
    rp[0, 0] = num_relative_distance - 1
    return rp
