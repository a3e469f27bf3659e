"""The global batch across data ranks.

The JAX package's ``dataset.batch_size`` is the global batch, which one
process feeds to the whole mesh.  Here every data rank builds the same
global batch and keeps its contiguous slice, in rank order
(``slice_rows``).  While the trainer runs the criterion on that slice it
opens ``batch_rows`` with every rank's row count, and the pieces below make
what depends on the whole batch come out as on one process:

- ``gather_rows``: a tensor's rows from every rank, in rank order, without a
  gradient (the contrastive losses' gallery side, which the JAX loss holds
  under ``stop_gradient``);
- ``global_mean`` / ``global_sum``: a sum over this rank's rows divided by a
  count over all ranks, or such a sum alone, in the convention the trainer
  merges the ranks' losses and metrics by: rank r's value weighted by
  ``b_r / B`` (its share of the global batch), summed over ranks;
- ``batch_rand``: uniforms drawn for the global batch and sliced to this
  rank's rows, so that dropout, drop path and the detector's draws per row
  are those of one process running the whole batch.

Outside ``batch_rows`` (one process, or evaluation) each is the plain local
computation.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_STATE = threading.local()


class Rows:
    """Every rank's row count and this rank's index among them."""

    def __init__(self, sizes: Sequence[int], rank: int):
        self.sizes = [int(s) for s in sizes]
        self.rank = rank
        self.local = self.sizes[rank]
        self.total = sum(self.sizes)
        self.offset = sum(self.sizes[:rank])

    @property
    def share(self) -> float:
        """This rank's share of the global batch, ``b_r / B``."""
        return self.local / self.total


def current_rows() -> Optional[Rows]:
    return getattr(_STATE, "rows", None)


@contextlib.contextmanager
def batch_rows(rows: Optional[Rows]):
    """Run the block with ``rows`` as the batch layout across ranks."""
    before = current_rows()
    _STATE.rows = rows
    try:
        yield rows
    finally:
        _STATE.rows = before


def split_sizes(total: int, world: int) -> List[int]:
    """Contiguous slice sizes of ``total`` rows over ``world`` ranks: the
    first ``total % world`` ranks take one row more."""
    base, extra = divmod(total, world)
    return [base + (1 if r < extra else 0) for r in range(world)]


def slice_rows(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s contiguous slice of a collated global batch: every
    array or tensor whose leading dimension is the batch's row count (the
    length of its ``id`` column, or of its first array) is cut; other values
    (counts, scalars) stay as they are."""
    if world == 1:
        return batch
    rows = len(batch["id"]) if "id" in batch else next(
        len(v) for v in batch.values()
        if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) > 0)
    sizes = split_sizes(rows, world)
    start = sum(sizes[:rank])
    stop = start + sizes[rank]
    return {k: v[start:stop] if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) > 0
            and len(v) == rows else v for k, v in batch.items()}


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of ``x`` from every rank, concatenated in rank order, without
    a gradient; ``x`` itself outside ``batch_rows``."""
    rows = current_rows()
    if rows is None or len(rows.sizes) == 1:
        return x
    x = x.detach().contiguous()
    width = max(rows.sizes)
    padded = x.new_zeros((width,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in rows.sizes]
    dist.all_gather(parts, padded)
    return torch.cat([p[:n] for p, n in zip(parts, rows.sizes)])


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (detached); ``x`` outside
    ``batch_rows``."""
    rows = current_rows()
    if rows is None or len(rows.sizes) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def global_mean(total: torch.Tensor, count: torch.Tensor,
                min_count: Optional[float] = None) -> torch.Tensor:
    """``total`` (a sum over this rank's rows) over ``count`` summed over
    every rank (at least ``min_count``), scaled by ``B / b_r``: weighted by
    ``b_r / B`` and summed over ranks it is the sum over the global batch
    over the global count."""
    rows = current_rows()
    if rows is not None and len(rows.sizes) > 1:
        count = all_sum(count)
    if min_count is not None:
        count = count.clamp(min=min_count)
    if rows is None or len(rows.sizes) == 1:
        return total / count
    return total / count / rows.share


def global_sum(total: torch.Tensor) -> torch.Tensor:
    """``total`` (a sum over this rank's rows) scaled by ``B / b_r``:
    weighted by ``b_r / B`` and summed over ranks it is the global sum."""
    rows = current_rows()
    if rows is None or len(rows.sizes) == 1:
        return total
    return total / rows.share


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator],
               device=None, dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)``; inside ``batch_rows``, with ``shape[dim]`` this
    rank's row count, drawn for the global batch and cut to this rank's
    rows."""
    shape = tuple(shape)
    rows = current_rows()
    if rows is None or len(rows.sizes) == 1 or len(shape) <= dim or shape[dim] != rows.local:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand(shape[:dim] + (rows.total,) + shape[dim + 1:], generator=generator,
                      device=device)
    return full.narrow(dim, rows.offset, rows.local)


def leading_rows():
    """(offset, global row count) of this rank's rows, or (0, None)."""
    rows = current_rows()
    if rows is None:
        return 0, None
    return rows.offset, rows.total


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local shard of an FSDP parameter or gradient (a ``DTensor``), or
    ``t`` itself: in-place arithmetic on it changes the shard."""
    return t.to_local() if hasattr(t, "to_local") else t
