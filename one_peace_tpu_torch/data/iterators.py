"""Resumable, sharded epoch batch iterator.

The port's copy of ``one_peace_tpu/data/iterators.py`` (held equal by
``tests/test_torch_port_retrieval_data.py``).

Behavioral spec: ref one_peace/data/iterators.py:17-267 — deterministic
per-epoch shuffle (seed + epoch), strided sharding across data-parallel
workers (new_islice), ``ensure_equal_batch`` padding so every shard sees
the same batch count, state_dict/fast-forward for preemption-safe resume.

One card is one shard, so ``num_shards`` is 1 on the port's training
path; the multi-shard arithmetic is kept for data-parallel runs.  A
background-thread prefetcher overlaps host-side decode/augment with device
steps (the reference uses DataLoader workers).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np


def strided_slice(order: List[int], shard: int, num_shards: int) -> List[int]:
    """Contiguous per-shard allocation (ref utils/data_utils.py:new_islice
    semantics: shard i gets the i-th contiguous run of its strided count)."""
    counts = [len(range(i, len(order), num_shards)) for i in range(num_shards)]
    start = sum(counts[:shard])
    return order[start:start + counts[shard]]


class EpochBatchIterator:
    def __init__(
        self,
        dataset,
        collate_fn: Callable,
        batch_size: int,
        seed: int = 3407,
        shard_id: int = 0,
        num_shards: int = 1,
        shuffle: bool = True,
        ensure_equal_batch: bool = True,
        skip_remainder_batch: bool = False,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.ensure_equal_batch = ensure_equal_batch
        self.skip_remainder_batch = skip_remainder_batch
        self.prefetch = prefetch
        self.epoch = 1
        self._consumed = 0

    # ------------------------------------------------------------------

    def _batches_for_epoch(self, epoch: int,
                           shuffle: Optional[bool] = None) -> List[List[int]]:
        n = len(self.dataset)
        order = list(range(n))
        if self.shuffle if shuffle is None else shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            order = list(rng.permutation(n))
        # pad so every shard gets equal batches (ref base_task.py
        # ensure_equal_batch): cycle the order as many times as needed —
        # a single `order[:pad]` underfills when the dataset is smaller
        # than half the global batch, yielding short/unequal shard
        # batches (desynced data-parallel collectives)
        total = self.num_shards * self.batch_size
        if self.ensure_equal_batch and n % total != 0:
            target = n + (total - n % total)
            reps = -(-target // n)
            order = (order * reps)[:target]
        elif self.skip_remainder_batch and n % total != 0:
            order = order[: n - n % total]
        mine = strided_slice(order, self.shard_id, self.num_shards)
        return [mine[i:i + self.batch_size]
                for i in range(0, len(mine), self.batch_size)]

    def __len__(self):
        return len(self._batches_for_epoch(self.epoch))

    def next_epoch_itr(self, shuffle: Optional[bool] = None) -> Iterator:
        # ``shuffle`` overrides the constructor setting for THIS epoch
        # (ref fairseq EpochBatchIterator.next_epoch_itr(shuffle=...))
        batches = self._batches_for_epoch(self.epoch, shuffle=shuffle)
        # resume mid-epoch from the absolute consumed offset: ``_consumed``
        # keeps counting from ``start`` so a second preemption during the
        # resumed epoch still records the true position
        # (ref one_peace/data/iterators.py:194-216 fast-forward semantics)
        return self._iterate(batches, self._consumed)

    def end_of_epoch(self) -> bool:
        return self._consumed >= len(self)

    def _iterate(self, batches: List[List[int]], start: int = 0):
        batches = batches[start:]

        def produce(out_q: queue.Queue):
            try:
                for batch_ids in batches:
                    samples = [self.dataset[i] for i in batch_ids]
                    out_q.put(self.collate_fn(samples))
                out_q.put(None)
            except Exception as e:  # surface worker errors
                out_q.put(e)

        if self.prefetch > 0:
            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            t = threading.Thread(target=produce, args=(q,), daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                self._consumed += 1
                yield item
        else:
            for batch_ids in batches:
                samples = [self.dataset[i] for i in batch_ids]
                self._consumed += 1
                yield self.collate_fn(samples)
        self.epoch += 1
        self._consumed = 0

    def first_batch_ids(self):
        """Index lists of the next batches to be served (test/debug hook)."""
        return self._batches_for_epoch(self.epoch)[self._consumed:]

    # ------------------------------------------------------------------
    # preemption-safe resume (ref iterators.py:179-216)

    def state_dict(self):
        return {"epoch": self.epoch, "consumed": self._consumed,
                "seed": self.seed}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self._consumed = state.get("consumed", 0)
        # restore the shuffle seed too: fast-forwarding `consumed` batches
        # through a DIFFERENT seed's shuffle order silently skips/repeats
        # other samples across the preemption boundary
        self.seed = state.get("seed", self.seed)
