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

One difference from the JAX package: every generator a batch draws from
in fetch order is saved with the position, in the state it had after the
last batch served (not after the prefetcher's), and restored on load, so a
resumed run draws the augmentations the straight run drew.  These are the
dataset's ``rng`` (a ``np.random.RandomState``: crops, flips, masks),
each of its augmenters' ``random.Random`` (an attribute holding one as
``rng``: distortion, blur, RandAugment), and whatever the task adds to
``generators`` (image_classify's Mixup).  The JAX iterator saves none of
them.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def strided_slice(order: List[int], shard: int, num_shards: int) -> List[int]:
    """Contiguous per-shard allocation (ref utils/data_utils.py:new_islice
    semantics: shard i gets the i-th contiguous run of its strided count)."""
    counts = [len(range(i, len(order), num_shards)) for i in range(num_shards)]
    start = sum(counts[:shard])
    return order[start:start + counts[shard]]


def dataset_generators(dataset) -> Dict:
    """The generators ``dataset`` draws its samples from, by name: its
    ``rng`` and each attribute whose ``rng`` is a ``random.Random``."""
    found = {}
    if isinstance(getattr(dataset, "rng", None), np.random.RandomState):
        found["rng"] = dataset.rng
    for name, value in sorted(getattr(dataset, "__dict__", {}).items()):
        if isinstance(getattr(value, "rng", None), random.Random):
            found[name] = value.rng
    return found


def _get_state(gen):
    return gen.get_state() if isinstance(gen, np.random.RandomState) else gen.getstate()


def _encode(state) -> list:
    """A generator's state as tensors and plain values, for weights_only loads."""
    if len(state) == 5:  # np.random.RandomState: (name, keys, pos, has_gauss, gauss)
        name, keys, pos, has_gauss, gauss = state
        return [name, torch.from_numpy(keys.astype(np.int64)), int(pos), int(has_gauss),
                float(gauss)]
    version, internal, gauss = state  # random.Random
    return [version, torch.tensor(internal, dtype=torch.int64), gauss]


def _restore(gen, state) -> None:
    if isinstance(gen, np.random.RandomState):
        name, keys, pos, has_gauss, gauss = state
        gen.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, gauss))
    else:
        version, internal, gauss = state
        gen.setstate((version, tuple(int(x) for x in internal), gauss))


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
        # name -> generator the batches draw from; a task may add its own
        self.generators = dataset_generators(dataset)
        self._drawn = {}  # their states after the last batch served

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

        gens = dict(self.generators)

        def fetch(batch_ids):
            """The collated batch and the generators' states after it."""
            samples = [self.dataset[i] for i in batch_ids]
            batch = self.collate_fn(samples)
            return batch, {name: _get_state(g) for name, g in gens.items()}

        def produce(out_q: queue.Queue):
            try:
                for batch_ids in batches:
                    out_q.put(fetch(batch_ids))
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
                batch, self._drawn = item
                yield batch
        else:
            for batch_ids in batches:
                batch, self._drawn = fetch(batch_ids)
                self._consumed += 1
                yield batch
        self.epoch += 1
        self._consumed = 0

    def first_batch_ids(self):
        """Index lists of the next batches to be served (test/debug hook)."""
        return self._batches_for_epoch(self.epoch)[self._consumed:]

    # ------------------------------------------------------------------
    # preemption-safe resume (ref iterators.py:179-216)

    def state_dict(self):
        """The position, and each generator's state after the last batch
        served: the dataset's ``rng`` as ``data_rng``, the others under
        ``generators``."""
        state = {"epoch": self.epoch, "consumed": self._consumed, "seed": self.seed}
        drawn = {name: _encode(s) for name, s in self._drawn.items()}
        if "rng" in drawn:
            state["data_rng"] = drawn.pop("rng")
        if drawn:
            state["generators"] = drawn
        return state

    def load_state_dict(self, state):
        """Restore a ``state_dict``; a state with only ``data_rng`` (as
        iterators saved before the augmenters' generators were) restores
        the dataset's ``rng`` alone."""
        self.epoch = state["epoch"]
        self._consumed = state.get("consumed", 0)
        # restore the shuffle seed too: fast-forwarding `consumed` batches
        # through a DIFFERENT seed's shuffle order silently skips/repeats
        # other samples across the preemption boundary
        self.seed = state.get("seed", self.seed)
        saved = dict(state.get("generators", {}))
        if "data_rng" in state:
            saved["rng"] = state["data_rng"]
        for name, encoded in saved.items():
            _restore(self.generators[name], encoded)
        self._drawn = {name: _get_state(self.generators[name]) for name in saved}
