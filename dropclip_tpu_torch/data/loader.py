"""Threaded prefetching batch loader.

Copy of ``dropclip_tpu/data/loader.py``. Replaces torch
``DataLoader(num_workers=8)`` + ``DistributedSampler`` (reference
tools/train_distil.py:160-180): file reads and numpy release the GIL, so
a thread pool keeps loader workers busy while the main thread feeds the
device; shuffling is a per-epoch permutation from a (seed, epoch) fold
(replacing sampler.set_epoch, reference :225), the same order as the JAX
loader's; a process of several takes its ``shard_index``-strided shard
(replacing DistributedSampler's rank split).

The reference's ``MultiEpochsDataLoader`` (utils/misc.py:342-371) exists
to keep torch worker PROCESSES alive across epochs; workers here are
threads in a per-epoch pool whose spin-up is microseconds, so the
persistent-worker trick is unnecessary by construction (and the
per-epoch ``with`` block guarantees cleanup on early exit).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate: Callable,
                 shuffle: bool = True, num_workers: int = 8, seed: int = 42,
                 drop_last: bool = True, shard_index: int = 0,
                 num_shards: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def __iter__(self) -> Iterator:
        order = self._order()
        nb = len(self)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = []

            def submit(b):
                lo = b * self.batch_size
                sel = order[lo: lo + self.batch_size]
                futures.append(pool.submit(
                    lambda s: self.collate([self.dataset[int(i)] for i in s]),
                    sel))

            for b in range(min(self.prefetch, nb)):
                submit(b)
            for b in range(nb):
                batch = futures.pop(0).result()
                nxt = b + self.prefetch
                if nxt < nb:
                    submit(nxt)
                yield batch
