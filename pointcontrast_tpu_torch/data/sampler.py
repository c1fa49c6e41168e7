"""Infinite samplers (copy of ``pointcontrast_tpu/data/sampler.py``).

``InfSampler`` pops from a reshuffled permutation forever;
``DistributedInfSampler`` strides the same permutation by shard so every
shard sees a disjoint slice per pass (rank-strided indexing, auto
re-permute).  Shard identity comes from explicit args, not from
``torch.distributed``.
"""
from __future__ import annotations

import numpy as np


class InfSampler:
    def __init__(self, num_items: int, shuffle: bool = True, seed: int = 0):
        self.num_items = num_items
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self._queue: list[int] = []

    def _refill(self):
        order = np.arange(self.num_items)
        if self.shuffle:
            self.rng.shuffle(order)
        self._queue = list(order)

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if not self._queue:
            self._refill()
        return self._queue.pop()


class DistributedInfSampler(InfSampler):
    def __init__(self, num_items: int, num_shards: int = 1, shard_id: int = 0,
                 shuffle: bool = True, seed: int = 0):
        super().__init__(num_items, shuffle, seed)
        self.num_shards = num_shards
        self.shard_id = shard_id
        self._pos = 0

    def _refill(self):
        super()._refill()
        # Pad the permutation to a multiple of num_shards (wrap-around, the
        # torch DistributedSampler convention) so every shard consumes the
        # same number of items per pass -- otherwise shards desynchronize
        # across epoch boundaries and can emit duplicates in one step.
        rem = (-len(self._queue)) % self.num_shards
        if rem:
            self._queue = self._queue + self._queue[:rem]

    def __next__(self) -> int:
        if not self._queue or self._pos >= len(self._queue):
            self._refill()
            self._pos = self.shard_id
        item = self._queue[self._pos]
        self._pos += self.num_shards
        return item
