"""Prefetching pair loader (port of ``pointcontrast_tpu/data/loader.py``).

A thread-pool pipeline: sample indices -> ``__getitem__`` in parallel ->
collate to a static-shaped host ``PairBatch`` -> bounded prefetch queue.
The heavy per-sample work (quantize, hash join, pyramid build) is numpy,
which releases the GIL inside its C kernels, so threads scale without a
process fork.  The batches stay on the host: the trainer moves each one
with ``PairBatch.to(device)``, which bounds-checks it.  From the same
dataset and seed, the batches are byte-identical to the JAX package's
``PairLoader``'s (fused frames), shard by shard: shard r of N
(``num_shards``, ``shard_id``; a data-parallel rank's, from
``parallel.multihost.shard_info``) draws sampler shard r and seeds its rng
``seed + rng_salt * r``, as JAX's does.  A rank feeds one device, so
``num_device_batches`` stays 1: JAX stacks N device batches in one process,
the port runs N processes.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.data.sampler import DistributedInfSampler


class PrefetchLoaderBase:
    """Infinite threaded loader: sampler -> pooled ``__getitem__`` with
    per-task RNGs -> subclass ``_collate`` -> bounded queue.

    Subclasses set their config fields, then call ``_start_pipeline``.  The
    producer thread alone draws from the loader's ``rng`` (the per-sample
    seeds, then the collation); each pool task gets a ``RandomState`` of
    its own.  An exception from the dataset or the collator is raised from
    ``__next__`` and the producer keeps going, so a transient per-sample
    failure does not leave later ``__next__`` calls blocking on a dead
    thread.  ``close()`` stops the producer and the pool.
    """

    def _start_pipeline(
        self,
        dataset,
        batch_size: int,
        num_device_batches: int,
        shuffle: bool,
        seed: int,
        num_shards: int,
        shard_id: int,
        num_workers: int,
        prefetch: int,
        rng_salt: int,
    ):
        if num_device_batches != 1:
            raise ValueError(
                f"num_device_batches={num_device_batches}: a loader feeds one "
                "device; for data parallelism run one process per device, each "
                "with its shard (num_shards, shard_id)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_device_batches = num_device_batches
        self.sampler = DistributedInfSampler(len(dataset), num_shards, shard_id,
                                             shuffle, seed)
        self.rng = np.random.RandomState(seed + rng_salt * shard_id)
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _collate(self, samples):
        raise NotImplementedError

    def _one_device_batch(self):
        idxs = [next(self.sampler) for _ in range(self.batch_size)]
        # np.random.RandomState is not thread-safe: hand each pool task its
        # own RNG seeded from the (single-threaded) producer stream.
        seeds = [int(self.rng.randint(0, 2**31 - 1)) for _ in idxs]
        samples = list(
            self._pool.map(
                lambda iv: self.dataset.__getitem__(
                    iv[0], rng=np.random.RandomState(iv[1])
                ),
                zip(idxs, seeds),
            )
        )
        return self._collate(samples)

    def _produce(self):
        while not self._stop.is_set():
            try:
                batch = self._one_device_batch()
            except Exception as e:
                # propagate to the consumer but KEEP PRODUCING (see class doc)
                batch = e
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 60.0):
        """Stop the producer thread and the pool and drop queued batches:
        waits up to ``timeout`` seconds for the thread to finish the batch
        in hand."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout)
        self._drain()
        self._pool.shutdown(wait=False)

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class PairLoader(PrefetchLoaderBase):
    """Fused-frame pair batches (``collate_pair``) in ``mode`` 'nce' or
    'hardest' and ``layout``, from ``dataset``, shard ``shard_id`` of
    ``num_shards`` (rng salt 13, as JAX's); ``num_device_batches`` must be
    1 (one device)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        scheme: PadScheme,
        mode: str = "nce",
        npos: int = 4096,
        num_pos: int = 4096,
        num_hn: int = 1024,
        num_device_batches: int = 1,
        num_workers: int = 2,
        prefetch: int = 2,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_id: int = 0,
        conv0_kernel_size: int = 3,
        layout: str = "chunked",
    ):
        self.layout = layout
        self.scheme = scheme
        self.mode = mode
        self.npos = npos
        self.num_pos = num_pos
        self.num_hn = num_hn
        self.conv0_kernel_size = conv0_kernel_size
        self._start_pipeline(
            dataset, batch_size, num_device_batches, shuffle, seed,
            num_shards, shard_id, num_workers, prefetch, rng_salt=13,
        )

    def _collate(self, samples):
        return collate_pair(
            samples,
            self.scheme,
            mode=self.mode,
            npos=self.npos,
            num_pos=self.num_pos,
            num_hn=self.num_hn,
            rng=self.rng,
            fuse_frames=True,
            conv0_kernel_size=self.conv0_kernel_size,
            layout=self.layout,
        )
