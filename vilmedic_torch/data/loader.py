"""Host-side data loader (port of ``DataLoader`` of ``data/loader.py``).

Sampling as the JAX package's loader: for a shuffled loader the order of an
epoch is ``np.random.default_rng(seed + epoch)``'s permutation
(:meth:`DataLoader.set_epoch`), with ``drop_last`` dropping a short last
batch; otherwise the dataset order. Batches are the dataset's collate of its
items, CPU tensors. With ``num_workers`` > 0 a producer thread loads the
next ``prefetch`` batches on a pool of that many threads (decoding and
resizing release the interpreter lock), keeping the batches in order. A
dataset whose items draw random numbers splits them into ``decode(index)``,
which draws nothing and runs in parallel, and ``finish(decoded)``, which
draws; the finishes and the collate, which may draw too, run batch after
batch in order, so the draws are those of ``num_workers=0``.
Single process, single device: no per-host sharding, and no device-side
prefetch (the JAX package's ``DevicePrefetch`` is not ported).
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Iterator

import numpy as np

_SENTINEL = object()


class _InOrder:
    """Turns taken by batch number: ``turn(k)`` waits until the turns of
    0 .. k-1 have ended."""

    def __init__(self):
        self.next = 0
        self.cond = threading.Condition()

    @contextmanager
    def turn(self, k: int):
        with self.cond:
            self.cond.wait_for(lambda: self.next == k)
        try:
            yield
        finally:
            with self.cond:
                self.next += 1
                self.cond.notify_all()


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 4, shard_index: int = 0,
                 num_shards: int = 1):
        if shuffle and batch_size % num_shards:
            raise ValueError(f"the global train batch size {batch_size} must divide evenly "
                             f"across {num_shards} processes")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = dataset.get_collate_fn()
        self.num_workers = max(0, int(num_workers))
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.shard_index, self.num_shards = int(shard_index), int(num_shards)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """The shuffle of every later ``__iter__`` is this epoch's."""
        self.epoch = epoch

    def batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = [order[s: s + self.batch_size] for s in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.num_shards > 1:
            batches = [b[self.shard_index::self.num_shards] for b in batches]
            batches = [b for b in batches if len(b)]
        return batches

    def _load(self, indices, order: _InOrder | None = None, k: int = 0):
        ds = self.dataset
        if order is None or not hasattr(ds, "decode"):
            return self.collate_fn([ds[int(i)] for i in indices])
        decoded, error = None, None
        try:
            decoded = [ds.decode(int(i)) for i in indices]
        except BaseException as e:  # raised in turn, so later batches still get theirs
            error = e
        with order.turn(k):
            if error is not None:
                raise error
            return self.collate_fn([ds.finish(d) for d in decoded])

    def __iter__(self) -> Iterator:
        batches = self.batch_indices()
        if self.num_workers == 0:
            for b in batches:
                yield self._load(b)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        order = _InOrder()

        def producer():
            try:
                # the pool starts loads in submission order, so a load that
                # waits for its turn never waits on one that has not started
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    futures = [pool.submit(self._load, b, order, k)
                               for k, b in enumerate(batches[:self.prefetch])]
                    following = enumerate(batches[self.prefetch:], self.prefetch)
                    while futures and not stop.is_set():
                        # a failed load re-raises here and reaches the consumer
                        out_q.put(futures.pop(0).result())
                        nxt = next(following, None)
                        if nxt is not None:
                            futures.append(pool.submit(self._load, nxt[1], order, nxt[0]))
                    for f in futures:
                        f.cancel()
                out_q.put(_SENTINEL)
            except BaseException as e:  # handed to the consumer, which re-raises it
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer waiting on a full queue
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
