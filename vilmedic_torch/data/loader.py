"""Host-side data loader and device prefetch (port of ``DataLoader`` and
``DevicePrefetch`` of ``data/loader.py``).

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
batch in order, so the draws are those of ``num_workers=0``. Under a
process group each process takes the strided shard ``batch[rank::world]``.

:class:`DevicePrefetch` places batches on the device ahead of the step
that reads them: a producer thread runs ``depth`` batches ahead of the
consumer, in order. For a CUDA device each host tensor is pinned, copied
without blocking and run through the placement (the Trainor's: the copy
and the dataset's pending device preprocessing, the crop+normalize kernel)
on a CUDA stream of the prefetcher's own; the consumer's stream waits on an
event recorded after that work, and every device tensor of the batch is
marked as used by the consumer's stream (``record_stream``), so that the
caching allocator does not hand its memory to a later batch while the step
still reads it. For the CPU it is the same thread without a stream. A
failure in the producer (loading, pinning, the copy or a kernel launch) is
raised on the consumer; nothing is retried.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Iterator

import numpy as np
import torch

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


def pin_batch(batch: dict) -> dict:
    """The batch with every CPU tensor in pinned host memory."""
    return {k: v.pin_memory() if isinstance(v, torch.Tensor) and v.device.type == "cpu" else v
            for k, v in batch.items()}


class DevicePrefetch:
    """Iterates ``place_fn(batch)`` for every batch of ``iterable``, the
    placement run by a producer thread up to ``depth`` batches ahead
    (module doc). Batches are dicts, as the loaders collate them;
    ``device`` is where ``place_fn`` puts their tensors, and a CUDA device
    gets the copy stream."""

    def __init__(self, iterable, place_fn: Callable, depth: int = 2, device="cpu"):
        self.iterable = iterable
        self.place_fn = place_fn
        self.depth = max(1, int(depth))
        self.device = torch.device(device)

    def _producer(self, out_q: "queue.Queue", stop: threading.Event, stream) -> None:
        it = iter(self.iterable)
        try:
            # the stream's context makes its device current too; None: no-op
            with torch.cuda.stream(stream):
                for host_batch in it:
                    if stop.is_set():
                        return
                    if stream is None:
                        batch, event = self.place_fn(host_batch), None
                    else:
                        batch = self.place_fn(pin_batch(host_batch))
                        event = torch.cuda.Event()
                        event.record(stream)
                    out_q.put((batch, event))
            out_q.put(_SENTINEL)
        except BaseException as e:  # handed to the consumer, which re-raises it
            out_q.put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # a loader's own producer thread ends too
                close()

    def __iter__(self) -> Iterator:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        thread = threading.Thread(target=self._producer, args=(out_q, stop, stream),
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for v in batch.values():
                        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                            v.record_stream(current)
                yield batch
        finally:
            stop.set()
            while thread.is_alive():  # unblock a producer waiting on a full queue
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
