"""Host batching and the host→device prefetch (counterpart of
``ddim_cold_tpu/data/loader.py``, which replaced DataLoader +
DistributedSampler).

Each process loads its own shard of the index order, ``shard_index`` of
``shard_count`` (the JAX loader's semantics, DistributedSampler's rank
interleaving, multi_gpu_trainer.py:61-64): the order is cut to a multiple
of the shard count (drop_last) or padded up to one by wrapping around, and
shard i takes ``indices[i::shard_count]``. The trainer passes the rank's
coordinate on the mesh's ``data`` axis, so the seq ranks of one data row
read the same rows.

* train: a per-epoch permutation from ``seed + epoch``, drop_last;
* eval: no shuffle; ``pad_final_batch`` rounds the last batch up to full
  size by wrapping around, as the JAX loader does, so the batch order and
  contents per (seed, epoch) are the JAX loader's.

Decode overlaps device compute: a producer thread assembles batch after
batch into a bounded queue, so at most ``prefetch + 1`` decoded batches
exist at once. A batch comes from the dataset's native fast path
(``get_batch``: decode, resize and degrade in C++ threads), or with
``raw=True`` from ``get_raw_batch``, or item by item over a thread pool
when the fast path says None (PIL decode releases the GIL).
``ShardedLoader.routes`` counts the batches by the route that built them.
The ``data.next`` fault site fires at the top of every batch, so an
injected fault surfaces at the consumer's ``next()`` as a decode failure
would.
:func:`device_prefetch` then copies each batch from pinned host memory to
the card on a side stream, one batch ahead of the step that consumes it.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from ddim_cold_torch.utils import faults


class ShardedLoader:
    """Iterable over host batches of numpy arrays: ``(noisy, target, t)``,
    or ``(base, t)`` with ``raw=True`` (the device-corruption path)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool, seed: int = 42,
                 drop_last: bool = True, shard_index: int = 0, shard_count: int = 1,
                 num_threads: int = 8, prefetch: int = 2,
                 pad_final_batch: bool = False, raw: bool = False):
        if raw and not hasattr(dataset, "get_raw_batch"):
            raise ValueError(
                f"raw=True needs dataset.get_raw_batch; {type(dataset).__name__} "
                "does not implement the device-side corruption contract")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} outside [0, {shard_count})")
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.pad_final_batch = pad_final_batch
        self.raw = raw
        self.epoch = 0
        #: batches built, by route: "raw", "get_batch" or "per_item"
        self.routes: collections.Counter = collections.Counter()

    def set_epoch(self, epoch: int) -> None:
        """Reseed the epoch shuffle (mirrors DistributedSampler.set_epoch)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _shard_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            indices = np.arange(n)
        world = self.shard_count
        if self.drop_last:
            indices = indices[:(n // world) * world]
        else:
            total = -(-n // world) * world  # up to a multiple of the shards
            if total > n:
                indices = np.resize(indices, total)  # wrap-around pad
        return indices[self.shard_index::world]

    def __len__(self) -> int:
        per_shard = len(self._shard_indices())
        if self.drop_last:
            return per_shard // self.batch_size
        return -(-per_shard // self.batch_size)

    def _batches(self) -> list[np.ndarray]:
        indices = self._shard_indices()
        nb = len(self)
        if self.pad_final_batch and nb * self.batch_size > len(indices):
            indices = np.resize(indices, nb * self.batch_size)
        return [indices[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(nb)]

    def _make_batch(self, idxs: np.ndarray, pool: Optional[ThreadPoolExecutor] = None):
        faults.fire("data.next", tag=f"epoch:{self.epoch}|")
        threads = max(1, self.num_threads)
        batch = None
        if self.raw:  # (base, t) only — corruption happens on the device
            route, batch = "raw", self.dataset.get_raw_batch(idxs, num_threads=threads,
                                                             pool=pool)
        else:
            get_batch = getattr(self.dataset, "get_batch", None)
            if get_batch is not None:
                route, batch = "get_batch", get_batch(idxs, num_threads=threads, pool=pool)
        if batch is None:  # no fast path for this batch: item by item
            mapper = pool.map if pool is not None else map
            items = list(mapper(self.dataset.__getitem__, [int(i) for i in idxs]))
            route, batch = "per_item", (
                np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
                np.asarray([it[2] for it in items], dtype=np.int32))
        self.routes[route] += 1
        return batch

    def __iter__(self) -> Iterator:
        batches = self._batches()
        if self.num_threads <= 1:
            for b in batches:
                yield self._make_batch(b)
            return
        with ThreadPoolExecutor(self.num_threads) as pool:
            yield from background_map(
                batches, lambda b: self._make_batch(b, pool), self.prefetch)


def background_map(items, fn, depth: int):
    """Yield ``fn(item)`` with the mapping running ``depth`` items ahead in a
    producer thread (bounded queue; counterpart of the JAX loader's
    ``_background_map``). Exceptions from ``fn`` or the iterator surface at
    the consuming ``next()``; abandoning the generator (break, close) stops
    the producer within one item. Shared by the decode pipeline
    (:class:`ShardedLoader`) and the serving engine's batch assembly."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for it in items:
                if stop.is_set() or not put(fn(it)):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 — worker thread: ANY error must surface to the consumer
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.2)


def group_batches(batches, n: int):
    """Stack every ``n`` successive batches along a new leading axis (the
    host half of a multi-step dispatch); a trailing partial group is
    dropped, as ``drop_last`` does."""
    if n <= 1:
        yield from batches
        return
    buf = []
    for b in batches:
        buf.append(b)
        if len(buf) == n:
            yield tuple(np.stack(xs) for xs in zip(*buf))
            buf = []


def device_prefetch(batches, device, depth: int = 2):
    """Yield each host batch as a tuple of tensors on ``device``.

    On CUDA the copies run ``depth − 1`` batches ahead on a side stream,
    from pinned host memory with ``non_blocking=True``, so the host→device
    copy of batch n+1 overlaps the step on batch n. The consumer's stream
    waits for a batch's copy before it is handed out, and each tensor is
    recorded on that stream so the allocator keeps its memory until the
    consumer is done. On the CPU it only wraps the arrays.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in b)
        return
    side = torch.cuda.Stream(device)
    pending: collections.deque = collections.deque()

    def ready(entry):
        placed, event = entry
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in placed:
            t.record_stream(current)
        return placed

    for b in batches:
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in b]
        with torch.cuda.stream(side):
            placed = tuple(h.to(device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(side)
        pending.append((placed, event))
        if len(pending) >= max(1, depth):
            yield ready(pending.popleft())
    while pending:
        yield ready(pending.popleft())
