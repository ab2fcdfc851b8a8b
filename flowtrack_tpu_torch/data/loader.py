"""Batched, prefetching data loader.

Port of ``flowtrack_tpu/data/loader.py``: ``collate`` and ``BatchLoader``
(loader.py:20-127) and ``device_prefetch`` (:130). A pool of threads reads
and augments items (cv2 and numpy release the interpreter lock for the
heavy parts), batches are stacked into numpy arrays, and a producer thread
keeps ``prefetch_batches`` of them ready. ``device_prefetch`` copies each
batch into pinned host memory and on to the device with ``non_blocking``
copies, keeping ``size`` batches in flight; with a sharding, each batch
goes to the mesh's devices as its slots' parts.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from flowtrack_tpu_torch.parallel.mesh import part


def collate(items) -> Dict[str, np.ndarray]:
    return {key: np.stack([np.asarray(it[key]) for it in items])
            for key in items[0]}


class BatchLoader:
    """Iterate dicts of stacked numpy arrays over a PoseDataset. Shuffles
    with a generator of its own (``seed``); each epoch first calls the
    dataset's ``set_epoch``. ``pad_to_batch`` fills a short last batch by
    repeating its last item; ``n_valid`` counts the real ones.
    ``shard=(i, n)`` (with ``drop_last``) reads only the i-th of n equal
    parts of each batch: one rank's share of a batch split over a mesh
    (items are augmented by their index, so the parts equal the whole
    batch's rows)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8,
                 pad_to_batch: bool = False, seed: int = 0,
                 prefetch_batches: int = 2, shard=(0, 1)):
        index, parts = shard
        if parts > 1 and (not drop_last or batch_size % parts):
            raise ValueError(f"a shard of {parts} parts needs drop_last and "
                             f"a batch that divides, got {batch_size}")
        self.shard = (index, parts)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.pad_to_batch = pad_to_batch
        self.rng = np.random.default_rng(seed)
        self.prefetch_batches = prefetch_batches
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _make_batch(self, pool, chunk):
        chunk = part(chunk, *self.shard)
        items = list(pool.map(self.dataset.__getitem__, chunk))
        batch = collate(items)
        n_valid = len(items)
        if self.pad_to_batch and n_valid < self.batch_size:
            pad = self.batch_size - n_valid
            batch = {k: np.concatenate(
                [v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}
        batch["n_valid"] = np.asarray(n_valid)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        sentinel = object()
        stop = threading.Event()
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1

        def bounded_put(item):
            # gives up once the consumer has stopped iterating, so that an
            # abandoned epoch leaks no blocked producer
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # an exception in __getitem__ or collate reaches the consumer
            # through the queue instead of cutting the epoch short
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for chunk in self._batch_indices():
                        if stop.is_set():
                            return
                        if not bounded_put(self._make_batch(pool, chunk)):
                            return
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    bounded_put(e)
                finally:
                    bounded_put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()


def _to_device(batch, device):
    out = {}
    n_valid = batch.get("n_valid")
    for k, v in batch.items():
        if k == "n_valid":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    if n_valid is not None:
        out["n_valid"] = int(n_valid)
    return out


def _to_slots(batch, sharding):
    """A host batch -> one batch per mesh slot (1-D mesh), each slot's
    equal part of every array copied to the slot's device, ``n_valid`` the
    whole batch's on each."""
    devices = sharding.mesh.flat()
    if len(sharding.mesh.axis_names) != 1:
        raise ValueError("a batch shards over a 1-D mesh")
    return [_to_device({k: v if k == "n_valid" else part(v, i, len(devices))
                        for k, v in batch.items()}, dev)
            for i, dev in enumerate(devices)]


def device_prefetch(iterator, device="cuda", size: int = 2, sharding=None):
    """Yield the iterator's numpy batches as tensors on ``device``, with
    ``size`` batches copied ahead (pinned host memory, ``non_blocking``
    copies on the current stream); ``n_valid`` stays a Python int. With
    ``sharding`` (``parallel.batch_sharding(mesh)``) each batch is a list
    of its mesh slots' batches instead, each slot's part of every array on
    the slot's device, ``n_valid`` (the whole batch's) on each."""
    if sharding is None:
        device = torch.device(device)

        def put(batch):
            return _to_device(batch, device)
    else:
        def put(batch):
            return _to_slots(batch, sharding)
    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield out
