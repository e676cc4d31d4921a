"""Threaded prefetching batch loader with device staging (torch port of
``impersonator_tpu/data/loader.py:25-118``).

Worker threads read and collate batches ahead of the step; with a
``device`` each batch goes to it as a dict of tensors (:func:`stage_batch`):
on CUDA from pinned host memory on a side stream, one batch ahead of the
one the step is using, and the step's stream waits only for its own
batch's copy. Images turn from the datasets' NHWC (B, 2, S, S, 3) into
the trainer's NCHW (B, 2, 3, S, S) once, on the device.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator

import numpy as np
import torch


def _collate(samples) -> dict:
    return {key: np.stack([s[key] for s in samples]) for key in samples[0]}


def _layout(key: str, t: torch.Tensor) -> torch.Tensor:
    """NHWC image stacks -> NCHW; other arrays as they are."""
    if key in ("images", "bg") and t.ndim >= 4:
        perm = list(range(t.ndim - 3)) + [t.ndim - 1, t.ndim - 3, t.ndim - 2]
        return t.permute(*perm).contiguous()
    return t


def stage_batch(batch: dict, device, stream=None) -> dict:
    """A collated numpy batch (or pinned tensors of it) -> tensors on
    ``device``, images NCHW. On CUDA with ``stream`` the copies and the
    layout change run on that stream."""
    device = torch.device(device)
    out = {}
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        for k, v in batch.items():
            t = torch.as_tensor(v)
            t = t.to(device, non_blocking=t.is_pinned())
            out[k] = _layout(k, t)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, prefetch: int = 4, seed: int = 0,
                 drop_last: bool = True, device=None,
                 shard_index: int = 0, shard_count: int = 1):
        """Batches of ``batch_size`` samples. The index stream is the JAX
        loader's: a permutation by numpy's generator of ``seed + epoch``
        (epochs counted from 1), cut into global batches of
        ``batch_size * shard_count`` rows of which this process takes rows
        ``shard_index * batch_size`` onwards. ``device`` None yields the
        collated numpy arrays (NHWC), otherwise tensors on the device
        (:func:`stage_batch`)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.device = None if device is None else torch.device(device)
        if not 0 <= shard_index < shard_count:
            raise ValueError((shard_index, shard_count))
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._epoch = 0

    def __len__(self):
        global_bs = self.batch_size * self.shard_count
        n = len(self.dataset) // global_bs
        if not self.drop_last and len(self.dataset) % global_bs:
            n += 1
        return max(n, 1)

    def _batches_of_indices(self):
        n = len(self.dataset)
        global_bs = self.batch_size * self.shard_count
        idx = np.arange(max(n, global_bs))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        lo = self.shard_index * self.batch_size
        for i in range(0, len(idx) - global_bs + 1, global_bs):
            g = idx[i:i + global_bs] % max(n, 1)
            yield g[lo:lo + self.batch_size]

    def _host_batches(self) -> Iterator[dict]:
        """Collated batches in index order, read by the worker threads
        (pinned when they go to a CUDA device)."""
        self._epoch += 1
        index_batches = list(self._batches_of_indices())
        n_batches = len(index_batches)
        pin = self.device is not None and self.device.type == "cuda"
        batch_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        cursor = {"i": 0}
        lock = threading.Lock()
        done = threading.Event()

        def worker():
            while not done.is_set():
                with lock:
                    i = cursor["i"]
                    if i >= n_batches:
                        return
                    cursor["i"] += 1
                try:
                    batch = _collate([self.dataset[int(j)]
                                      for j in index_batches[i]])
                    if pin:
                        batch = {k: torch.from_numpy(v).pin_memory()
                                 for k, v in batch.items()}
                except Exception as e:  # raised in the consumer's thread
                    batch = e
                while not done.is_set():
                    try:
                        batch_q.put((i, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending = {}
            for next_emit in range(n_batches):
                while next_emit not in pending:
                    i, batch = batch_q.get()
                    pending[i] = batch
                batch = pending.pop(next_emit)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            done.set()
            for t in threads:
                t.join()

    def __iter__(self) -> Iterator[dict]:
        if self.device is None:
            yield from self._host_batches()
            return
        if self.device.type != "cuda":
            for batch in self._host_batches():
                yield stage_batch(batch, self.device)
            return
        side = torch.cuda.Stream(self.device)
        staged = None
        for batch in self._host_batches():
            nxt = stage_batch(batch, self.device, side)
            ready = torch.cuda.Event()
            ready.record(side)
            if staged is not None:
                yield self._hand_over(*staged)
            staged = (nxt, ready)
        if staged is not None:
            yield self._hand_over(*staged)

    def _hand_over(self, batch, ready):
        """The step's stream waits for this batch's copy; the allocator
        learns that the step's stream uses the side stream's tensors."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        for t in batch.values():
            t.record_stream(cur)
        return batch
