"""Prefetching host data loader feeding fixed-shape device batches.

Port of yolo_tpu/data/loader.py (numpy code, copied), the stand-in for the
reference's ``torch.utils.data.DataLoader`` worker processes
(train.py:127-141): workers decode/augment samples while a bounded prefetch
queue keeps the GPU fed; batches are stacked into numpy arrays, one host to
device copy per step. Two worker backends, selected by ``worker_type``:

- ``"thread"``: a thread pool (cv2/PIL release the GIL for the heavy work).
- ``"process"``: a persistent spawn-based process pool — the reference's
  32-worker-process semantics (train.py:130) for multi-core hosts where
  CPython's GIL caps the threaded decode rate. Each worker holds its own
  copy of the dataset (pickled once at spawn); one task = one batch, so
  IPC is per-batch, not per-sample.
- ``"auto"``: process when the host has >1 CPU and num_workers > 0, else
  thread (single-core hosts pay spawn cost for no parallelism).

Determinism is identical across backends, worker counts, and completion
order: augmentation draws come from per-sample stateless streams seeded by
(seed, epoch, idx) — see VOCDetectionYOLO.__getitem__ — not from a shared
RNG, so a batch's content depends only on its indices and the epoch.
Supports shuffling, drop_last, and deterministic per-epoch seeding.

Data parallelism (``shard_by_process=(d, D)``): every rank shuffles the same
index stream and loads its strided slice ``indices[d::D]``, cut to the
common ``n // D`` so that every rank yields as many batches (JAX's
multi-host mode, loader.py:91-119, 158-193). ``d``/``D`` are the **data**
coordinate and size, not the global rank: ranks that differ only in the
model coordinate load the same samples. ``batch_size`` is then the batch of
one data rank; the train CLI passes ``--batch-size / n_data``, so that
``--batch-size`` stays the global batch, as on one JAX host (JAX's
``--remote`` keeps it per host instead).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- process pool
# Module-level state/functions so they pickle by reference into spawned
# workers (the dataset ships once per worker via the initializer).

_WORKER_DATASET = None


def _process_worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_assemble(indices, epoch: int):
    ds = _WORKER_DATASET
    if hasattr(ds, "set_epoch"):
        ds.set_epoch(epoch)
    samples = [ds[int(i)] for i in indices]
    images = np.stack([s[0] for s in samples])
    targets = np.stack([s[1] for s in samples])
    return images, targets


def pad_batch(images: np.ndarray, targets: np.ndarray, batch_size: int):
    """Zero-pad a ragged final batch up to ``batch_size``.

    Returns (images, targets, n_valid) where n_valid is the real sample
    count; consumers mask out the padding (loss: sample_mask).
    """
    n = images.shape[0]
    if n >= batch_size:
        return images, targets, n
    pad = batch_size - n
    images = np.concatenate(
        [np.asarray(images), np.zeros((pad, *images.shape[1:]), images.dtype)]
    )
    targets = np.concatenate(
        [np.asarray(targets), np.zeros((pad, *targets.shape[1:]), targets.dtype)]
    )
    return images, targets, n


class DataLoader:
    """Iterate (images, targets) numpy batches from a map-style dataset.

    Args:
        dataset: object with __len__ and __getitem__ -> (image, target).
        batch_size: samples per batch.
        shuffle: reshuffle indices each epoch (seeded, reproducible).
        num_workers: decode threads (0 = synchronous).
        drop_last: drop the ragged final batch (default True: fixed shapes;
            validation pads instead of dropping).
        prefetch: max batches resident in the queue.
        seed: base shuffle seed; epoch index is mixed in.
        worker_type: "thread" | "process" | "auto" (see module docstring).
            The process pool is persistent across epochs; call ``close()``
            (or rely on interpreter exit) to reap it.
        shard_by_process: (data coordinate, data size) of this rank, or
            None: load the whole index stream (see module docstring).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = True,
        prefetch: int = 4,
        seed: int = 0,
        worker_type: str = "thread",
        shard_by_process: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.shard_by_process = shard_by_process
        self.epoch = 0
        if worker_type not in ("thread", "process", "auto"):
            raise ValueError(f"worker_type must be thread|process|auto, got {worker_type!r}")
        if worker_type == "auto":
            worker_type = (
                "process" if num_workers > 0 and (os.cpu_count() or 1) > 1 else "thread"
            )
        self.worker_type = worker_type
        self._pool = None  # lazy persistent ProcessPoolExecutor

    def close(self) -> None:
        """Reap the persistent worker-process pool (no-op for threads)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # spawn (not fork): CUDA and torch's threads in this process
            # make fork unsafe, and spawn matches every platform.
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(self.dataset,),
            )
        return self._pool

    def _local_count(self) -> int:
        """Samples this rank iterates (the same on every rank when sharded)."""
        n = len(self.dataset)
        if self.shard_by_process is None:
            return n
        return n // self.shard_by_process[1]

    def __len__(self) -> int:
        n = self._local_count()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Advance the shuffle seed + per-sample augmentation streams."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _index_batches(self) -> list:
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch * 10007)
            rng.shuffle(indices)
        if self.shard_by_process is not None:
            d, size = self.shard_by_process
            indices = indices[d::size][:self._local_count()]
            n = len(indices)
        batches = []
        step = self.batch_size
        limit = n - (n % step) if self.drop_last else n
        for start in range(0, limit, step):
            batches.append(indices[start : start + step])
        if not self.drop_last and limit < n and n % step:
            batches.append(indices[limit:])
        return batches

    def _assemble(self, batch_indices, executor) -> Tuple[np.ndarray, np.ndarray]:
        if executor is None:
            samples = [self.dataset[int(i)] for i in batch_indices]
        else:
            samples = list(executor.map(lambda i: self.dataset[int(i)], batch_indices))
        images = np.stack([s[0] for s in samples])
        targets = np.stack([s[1] for s in samples])
        return images, targets

    def _iter_process(self, batches) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Pipeline batch tasks through the persistent process pool in order."""
        from collections import deque

        pool = self._process_pool()
        max_inflight = self.num_workers + self.prefetch
        pending: deque = deque()
        batch_iter = iter(batches)

        def refill():
            while len(pending) < max_inflight:
                try:
                    b = next(batch_iter)
                except StopIteration:
                    return
                pending.append(
                    pool.submit(_process_assemble, np.asarray(b), self.epoch)
                )

        refill()
        try:
            while pending:
                result = pending.popleft().result()
                refill()
                yield result
        finally:
            # Early consumer exit (break / GeneratorExit) or a raising batch
            # task must not leave up to num_workers+prefetch stale tasks
            # queued in the persistent pool; completed-but-unconsumed results
            # are dropped either way.
            for fut in pending:
                fut.cancel()
            pending.clear()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        batches = self._index_batches()
        if self.num_workers > 0 and self.worker_type == "process":
            yield from self._iter_process(batches)
            return
        if self.num_workers <= 0:
            for b in batches:
                yield self._assemble(b, None)
            return

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as executor:
                for b in batches:
                    if stop.is_set():
                        break
                    try:
                        out_q.put(self._assemble(b, executor))
                    except Exception as exc:  # surface worker errors
                        out_q.put(exc)
                        break
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
