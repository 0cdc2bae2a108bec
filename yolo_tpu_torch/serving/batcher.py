"""Request batcher: coalesce single-image requests into fixed-bucket batches.

Port of yolo_tpu/serving/batcher.py. One engine call over a filled batch
costs far less per image than one call per image, so a deployment puts a
batcher in front of the engine:

- Requests (single preprocessed images) arrive on any thread via
  ``submit()`` and resolve through ``concurrent.futures.Future``s.
- A worker thread coalesces them and dispatches ONE engine call per batch,
  padding the count up to a fixed **bucket** size. On the card each bucket
  replays one captured CUDA graph (serving/graphs.py): the counterpart of
  the JAX package's one compiled executable per bucket.
- ``max_delay_ms`` bounds the fill wait: the first request in a batch never
  waits longer than this for co-riders (the latency/throughput knob).

A batch is stacked into a host buffer of its bucket (pinned where CUDA is
available, so the engine's one host-to-device copy is asynchronous); pad
rows are zeros. Every engine op maps over the batch (convs, folded BN,
decode, NMS), so pad rows cannot perturb real rows: a served result equals
a direct call on the same padded bucket bit for bit. The Detections come
back to the host in one copy a field and are sliced per image.

Works with any ``(images) -> Detections`` batch callable that takes a host
batch: a ``GraphedPredict``, or an engine closure on the CPU.

With the tracer on (``utils/tracing.py``) each request records
``batcher.wait`` (from ``submit`` to the start of its batch's dispatch, on
the worker's clock), and each batch ``batcher.stack``, ``batcher.predict``,
``batcher.copy_out`` and ``batcher.fan_out``. ``images_served /
slots_dispatched`` is the buckets' fill.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from concurrent.futures import Future
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from yolo_tpu_torch.utils import tracing


class RequestBatcher:
    """Coalesce single-image requests into fixed-bucket engine batches.

    Args:
        predict: batch callable ``(images (n, H, W, C) host tensor) ->
            Detections`` (already closed over q-params/thresholds).
        image_shape: per-image shape, e.g. ``(448, 448, 3)``.
        buckets: ascending batch sizes to pad to; each is captured once.
        max_delay_ms: max time the FIRST request of a batch waits for
            co-riders before dispatch.
        dtype: wire dtype of the stacked batch (uint8 for the on-device
            normalize path, or the engine's float dtype).
    """

    def __init__(
        self,
        predict: Callable,
        image_shape: Tuple[int, ...],
        buckets: Sequence[int] = (1, 4, 16, 64),
        max_delay_ms: float = 2.0,
        dtype=np.float32,
    ):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be ascending+unique: {buckets!r}")
        self._predict = predict
        self._image_shape = tuple(image_shape)
        self._buckets = tuple(int(b) for b in buckets)
        self._max_delay = max_delay_ms / 1e3
        self._dtype = np.dtype(dtype)
        self._pin = torch.cuda.is_available()
        self._staging: dict = {}  # bucket -> host tensor, used by the worker only
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self.batches_dispatched = 0
        self.images_served = 0
        #: Bucket rows dispatched, pad rows included.
        self.slots_dispatched = 0
        #: Batches dispatched per bucket size.
        self.bucket_batches: Counter = Counter()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- public
    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one preprocessed image; resolves to its per-image
        Detections (numpy, no batch dim)."""
        if self._closed:
            raise RuntimeError("RequestBatcher is closed")
        image = np.asarray(image, self._dtype)
        if image.shape != self._image_shape:
            raise ValueError(
                f"image shape {image.shape} != batcher shape "
                f"{self._image_shape}"
            )
        fut: Future = Future()
        self._queue.put((image, fut, time.perf_counter_ns()))
        return fut

    def warmup(self) -> None:
        """Run every bucket once (zeros batches), then wait for the results:
        over a ``GraphedPredict`` this captures each bucket's graph."""
        for b in self._buckets:
            batch = torch.from_numpy(np.zeros((b, *self._image_shape), self._dtype))
            for t in self._predict(batch):
                t.cpu()

    def close(self) -> None:
        """Flush pending requests, then stop the worker."""
        self._closed = True
        self._worker.join()
        # submit()'s closed-check and the worker's exit race by a hair: a
        # request enqueued in that window would strand its future. Fail any
        # leftovers crisply instead.
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                return
            if not fut.cancelled():
                fut.set_exception(RuntimeError("RequestBatcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        max_bucket = self._buckets[-1]
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._closed:
                    return
                continue
            batch = [first]
            deadline = time.monotonic() + self._max_delay
            while len(batch) < max_bucket:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            self._dispatch(batch)

    def _stage(self, bucket: int) -> torch.Tensor:
        buf = self._staging.get(bucket)
        if buf is None:
            buf = torch.from_numpy(np.zeros((bucket, *self._image_shape), self._dtype))
            if self._pin:
                buf = buf.pin_memory()
            self._staging[bucket] = buf
        return buf

    def _dispatch(self, batch) -> None:
        if tracing.enabled():
            start = time.perf_counter_ns()
            for b in batch:
                tracing.record("batcher.wait", b[2], start)
        images = [b[0] for b in batch]
        futures = [b[1] for b in batch]
        n = len(images)
        bucket = next((b for b in self._buckets if b >= n), self._buckets[-1])
        with tracing.span("batcher.stack"):
            stacked = self._stage(bucket)
            host = stacked.numpy()
            np.stack(images, out=host[:n])
            host[n:] = 0
        try:
            with tracing.span("batcher.predict"):
                dets = self._predict(stacked)
            # One copy a field; the host waits for the batch here, so the
            # staging buffer and a graph's outputs are free for the next one.
            with tracing.span("batcher.copy_out"):
                fields = [t.cpu().numpy() for t in dets]
        except Exception as exc:  # noqa: BLE001 — fail the waiters, keep serving
            for fut in futures:
                if not fut.cancelled():
                    fut.set_exception(exc)
            return
        self.batches_dispatched += 1
        self.images_served += n
        self.slots_dispatched += bucket
        self.bucket_batches[bucket] += 1
        with tracing.span("batcher.fan_out"):
            for i, fut in enumerate(futures):
                # A caller may have cancelled while we computed; set_result on
                # a cancelled future raises and would kill the worker thread.
                if not fut.cancelled():
                    fut.set_result(type(dets)(*(a[i] for a in fields)))
