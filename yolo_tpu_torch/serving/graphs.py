"""One captured CUDA graph per batch shape of a serving callable.

The port's counterpart of the JAX package's one compiled executable per
shape (yolo_tpu/inference.py:127-146, the int8 engine's jit at
yolo_tpu/serving/engine.py:360). Eagerly, a served batch of the int8 engine
is ~60 kernel launches and ~25 decode ops issued one by one from Python, and
at small batches the card waits on that host work. A graph issues them all
with one launch.

:class:`GraphedPredict` wraps a closed ``(images) -> Detections`` callable
(q-params and thresholds bound) on one CUDA device. The first call at a
(shape, dtype) runs the callable eagerly on a side stream (every kernel is
built and has its attributes set), then captures one ``torch.cuda.CUDAGraph``
of it on a static input buffer. Each call copies the images into that
buffer and replays the graph.

- The thresholds are host values at capture (the decode's rounded
  threshold, the NMS kernel's float argument), so a new (conf, nms) pair
  needs a new wrapper, as JAX's static arguments need a new compile.
- The q-params are captured by address. The wrapper's callable holds them;
  an engine rebuilt with new q-params needs a new wrapper.
- Each (shape, dtype) has its own private memory pool; no pool is shared,
  so any replay order is safe.
- A failed capture raises with the CUDA error. There is no eager fallback:
  the CPU path is the caller's explicit choice, and a CPU device raises.

The kernel wrappers' Python launch counters move at capture, not at replay.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

import torch

from yolo_tpu_torch.ops.decode import Detections

#: Eager runs of the callable before each capture.
WARMUP_RUNS = 2


class GraphedPredict:
    """``(images) -> Detections`` replayed from one CUDA graph per (shape, dtype).

    Args:
        predict: closed ``(images (n, H, W, 3) on ``device``) -> Detections``:
            ``YOLOInference.batch_fn(conf, nms)``, or ``lambda images: fn(q,
            images, conf, nms)`` over ``engine.make_int8_engine_fn``'s ``fn``.
            It must issue no host synchronization (none of the port's
            engines does).
        device: a CUDA device.

    A call accepts numpy arrays or tensors on any device (a pinned host
    tensor makes its copy asynchronous). The returned Detections are the
    graph's static outputs: valid until the next call at the same shape, so
    copy them before calling again. Calls are serialized by a lock.
    """

    def __init__(self, predict: Callable[[torch.Tensor], Detections], device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"GraphedPredict captures CUDA graphs and needs a CUDA device, got {device}; "
                f"call the engine directly to run it eagerly on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._predict = predict
        self._graphs: Dict[Tuple, Tuple] = {}
        self._lock = threading.Lock()

    def __call__(self, images) -> Detections:
        images = torch.as_tensor(images)
        key = (tuple(images.shape), images.dtype)
        with self._lock, torch.cuda.device(self.device), torch.inference_mode():
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(*key)
            graph, static_in, static_out = entry
            static_in.copy_(images, non_blocking=True)
            graph.replay()
            return static_out

    def _capture(self, shape, dtype) -> Tuple:
        static_in = torch.zeros(shape, dtype=dtype, device=self.device)
        # Eager runs on a side stream, as torch.cuda.graph's docs ask: kernels
        # are built, shared-memory attributes set and cuBLAS/cuDNN handles
        # made before the capture, which allows none of that.
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._predict(static_in)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                static_out = self._predict(static_in)
        except RuntimeError as exc:
            raise RuntimeError(
                f"CUDA graph capture of a {tuple(shape)} {dtype} batch failed: {exc}") from exc
        return graph, static_in, static_out

