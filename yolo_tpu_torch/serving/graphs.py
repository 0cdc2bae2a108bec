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
- Each graph has its own private memory pool; no pool is shared, so any
  replay order is safe.
- A failed capture raises with the CUDA error. There is no eager fallback:
  the CPU path is the caller's explicit choice, and a CPU device raises.

The kernels' launch counts (``kernels.LAUNCHES``, by C entry point) move
at capture, not at replay. So each graph keeps how far each count moved
during its capture, and :meth:`GraphedPredict.launches` gives the launches
its replays issued: replays x captured launches, summed over the shapes.
``captures`` and ``replays`` count both.

With the tracer on (``utils/tracing.py``), a call records ``graphs.copy_in``
and ``graphs.replay`` (host times only: their reader, the idle-gap labels,
reads no more, and timing events in the stream of every call cost the card
idle time), and a capture ``graphs.capture`` (with its warm-up runs). The
spans the callable records become event-record nodes only in a second
graph of the same shape, captured on the same input buffer while the
tracer is on and dropped once it is off: the plain graph has exactly the
nodes it has with the tracer off. One call in ``tracing.READ_EVERY``
replays the traced graph; its device times are read at a later call, once
it has completed and after that call's replay is launched (so the reading
overlaps the card's work), and never waited for.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Dict, Tuple

import torch

from yolo_tpu_torch.ops.decode import Detections
from yolo_tpu_torch.utils import kernels, tracing

#: Eager runs of the callable before each capture.
WARMUP_RUNS = 2


class _Graph:
    """The graphs of one (shape, dtype): the plain graph, its static buffers
    and the launches its capture counted; with the tracer on, the traced
    graph (same input buffer), its outputs and its captured spans; the
    replays, and the last traced replay's span records still to be read."""

    __slots__ = ("graph", "static_in", "static_out", "launches", "traced", "traced_out",
                 "spans", "replays", "pending")

    def __init__(self, graph, static_in, static_out, launches):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches
        self.traced = self.traced_out = None
        self.spans, self.replays, self.pending = [], 0, []


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
        self._graphs: Dict[Tuple, _Graph] = {}
        self._lock = threading.Lock()
        self.captures = 0

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self._graphs.values())

    def launches(self) -> Counter:
        """Kernel launches issued by the replays so far, by C entry point."""
        out = Counter()
        for g in self._graphs.values():
            out.update({k: g.replays * n for k, n in g.launches.items()})
        return out

    def __call__(self, images) -> Detections:
        images = torch.as_tensor(images)
        key = (tuple(images.shape), images.dtype)
        with self._lock, torch.cuda.device(self.device), torch.inference_mode():
            g = self._graphs.get(key)
            if g is None:
                with tracing.span("graphs.capture"):
                    g = self._graphs[key] = self._capture(*key)
            if (g.traced is None) == tracing.enabled():
                self._retrace(g)
            with tracing.span("graphs.copy_in", device=False):
                g.static_in.copy_(images, non_blocking=True)
            traced = g.traced is not None and (g.replays + 1) % tracing.READ_EVERY == 0
            if traced:
                tracing.settle(g.pending)  # before the replay records its events anew
            with tracing.span("graphs.replay", device=False) as replay:
                (g.traced if traced else g.graph).replay()
            g.replays += 1
            if traced:
                g.pending = tracing.replayed(g.spans, replay)
                return g.traced_out
            # The last traced replay's device times, read while the card runs this one.
            tracing.settle(g.pending, force=False)
            return g.static_out

    def _retrace(self, g: _Graph) -> None:
        """Capture the traced graph of ``g`` now that the tracer is on, or
        drop it (and its memory pool) now that it is off."""
        tracing.settle(g.pending)
        if not tracing.enabled():
            g.traced = g.traced_out = None
            g.spans = []
            return
        with tracing.span("graphs.capture"), tracing.collecting() as spans:
            g.traced, g.traced_out = self._graph_of(g.static_in)
        g.spans = spans
        self.captures += 1

    def _capture(self, shape, dtype) -> _Graph:
        static_in = torch.zeros(shape, dtype=dtype, device=self.device)
        self._warm_up(static_in)
        before = Counter(kernels.LAUNCHES)
        graph, static_out = self._graph_of(static_in)
        self.captures += 1
        return _Graph(graph, static_in, static_out, kernels.LAUNCHES - before)

    def _warm_up(self, static_in: torch.Tensor) -> None:
        """Eager runs on a side stream, as torch.cuda.graph's docs ask: kernels
        are built, shared-memory attributes set and cuBLAS/cuDNN handles made
        before the capture, which allows none of that."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._predict(static_in)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _graph_of(self, static_in: torch.Tensor):
        """One capture of the callable on ``static_in``: the graph and its
        static outputs, in a memory pool of its own."""
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                static_out = self._predict(static_in)
        except RuntimeError as exc:
            raise RuntimeError(
                f"CUDA graph capture of a {tuple(static_in.shape)} {static_in.dtype} batch "
                f"failed: {exc}") from exc
        return graph, static_out
