"""Device-time measurement with CUDA events.

Port of yolo_tpu/utils/timing.py. The JAX package took device durations
from a ``jax.profiler`` trace, because its remote TPU's host clocks were not
trustworthy. On a local card, CUDA events recorded on the stream around each
call measure the device's time for it; ``torch.profiler`` drops events in
some profiling runs on the card (PERF.md), so nothing here depends on it.
"""

from __future__ import annotations


def device_time_ms(fn, *args, iters: int = 6, warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn(*args)`` on the current stream.

    Warms up ``warmup`` times; then each of ``iters`` calls runs between two
    CUDA events, and the host waits for it once, after the closing event,
    outside the timed window (the wait also keeps unconsumed outputs from
    piling up). Needs a CUDA device.
    """
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters
