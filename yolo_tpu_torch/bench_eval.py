"""Evaluation-pipeline throughput: ``python -m yolo_tpu_torch.bench_eval``.

Port of tools/bench_eval.py. Times the whole evaluator, ``evaluate_model``
(forward + decode + NMS + greedy matching a batch, then ``compute()`` on
the host), over ``--batches`` seeded synthetic batches of uint8 images
already on the device, with seeded targets (``--objects`` GTs an image) and
random weights, after one warm-up run. Reports:

- img/s of the whole run (CUDA events around it, or the host clock on the
  CPU), for the fast path (float32) or, with ``--precise``, the precise
  path (float64), both on the device with NMS through the kernel;
- the tail a batch, decode + NMS + matching + the copy to the host
  (``mAPMetric.update`` on the forward's grid): device ms from
  ``torch.profiler`` and wall ms;
- ``compute()``'s host seconds over the run's batches;
- the device's idle share over one run, from ``torch.profiler``.

``--int8`` evaluates the int8 serving engine (calibrated on the first
batch) instead of the float32 model. ``--device`` defaults to ``cuda``;
``--device cpu`` times with the host clock and reports no device figures.
"""

from __future__ import annotations

import argparse
import contextlib
import time

S, B, C = 7, 2, 20


class _Batches:
    """A list of (images, targets) batches with a ``batch_size``, as a loader."""

    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def synthetic_batches(n_batches: int, batch: int, size: int, objects: int, seed: int = 0):
    """Seeded uint8 images and targets with up to ``objects`` GTs an image."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        images = rng.integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8)
        targets = np.zeros((batch, S, S, B * 5 + C), np.float32)
        for n in range(batch):
            for _ in range(objects):
                ci, cj = rng.integers(0, S, 2)
                if targets[n, ci, cj, 4] == 0:
                    targets[n, ci, cj, 0:5] = [
                        rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8),
                        rng.uniform(0.05, 0.4), rng.uniform(0.05, 0.4), 1.0]
                    targets[n, ci, cj, 10 + int(rng.integers(0, C))] = 1.0
        out.append((images, targets))
    return out


def _device_ms(prof) -> float:
    """Summed device time of the kernels in a ``torch.profiler`` session, in ms."""
    import torch

    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not ("#" in e.key and "(" not in e.key)) / 1000.0


def run(batch: int = 64, batches: int = 8, image_size: int = 448, objects: int = 6,
        precise: bool = False, int8: bool = False, device: str = "cuda") -> dict:
    """Time one configuration; prints and returns its numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yolo_tpu_torch.data.transforms import device_normalize
    from yolo_tpu_torch.metrics import evaluate_model, mAPMetric
    from yolo_tpu_torch.models import create_model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: CUDA is not available (pass --device cpu)")
    model = create_model("resnet", C, S, B, device=dev, image_size=image_size,
                         generator=torch.Generator(device=dev).manual_seed(0))
    if cuda:
        model = model.to(memory_format=torch.channels_last)
    data = [(torch.from_numpy(im).to(dev), tg)
            for im, tg in synthetic_batches(batches, batch, image_size, objects)]
    forward_fn = None
    if int8:
        from yolo_tpu_torch.serving.engine import build_int8_predict, default_impl, int8_forward

        impl = default_impl()
        _, q = build_int8_predict(model, [device_normalize(data[0][0])], impl=impl)

        def forward_fn(images):
            return int8_forward(q, images, S=S, impl=impl)

    def evaluate(batches_):
        return evaluate_model(model, _Batches(batches_, batch), device=dev,
                              forward_fn=forward_fn, precise=precise, verbose=False)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    evaluate(data[:1])  # warm-up: kernel build, cuDNN plans, allocator
    sync()
    t0 = time.perf_counter()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    results = evaluate(data)
    if cuda:
        end.record()
        torch.cuda.synchronize()
        total_ms = start.elapsed_time(end)
    else:
        total_ms = (time.perf_counter() - t0) * 1000.0

    # The tail alone: update() on each batch's grid, then compute().
    with torch.inference_mode():
        grids = [forward_fn(device_normalize(im)) if int8 else
                 model(device_normalize(im).permute(0, 3, 1, 2)) for im, _ in data]
    metric = mAPMetric(num_classes=C, S=S, B=B, precise=precise)
    sync()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) if cuda else contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        for grid, (_, tg) in zip(grids, data):
            metric.update(grid, tg)
        sync()
        tail_ms = (time.perf_counter() - t0) * 1000.0 / batches
    tail_device_ms = _device_ms(prof) / batches if cuda else 0.0
    if cuda and not tail_device_ms:
        tail_device_ms = None  # the profiler saw no device time
    t0 = time.perf_counter()
    metric.compute()
    compute_s = time.perf_counter() - t0

    idle = None
    if cuda:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            evaluate(data)
            sync()
            wall_ms = (time.perf_counter() - t0) * 1000.0
        busy = _device_ms(prof)
        idle = 1 - busy / wall_ms if busy > 0 else None

    n = batch * batches
    out = {"img_s": n * 1000.0 / total_ms, "ms": total_ms, "tail_ms": tail_ms,
           "tail_device_ms": tail_device_ms, "compute_s": compute_s, "idle": idle,
           "mAP50": results["mAP50"]}
    where = f"{torch.cuda.get_device_name(dev)}" if cuda else "CPU"
    mode = "precise (float64)" if precise else "fast (float32)"
    idle_s = "not measured" if idle is None else f"{100 * idle:.1f}%"
    if cuda and idle is None:
        idle_s += " (torch.profiler saw no device time)"
    tail_dev_s = "not measured" if tail_device_ms is None else f"{tail_device_ms:.4f} ms"
    print(f"bench_eval {'int8' if int8 else 'fp32'} {mode}, batch {batch} x {batches}, "
          f"{image_size}x{image_size} uint8 on the device, {where}: "
          f"{out['img_s']:.1f} img/s ({total_ms:.1f} ms: forward + decode + NMS + match + "
          f"compute); tail a batch {tail_ms:.3f} ms wall, {tail_dev_s} device; "
          f"compute() {compute_s:.4f} s; idle {idle_s}; mAP50 {results['mAP50']:.4f} "
          f"(random weights)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=448)
    ap.add_argument("--objects", type=int, default=6, help="synthetic GT objects per image")
    ap.add_argument("--precise", action="store_true",
                    help="time the default precise path (float64 decode/NMS/matching) "
                         "instead of the fast path (float32)")
    ap.add_argument("--int8", action="store_true",
                    help="evaluate the int8 serving engine instead of the float32 model")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.batch, args.batches, args.image_size, args.objects, args.precise,
               args.int8, args.device)


if __name__ == "__main__":
    main()
