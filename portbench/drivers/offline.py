"""Offline (bulk) detection: a closed loop of whole batches from a pool.

Parameters: ``batch``, ``pool_batches`` (distinct seeded uint8 batches in
pinned host memory), ``engine`` and its thresholds (``systems.py``),
``calibration_batches`` x ``calibration_batch`` seeded images for the int8
build. Each call copies one pool batch in, replays the graph and copies
every field of its Detections out; the next call starts when the host holds
them. ``images_per_s`` is every image of the window over the window.

The check compares each pool batch's Detections from the window's last pass
over the pool with the reference's on the same images.
"""

from __future__ import annotations

import time

import torch

from portbench import compare, systems, traffic


def _pool(run) -> torch.Tensor:
    p, cfg = run.params, run.model_config()
    return traffic.uint8_images(run.seed_for("pool"), p["pool_batches"] * p["batch"],
                                cfg["image_size"], run.device)


def drive(run) -> None:
    p = run.params
    batch = int(p["batch"])
    pool_dev = _pool(run)
    pool = traffic.host_batches(pool_dev, batch)
    del pool_dev
    served = systems.served(run)
    last = [[t.cpu() for t in served(b)] for b in pool]  # captures, warms every shape
    run.setup_done()

    n = 0
    with run.window():
        t0 = time.perf_counter()
        while True:
            i = n % len(pool)
            dets = served(pool[i])
            last[i] = [t.cpu() for t in dets]
            n += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
    run.metrics["images_per_s"] = n * batch / elapsed
    run.window_counts.update(batches=n, images=n * batch, seconds=elapsed)
    run.attempted = n * batch
    run.read_memory_peak()
    del served, dets, pool
    systems.free_device()
    check(run, last)


def check(run, outputs) -> None:
    """Each pool batch's last Detections against the reference's."""
    p, cfg = run.params, run.model_config()
    t0 = time.perf_counter()
    ref = run.reference()
    sd = systems.seeded_weights(run)
    state = ref.prepare(cfg, sd, systems.calibration_images(run), 127)
    del sd
    pool = _pool(run).split(int(p["batch"]))
    worst: dict = {}
    scores, kept = [], 0
    for i, images in enumerate(pool):
        want = ref.serve(cfg, state, images, float(p["conf_threshold"]),
                         float(p["nms_threshold"]))
        compare.worst_of(worst, compare.detections(outputs[i], want))
        scores.append(want.scores.float().cpu())
        kept += int(want.valid.sum())
    run.notes.append(f"check: {sum(int(s.shape[0]) for s in scores)} images in "
                     f"{time.perf_counter() - t0:.2f} s; reference candidate scores median "
                     f"{float(torch.cat(scores).median()):.6g}, {kept} kept after NMS")
    run.checks.update({k: (v, run.limit(k)) for k, v in worst.items()})
