"""Training-step and input-pipeline throughput: ``python -m yolo_tpu_torch.bench_train``.

Port of tools/bench_train.py for the GPU. It measures
1. the optimizer step (forward + loss + backward + clip + Adam + schedule,
   BN statistics included) of the full-width ResNet50 YOLOv1 at 448x448 in
   bf16 autocast, timed with CUDA events after warm-up;
2. the host data pipeline (decode + augment + batch) in images per second,
   which must exceed (1) to keep the card fed.

``--fused-bn`` selects the ``"stats"`` fused-BN mode, as in JAX; ``"full"``
is reached through the model API (``create_model(fused_bn="full")``).
Every rate names the card it ran on.
"""

from __future__ import annotations

import argparse
import time


def bench_step(batch: int, fused_bn: bool | str = False, iters: int = 6) -> float:
    """Milliseconds per optimizer step on the card (CUDA events, after warm-up)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.models.backbones import fused_mode
    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("bench_train: needs a CUDA device")
    dev = torch.device("cuda")
    model = create_model("resnet", 20, 7, 2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0),
                         fused_bn=fused_bn).to(memory_format=torch.channels_last)
    optimizer, schedule = make_optimizer(model, 1e-4, 5e-4, milestones_steps=[10**9])
    trainer = Trainer(model, optimizer, schedule, device=dev, use_amp=True)

    r = np.random.default_rng(1)
    images = torch.from_numpy(r.integers(0, 256, (batch, 448, 448, 3), dtype=np.uint8)).to(dev)
    targets = torch.zeros((batch, 7, 7, 30), device=dev)
    targets[:, 3, 3, 0:5] = torch.tensor([0.5, 0.5, 0.2, 0.2, 1.0])
    targets[:, 3, 3, 17] = 1.0

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator, kernel build
        trainer.train_step(images, targets)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        parts = trainer.train_step(images, targets)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    tag = f", fused-bn {fused_mode(fused_bn)}" if fused_bn else ""
    print(f"train step (b{batch}, 448^2, bf16 autocast{tag}) on "
          f"{torch.cuda.get_device_name(0)}: {ms:.2f} ms -> {batch / ms * 1e3:.1f} img/s "
          f"(CUDA events, {iters} steps after 2 warm-up; loss {float(parts['total']):.4f})")
    return ms


def bench_pipeline(data_root: str, batch: int, workers: int) -> None:
    from yolo_tpu_torch.data import DataLoader, create_voc_datasets

    try:
        ds = create_voc_datasets([("2007", "trainval")], root=data_root, augment=True,
                                 normalize_host=False)
    except (FileNotFoundError, ValueError) as exc:
        print(f"input pipeline: skipped (no dataset at {data_root}: {exc})")
        return
    batch = max(1, min(batch, len(ds) // 2))
    loader = DataLoader(ds, batch_size=batch, shuffle=True, num_workers=workers)
    n = 0
    t0 = time.perf_counter()
    for _ in range(4):  # small datasets: several passes for a stable rate
        for images, _targets in loader:
            n += images.shape[0]
        if n >= 8 * batch:
            break
    dt = time.perf_counter() - t0
    if n == 0:
        print("input pipeline: skipped (dataset smaller than one batch)")
    else:
        print(f"input pipeline ({workers} thread workers, augment, b{batch}): "
              f"{n / dt:.0f} img/s host")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--data-root", default="./data")
    p.add_argument("--num-workers", type=int, default=16)
    p.add_argument("--fused-bn", action="store_true",
                   help="fused-BN 'stats' mode (the CUDA statistics kernel)")
    args = p.parse_args(argv)
    bench_step(args.batch, fused_bn="stats" if args.fused_bn else False)
    bench_pipeline(args.data_root, args.batch, args.num_workers)


if __name__ == "__main__":
    main()
