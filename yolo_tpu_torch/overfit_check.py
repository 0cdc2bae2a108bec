"""Convergence check: memorize one small synthetic batch end to end.

    python -m yolo_tpu_torch.overfit_check [--steps 2000] [--batch 16] [--size 224]

Port of tools/overfit_check.py, same recipe, defaults and pass rule. The
flagship train step (ResNet50 backbone, YOLO loss, Adam, clipping, BN
updates; bf16 autocast, as the JAX tool's bf16 model) runs ``--steps``
times on one fixed batch of synthetic images (noise with one or two bright
class-coloured squares, each an object), then the same batch goes through
the forward and the mAP evaluator (confidence 0.1, NMS 0.4). PASS: the loss
falls more than 20x and the memorized batch reaches mAP50 > 0.5.
``--device`` defaults to ``cuda``; ``--device cpu`` runs on the CPU (use
few steps and a small ``--size`` there).
"""

from __future__ import annotations

import argparse
import sys

S, NUM_CLASSES = 7, 20


def synthetic_batch(seed: int, n: int, size: int):
    """(images (n, size, size, 3) float32, targets (n, 7, 7, 30)), the JAX
    tools' recipe: noise, and one or two objects an image, each a square of
    side 0.15-0.3 centred in its cell, painted 2.0 in channel ``class % 3``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.normal(0, 0.3, size=(n, size, size, 3)).astype(np.float32)
    targets = np.zeros((n, S, S, 30), np.float32)
    for i in range(n):
        for _ in range(int(rng.integers(1, 3))):
            ci, cj = rng.integers(1, S - 1, 2)
            cx, cy = (cj + 0.5) / S, (ci + 0.5) / S
            w = h = float(rng.uniform(0.15, 0.3))
            cls = int(rng.integers(0, NUM_CLASSES))
            if targets[i, ci, cj, 4] == 0:
                targets[i, ci, cj, 0:5] = [0.5, 0.5, w, h, 1.0]
                targets[i, ci, cj, 10 + cls] = 1.0
                x0, y0 = int((cx - w / 2) * size), int((cy - h / 2) * size)
                x1, y1 = int((cx + w / 2) * size), int((cy + h / 2) * size)
                images[i, y0:y1, x0:x1, cls % 3] = 2.0
    return images, targets


def train_on_batch(args, log_every: int = 200):
    """Train the flagship on the seed-0 synthetic batch for ``args.steps`` steps.

    Returns (model, images, targets, first loss, final loss), images and
    targets as tensors on ``args.device``.
    """
    import torch

    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.training.optim import make_optimizer
    from yolo_tpu_torch.training.trainer import Trainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available (pass --device cpu)")
    images, targets = synthetic_batch(0, args.batch, args.size)
    images, targets = torch.from_numpy(images).to(device), torch.from_numpy(targets).to(device)

    model = create_model("resnet", NUM_CLASSES, S, 2, device=device, image_size=args.size,
                         generator=torch.Generator(device=device).manual_seed(0))
    model.head.fc_layers[3].manual_seed(0)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    # Decay late so that Adam stops oscillating around the memorized optimum.
    optimizer, schedule = make_optimizer(
        model, args.lr, 0.0, [int(args.steps * 0.6), int(args.steps * 0.85)])
    trainer = Trainer(model, optimizer, schedule, device=device, use_amp=True)

    first_loss = None
    for step in range(1, args.steps + 1):
        parts = trainer.train_step(images, targets)
        if step == 1 or step % log_every == 0:
            loss = float(parts["total"])
            first_loss = loss if first_loss is None else first_loss
            print(f"step {step}: loss {loss:.4f}", flush=True)
    return model, images, targets, first_loss, float(parts["total"])


def predict_grid(model, images):
    """The trained model's (N, 7, 7, 30) float32 grid, eval mode, bf16 autocast."""
    import torch

    model.eval()
    with torch.inference_mode(), torch.autocast(images.device.type, dtype=torch.bfloat16):
        return model(images.permute(0, 3, 1, 2)).float()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Memorize one synthetic batch; mAP gate")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from yolo_tpu_torch.metrics import mAPMetric

    model, images, targets, first_loss, final_loss = train_on_batch(args, args.log_every)
    metric = mAPMetric(num_classes=NUM_CLASSES, conf_threshold=0.1, nms_threshold=0.4)
    metric.update(predict_grid(model, images), targets)
    results = metric.compute()

    print(f"\nloss {first_loss:.2f} -> {final_loss:.4f}"
          f" ({first_loss / max(final_loss, 1e-9):.0f}x)")
    print(f"memorized-batch mAP50 {results['mAP50']:.3f}"
          f" | recall {results['recall']:.3f} | precision {results['precision']:.3f}")
    ok = final_loss < first_loss / 20 and results["mAP50"] > 0.5
    print("CONVERGENCE:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
