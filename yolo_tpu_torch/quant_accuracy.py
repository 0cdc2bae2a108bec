"""Accuracy gate for the int8 serving engine: a trained model, the full pipeline.

    python -m yolo_tpu_torch.quant_accuracy [--steps 1500] [--size 224] [--chain] [--wino SPEC]

Port of tools/quant_accuracy.py. Trains the flagship on one synthetic batch
until it detects (the ``overfit_check`` recipe), then runs the same images
through

1. the trained model (bf16 autocast, the JAX tool's bf16 model: "fp32/bf16");
2. the default int8 engine (``default_impl()``: the stem-front kernel and
   the int8 conv kernel for every conv), calibrated on a held-out synthetic
   batch of the same recipe (seed 1);
3. with ``--chain``, the same engine with stages 1-3 as fused chains
   (``cuda_bottleneck.chain_int8``; JAX's ``--pallas``);
4. with ``--wino SPEC``, an engine whose convs in SPEC (e.g.
   ``head_conv1,head_conv3,head_conv4``) run as int8 Winograd convs,

and holds each through the mAP evaluator (confidence 0.1, NMS 0.4). PASS:
the trained model reaches mAP50 > 0.5, and each int8 engine's mAP50 is
within 1 point of it. ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import sys

from yolo_tpu_torch.overfit_check import NUM_CLASSES, predict_grid, train_on_batch


def calibration_batch(n: int, size: int):
    """A held-out batch of the same recipe (seed 1, one object an image): the
    measured images must not set the deployed activation scales."""
    import numpy as np

    rng = np.random.default_rng(1)
    calib = rng.normal(0, 0.3, size=(n, size, size, 3)).astype(np.float32)
    for i in range(n):
        ci, cj = rng.integers(1, 6, 2)
        w = h = float(rng.uniform(0.15, 0.3))
        cls = int(rng.integers(0, NUM_CLASSES))
        x0 = int(((cj + 0.5) / 7 - w / 2) * size)
        y0 = int(((ci + 0.5) / 7 - h / 2) * size)
        calib[i, y0:y0 + int(h * size), x0:x0 + int(w * size), cls % 3] = 2.0
    return calib


def evaluate(tag, preds, targets, results_out):
    from yolo_tpu_torch.metrics import mAPMetric

    metric = mAPMetric(num_classes=NUM_CLASSES, conf_threshold=0.1, nms_threshold=0.4)
    metric.update(preds, targets)
    r = metric.compute()
    print(f"  {tag:<12} mAP50 {r['mAP50']:.4f}  mAP50:95 {r['mAP50:95']:.4f}"
          f"  precision {r['precision']:.4f}  recall {r['recall']:.4f}", flush=True)
    results_out[tag] = r
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="int8 engine accuracy gate on a trained model")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--chain", action="store_true",
                    help="also gate the engine with stages 1-3 as fused chain kernels")
    ap.add_argument("--wino", default="",
                    help="comma-list of convs to also gate as int8 Winograd convs, e.g. "
                         "'head_conv1,head_conv3,head_conv4'")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from yolo_tpu_torch.serving.cuda_bottleneck import chain_int8
    from yolo_tpu_torch.serving.engine import build_int8_predict, default_impl, int8_forward
    from yolo_tpu_torch.serving.winograd import check_points, wino_impl_hooks

    wino = tuple(n for n in args.wino.split(",") if n)
    if wino:
        try:
            check_points(wino)
        except ValueError as e:
            raise SystemExit(f"quant_accuracy: --wino: {e}") from None

    print("Training flagship on synthetic batch...", flush=True)
    model, images, targets, _, _ = train_on_batch(args, log_every=300)
    results = {}
    preds_fp = predict_grid(model, images)
    evaluate("fp32/bf16", preds_fp, targets, results)

    calib = [torch.from_numpy(calibration_batch(args.batch, args.size)).to(images.device)]
    with torch.inference_mode():
        _, q = build_int8_predict(model, calib)
        preds_i8 = int8_forward(q, images, S=model.S, impl=default_impl())
    evaluate("int8", preds_i8, targets, results)

    engines = []
    if args.chain:
        impl = {**default_impl(), **{f"layer{s}": chain_int8 for s in (1, 2, 3)}}
        with torch.inference_mode():
            engines.append(("int8-chain", int8_forward(q, images, S=model.S, impl=impl)))
    if wino:
        with torch.inference_mode():
            _, qw = build_int8_predict(model, calib, wino=wino)
            impl = wino_impl_hooks(wino, default_impl())
            engines.append(("int8-wino", int8_forward(qw, images, S=model.S, impl=impl)))
    for tag, preds in engines:
        evaluate(tag, preds, targets, results)
        print(f"  {tag}-vs-int8 raw-grid max |delta|: "
              f"{float((preds - preds_i8).abs().max()):.5f}")
    print(f"  int8-vs-fp32 raw-grid max |delta|: {float((preds_i8 - preds_fp).abs().max()):.5f}")

    fp = results["fp32/bf16"]["mAP50"]
    checks = [("fp32 model detects (mAP50 > 0.5)", fp > 0.5),
              ("int8 mAP50 within 1pt of fp32", abs(fp - results["int8"]["mAP50"]) <= 0.01)]
    for tag, _ in engines:
        checks.append((f"{tag} mAP50 within 1pt of fp32",
                       abs(fp - results[tag]["mAP50"]) <= 0.01))
    ok = True
    for name, passed in checks:
        print(f"  [{'PASS' if passed else 'FAIL'}] {name}")
        ok &= passed
    print("QUANT ACCURACY:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
