"""Evaluation CLI of the port: ``python -m yolo_tpu_torch.evaluate``.

The flags of the repository's ``evaluate.py`` (reference src/evaluate.py).
Runs the evaluator (``metrics/map.py``: forward, decode, NMS and greedy
matching a batch at a time), prints the overall, size-based and per-class
tables and writes ``evaluation_results.txt`` beside the checkpoint.

- ``--checkpoint``: a ``.pth`` (the port's or the reference's) or a JAX
  ``.ckpt`` of the ``--backbone`` model (resnet or yolov1); the ResNet's
  depth and the input size are read from its weights, and the images are
  resized to that size.
- ``--device`` defaults to ``cuda`` and fails without a card; ``--device
  cpu`` runs on the CPU.
- The default is the precise path (decode, NMS and matching in float64 on
  the device); ``--fast-eval`` runs them in float32. On CUDA, NMS is the
  kernel ``csrc/nms.cu`` on both paths.
- ``--use-bf16``: bf16 autocast around the forward.
- ``--int8``: fold, calibrate on the first two batches of ``--calib-data``
  (required: the eval split never sets the deployed scales) and quantize,
  then evaluate the int8 serving engine. ``--engine X.npz``: evaluate a
  saved engine artifact as it is (no calibration; the checkpoint still
  gives the geometry). Both for the ResNet only, as in JAX.

- ``--mesh-data`` / ``--mesh-model``: under ``torchrun`` (one process a
  device) each data rank evaluates its rows of every batch and the results
  are gathered, so every rank holds the same keys; ``--mesh-model`` alone
  implies ``--mesh-data 1``, as in JAX, and cuts the FC head. ``--int8``
  keeps the stem-front kernel under a mesh. Only the first rank prints and
  writes the results.

Refused with a message: ``--download-data`` needs a network.
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate YOLOv1 (PyTorch/CUDA port)")
    p.add_argument("--checkpoint", required=True, help=".pth or JAX .ckpt")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--freeze-backbone", action="store_true",
                   help="accepted for parity; unused at eval time")
    p.add_argument("--year", default="2007")
    p.add_argument("--image-set", default="test")
    p.add_argument("--datasets", default=None,
                   help="combined spec, e.g. '2007:trainval,2012:train'")
    p.add_argument("--data-root", default="./data")
    p.add_argument("--download-data", action="store_true", help="needs a network; refused")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--conf-threshold", type=float, default=0.01)
    p.add_argument("--nms-threshold", type=float, default=0.4)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--backbone", default="resnet", choices=["resnet", "yolov1"])
    p.add_argument("--use-bf16", action="store_true", help="bf16 autocast for the forward")
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 serving engine (resnet only), calibrated on "
                        "--calib-data")
    p.add_argument("--engine", default=None,
                   help="evaluate a saved int8 engine artifact (.npz from predict "
                        "--save-engine or serving.save_engine) as it is: no fold, no "
                        "calibration (the checkpoint still gives the geometry)")
    p.add_argument("--calib-data", default=None,
                   help="dataset spec for the int8 activation calibration, e.g. "
                        "'2007:trainval' (same --data-root); required with --int8")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis size (ranks from torchrun)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis size for the FC head")
    p.add_argument("--fast-eval", action="store_true",
                   help="run decode/NMS/matching in float32. Default: the precise path, "
                        "float64 (both on the device)")
    return p.parse_args(argv)


def _refuse(args) -> None:
    if (args.int8 or args.engine) and args.backbone != "resnet":
        raise SystemExit("--int8 supports the resnet flagship only")
    if args.download_data:
        raise SystemExit("--download-data needs a network; put the VOC tree under --data-root")
    if args.int8 and not args.engine and not args.calib_data:
        raise SystemExit("--int8 needs --calib-data (e.g. --calib-data 2007:trainval): the "
                         "activation scales are not fit on the split being evaluated")


def format_results(results: dict, num_classes: int, class_names) -> str:
    lines = []
    lines.append("=" * 60)
    lines.append("Overall metrics")
    lines.append("=" * 60)
    for key in ("mAP50:95", "mAP50", "mAP75", "precision", "recall"):
        lines.append(f"  {key:12s}: {results[key] * 100:.2f}%")
    lines.append("")
    lines.append("Size-based metrics")
    lines.append("-" * 60)
    for size in ("large", "medium", "small"):
        lines.append(
            f"  {size:7s}: mAP50:95 {results[f'mAP50:95_{size}'] * 100:6.2f}% | "
            f"mAP50 {results[f'mAP50_{size}'] * 100:6.2f}% | "
            f"objects {results[f'num_{size}_objects']}"
        )
    lines.append("")
    lines.append("Per-class AP (sorted by AP50:95)")
    lines.append("-" * 60)
    per_class = sorted(
        range(num_classes),
        key=lambda c: -results.get(f"AP50:95_class_{c}", 0.0),
    )
    lines.append(f"  {'class':14s} {'AP50':>8s} {'AP75':>8s} {'AP50:95':>8s}")
    for c in per_class:
        name = class_names[c] if c < len(class_names) else f"class_{c}"
        lines.append(
            f"  {name:14s} "
            f"{results.get(f'AP50_class_{c}', 0.0) * 100:7.2f}% "
            f"{results.get(f'AP75_class_{c}', 0.0) * 100:7.2f}% "
            f"{results.get(f'AP50:95_class_{c}', 0.0) * 100:7.2f}%"
        )
    return "\n".join(lines)


def _datasets(spec, args, size):
    from yolo_tpu_torch.data import DataLoader, create_voc_datasets

    pairs = [tuple(item.split(":")) for item in spec.split(",")]
    dataset = create_voc_datasets(pairs, root=args.data_root, target_size=(size, size),
                                  augment=False, normalize_host=False)
    return dataset, DataLoader(dataset, batch_size=args.batch_size, shuffle=False,
                               num_workers=args.num_workers, drop_last=False)


def main(argv=None):
    args = parse_args(argv)
    _refuse(args)
    if args.mesh_model > 1 and not args.mesh_data:
        args.mesh_data = 1  # --mesh-model alone: a (1, n_model) mesh, as in JAX

    import torch

    from yolo_tpu_torch.parallel.distributed import run_on_mesh

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available (pass --device cpu)")

    return run_on_mesh(functools.partial(_evaluate, args), args.device, args.mesh_data,
                       args.mesh_model, args.batch_size)


def _evaluate(args, mesh, device, first: bool):
    import torch

    from yolo_tpu_torch.data import VOC_CLASSES
    from yolo_tpu_torch.metrics import evaluate_model
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.training.checkpoints import load_model

    ckpt_path = Path(args.checkpoint)
    if not ckpt_path.exists():
        raise SystemExit(f"Checkpoint not found: {ckpt_path}")
    try:
        state_dict, layout, meta = load_model(ckpt_path, args.backbone)
    except ValueError as exc:
        raise SystemExit(str(exc))
    image_size = layout["image_size"]
    model = create_model(num_classes=args.num_classes, device=device, **layout)
    model.load_state_dict(state_dict)
    del state_dict
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    print(f"Loaded checkpoint {ckpt_path}")
    for key, value in meta.items():
        print(f"  {key}: {value}")

    spec = args.datasets or f"{args.year}:{args.image_set}"
    dataset, loader = _datasets(spec, args, image_size)
    print(f"Evaluation dataset: {len(dataset)} images")

    forward_fn = None
    if args.engine or args.int8:
        from yolo_tpu_torch.serving.engine import (build_int8_predict, default_impl,
                                                   int8_forward, load_artifact)

        if args.engine:
            try:
                q, impl, _ = load_artifact(args.engine, model, device)
            except ValueError as exc:
                raise SystemExit(str(exc))
            print(f"int8 engine artifact: {args.engine}")
        else:
            from yolo_tpu_torch.data.transforms import device_normalize

            _, calib_loader = _datasets(args.calib_data, args, image_size)
            calib = []
            try:
                for images, _ in calib_loader:
                    calib.append(device_normalize(torch.from_numpy(images).to(device)))
                    if len(calib) >= 2:
                        break
            finally:
                calib_loader.close()
            impl = default_impl()
            _, q = build_int8_predict(model, calib, impl=impl)
            print(f"int8 serving engine: calibrated on {sum(c.shape[0] for c in calib)} "
                  f"images of --calib-data {args.calib_data}")

        def forward_fn(images):
            return int8_forward(q, images, S=model.S, impl=impl)

    if mesh is not None:
        from yolo_tpu_torch.parallel import shard_head

        shard_head(model, mesh)  # after the int8 fold, which reads the whole fc1
        print(f"Evaluation mesh: {mesh}")

    if not args.fast_eval:
        print("Precise eval path active (float64 decode/NMS/matching on the device); pass"
              " --fast-eval for the float32 path.")
    try:
        results = evaluate_model(
            model, loader, num_classes=args.num_classes, conf_threshold=args.conf_threshold,
            nms_threshold=args.nms_threshold, S=model.S, B=model.B, device=device,
            forward_fn=forward_fn, precise=not args.fast_eval, use_amp=args.use_bf16,
            mesh=mesh)
    finally:
        loader.close()

    report = format_results(results, args.num_classes, VOC_CLASSES)
    print("\n" + report)
    if first:
        out_path = ckpt_path.parent / "evaluation_results.txt"
        out_path.write_text(report + "\n")
        print(f"\nResults written to {out_path}")
    return results


if __name__ == "__main__":
    main()
