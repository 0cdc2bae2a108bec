"""Prediction CLI of the port: ``python -m yolo_tpu_torch.predict``.

The flags of the JAX package's predict.py (reference src/predict.py:188-293).
Single-image or directory prediction with annotated ``{stem}_pred{suffix}``
outputs and a console summary. ``--device`` defaults to ``cuda`` and fails
when CUDA is absent; ``--device cpu`` runs the plain torch path. The
checkpoint is a reference ``.pth`` or a JAX ``.ckpt``; the ResNet's depth and
input size are read from its weights. ``--int8`` serves with the int8 engine
(calibrated on the first chunk of real images), ``--engine`` loads a saved
engine artifact (the JAX package's or the port's), ``--save-engine`` freezes
the calibrated engine after serving.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Predict with YOLOv1 (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--freeze-backbone", action="store_true",
                   help="accepted for parity; unused at inference")
    p.add_argument("--image", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output", default="predictions")
    p.add_argument("--conf-threshold", type=float, default=0.5)
    p.add_argument("--nms-threshold", type=float, default=0.4)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--backbone", default="resnet", choices=["resnet", "yolov1"])
    p.add_argument("--int8", action="store_true",
                   help="serve with the int8-resident engine (resnet only)")
    p.add_argument("--engine", default=None,
                   help="load a saved int8 engine artifact (.npz from --save-engine or "
                        "the JAX package's serving.export) instead of calibrating; "
                        "implies --int8")
    p.add_argument("--save-engine", default=None,
                   help="after serving, freeze the calibrated int8 engine to this .npz "
                        "(deployment artifact; implies --int8)")
    p.add_argument("--force-save-engine", action="store_true",
                   help="allow --save-engine even when calibration saw fewer than 8 "
                        "images (e.g. a single --image run); the frozen activation "
                        "scales may clip on real data")
    args = p.parse_args(argv)
    if args.engine or args.save_engine:
        args.int8 = True
    if bool(args.image) == bool(args.image_dir):
        p.error("Provide exactly one of --image or --image-dir")
    return args


def load_engine(args):
    import torch

    from yolo_tpu_torch.convert import resnet_layout
    from yolo_tpu_torch.inference import YOLOInference
    from yolo_tpu_torch.models import create_model
    from yolo_tpu_torch.training.checkpoints import load_model

    if args.backbone != "resnet":
        raise SystemExit(f"backbone {args.backbone!r} is not yet ported")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    if not Path(args.checkpoint).exists():
        raise SystemExit(f"Checkpoint not found: {args.checkpoint}")
    state_dict = load_model(args.checkpoint)[0]
    stage_sizes, image_size = resnet_layout(state_dict)
    model = create_model(
        args.backbone, num_classes=args.num_classes, device=device,
        stage_sizes=stage_sizes, image_size=image_size,
    )
    model.load_state_dict(state_dict)
    return YOLOInference(model, device, image_size=image_size,
                         optimize="int8" if args.int8 else None, engine_artifact=args.engine)


def report_and_save(engine, image_path: Path, detections, out_dir: Path,
                    conf_threshold: float = 0.5):
    """Console listing + annotated ``{stem}_pred{suffix}`` output for one image."""
    from yolo_tpu_torch.data import VOC_CLASSES
    from yolo_tpu_torch.utils.visualization import draw_detections

    print(f"\n{image_path}: {len(detections)} objects")
    for det in detections:
        print(f"  {det.class_name}: {det.confidence:.2%} at {det.bbox}")
    image = engine.load_image(str(image_path))
    annotated = draw_detections(image, detections, VOC_CLASSES, conf_threshold)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{image_path.stem}_pred{image_path.suffix}"
    annotated.save(out_path)
    print(f"  saved -> {out_path}")
    return detections


def _save_engine_cli(engine, args):
    """--save-engine, with the calibration-count gate turned into CLI guidance."""
    try:
        engine.save_engine(args.save_engine, force=args.force_save_engine)
    except RuntimeError as exc:
        raise SystemExit(
            f"{exc}\nCLI guidance: run with --image-dir over >="
            f" {type(engine).MIN_CALIB_IMAGES} representative images so the engine"
            f" calibrates on a full chunk, or pass --force-save-engine to freeze anyway."
        )
    print(f"int8 engine artifact saved to {args.save_engine}")


def main(argv=None):
    from yolo_tpu_torch.data import VOC_CLASSES

    args = parse_args(argv)
    engine = load_engine(args)
    out_dir = Path(args.output)

    if args.image:
        dets = engine.predict(
            args.image, conf_threshold=args.conf_threshold,
            nms_threshold=args.nms_threshold, class_names=VOC_CLASSES,
        )
        report_and_save(engine, Path(args.image), dets, out_dir, args.conf_threshold)
        if args.save_engine:
            _save_engine_cli(engine, args)
        return

    image_dir = Path(args.image_dir)
    exts = {".jpg", ".jpeg", ".png", ".bmp"}
    paths = sorted(p for p in image_dir.iterdir() if p.suffix.lower() in exts)
    if not paths:
        print(f"No images found in {image_dir}")
        return
    all_dets = engine.predict_batch_files(
        [str(p) for p in paths],
        conf_threshold=args.conf_threshold,
        nms_threshold=args.nms_threshold,
        class_names=VOC_CLASSES,
    )
    total = 0
    for path, dets in zip(paths, all_dets):
        report_and_save(engine, path, dets, out_dir, args.conf_threshold)
        total += len(dets)
    if args.save_engine:
        _save_engine_cli(engine, args)
    print(
        f"\nProcessed {len(paths)} images, {total} detections "
        f"({total / len(paths):.1f} per image)"
    )


if __name__ == "__main__":
    main()
