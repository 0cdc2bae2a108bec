"""Serving CLI of the port: ``python -m yolo_tpu_torch.serve``.

An HTTP detection endpoint over the int8 engine (serving/server.py), with
the flags of the JAX package's serve.py and ``--device``. Requests coalesce
through the RequestBatcher into fixed-bucket batches; on the card each
bucket replays one CUDA graph of the engine (serving/graphs.py), captured
before the server takes traffic.

Three ways to provide the engine, in decreasing build cost:
  --checkpoint CKPT [--calib-dir DIR]   fold + calibrate + quantize live
  --engine ART.npz                      frozen q-params (predict --save-engine,
                                        or the JAX package's artifact)
  --compiled AOT.pt2                    the whole served graph
                                        (--save-compiled, torch.export)

``--save-compiled PATH`` also freezes a live or ``--engine`` build to an AOT
artifact, at the largest bucket on the serving device. An AOT artifact
serves one bucket, its batch size, with the thresholds it baked in, on the
device type it was exported for (the JAX package's holds TPU and CPU
modules in one file; the port's one device type). The JAX package's
StableHLO artifact is refused: torch cannot run it.

``--device`` defaults to ``cuda`` and exits when CUDA is absent; ``--device
cpu`` serves the engine eagerly (its kernels' plain twins) and says so.

Example:
  python -m yolo_tpu_torch.serve --engine yolo_int8.npz --port 8000
  python -m yolo_tpu_torch.serve --engine yolo_int8.npz --buckets 16 \
      --save-compiled yolo_int8.pt2
  python -m yolo_tpu_torch.serve --compiled yolo_int8.pt2 --port 8000
  curl -s -X POST --data-binary @dog.jpg localhost:8000/predict
"""

from __future__ import annotations

import argparse
import threading
from pathlib import Path

# Threshold defaults (the reference predict.py's). The flags default to None,
# so that --compiled can tell an explicit flag from the default; the live
# engine and --save-compiled resolve None through these.
DEFAULT_CONF = 0.5
DEFAULT_NMS = 0.4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve YOLOv1 over HTTP (PyTorch/CUDA)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", default=None)
    src.add_argument("--engine", default=None,
                     help="frozen int8 engine artifact (.npz)")
    src.add_argument("--compiled", default=None,
                     help="AOT engine artifact (.pt2); thresholds and batch size are "
                          "baked into the artifact")
    p.add_argument("--calib-dir", default=None,
                   help="directory of images for int8 activation calibration "
                        "(with --checkpoint; defaults to random noise with a "
                        "warning)")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--backbone", default="resnet", choices=["resnet"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--conf-threshold", type=float, default=None,
                   help=f"default {DEFAULT_CONF}")
    p.add_argument("--nms-threshold", type=float, default=None,
                   help=f"default {DEFAULT_NMS}")
    p.add_argument("--buckets", default="1,4,16",
                   help="comma-separated batch buckets (one CUDA graph each)")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="max wait for batch co-riders (latency knob)")
    p.add_argument("--save-compiled", default=None,
                   help="also freeze the built engine to an AOT artifact at this "
                        "path (batch = largest bucket)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def _serving(predict, device):
    """``predict`` as served: one CUDA graph a bucket on CUDA, eager on the CPU."""
    if device.type == "cuda":
        from yolo_tpu_torch.serving.graphs import GraphedPredict

        return GraphedPredict(predict, device)
    return predict


def _load_compiled(args, device):
    """(predict, (batch_size,), image_size) of an AOT artifact (--compiled)."""
    from yolo_tpu_torch.serving.export import load_compiled_engine

    if args.save_compiled:
        raise SystemExit("--save-compiled needs a live or frozen engine build (not --compiled)")
    try:
        predict, meta = load_compiled_engine(args.compiled, device)
    except ValueError as exc:
        raise SystemExit(str(exc))
    for key in ("conf_threshold", "nms_threshold"):
        # Only an explicit flag (None is the default) that differs is noted.
        if getattr(args, key) is not None and abs(getattr(args, key) - meta[key]) > 1e-9:
            print(f"note: --{key.replace('_', '-')} ignored — the AOT artifact bakes "
                  f"{key}={meta[key]}", flush=True)
    if meta["dtype"] != "uint8":
        raise SystemExit("serve requires a uint8-wire AOT artifact")
    # One recorded program = one batch size: serve with that single bucket.
    return _serving(predict, device), (meta["batch_size"],), meta["image_size"]


def build_predict(args):
    """(predict(images) -> Detections, buckets, image_size).

    On CUDA ``predict`` is a ``GraphedPredict`` (nothing captured yet); on
    the CPU, the engine closed over its q-params and thresholds (or the AOT
    artifact's program). With ``--save-compiled`` the built engine is also
    written as an AOT artifact first.
    """
    import torch

    from yolo_tpu_torch.serving.engine import (build_int8_predict, load_artifact,
                                               make_int8_engine_fn)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    if args.compiled:
        return _load_compiled(args, device)

    if args.engine:
        q, impl, meta = load_artifact(args.engine, None, device)
        geom = (meta["S"], meta["B"], meta["num_classes"])
        fn = make_int8_engine_fn(*geom, impl=impl)
    else:
        from yolo_tpu_torch.models import create_model
        from yolo_tpu_torch.training.checkpoints import load_model

        if not Path(args.checkpoint).exists():
            raise SystemExit(f"Checkpoint not found: {args.checkpoint}")
        try:
            state_dict, layout, _ = load_model(args.checkpoint, args.backbone)
        except ValueError as exc:
            raise SystemExit(str(exc))
        model = create_model(args.backbone, num_classes=args.num_classes, device=device,
                             stage_sizes=layout["stage_sizes"], image_size=args.image_size)
        model.load_state_dict(state_dict)
        geom = (model.S, model.B, model.num_classes)
        calib = [torch.from_numpy(b).to(device) for b in _calibration_batches(args)]
        fn, q = build_int8_predict(model, calib)

    conf = DEFAULT_CONF if args.conf_threshold is None else float(args.conf_threshold)
    nms = DEFAULT_NMS if args.nms_threshold is None else float(args.nms_threshold)
    if args.save_compiled:
        from yolo_tpu_torch.serving.export import save_compiled_engine

        try:
            save_compiled_engine(args.save_compiled, q, *geom, batch_size=max(buckets),
                                 image_size=args.image_size, conf_threshold=conf,
                                 nms_threshold=nms)
        except ValueError as exc:
            raise SystemExit(str(exc))
        print(f"AOT engine artifact saved to {args.save_compiled}", flush=True)

    def predict(images):
        return fn(q, images, conf, nms)

    return _serving(predict, device), buckets, args.image_size


def _calibration_batches(args):
    import numpy as np

    size = args.image_size
    if args.calib_dir:
        from yolo_tpu_torch.data.transforms import eval_transform, load_image_rgb

        paths = sorted(Path(args.calib_dir).iterdir())[:32]
        images = [
            eval_transform(load_image_rgb(str(p)), (size, size))
            for p in paths if p.suffix.lower() in
            {".jpg", ".jpeg", ".png", ".bmp"}
        ]
        if images:
            return [np.stack(images[i:i + 8])
                    for i in range(0, len(images), 8)]
    print("warning: calibrating int8 activation scales on random noise — "
          "pass --calib-dir with representative images for deployment", flush=True)
    rng = np.random.default_rng(0)
    return [rng.standard_normal((8, size, size, 3)).astype(np.float32)
            for _ in range(2)]


def main(argv=None):
    args = parse_args(argv)
    eager = args.device.split(":")[0] == "cpu"
    if eager:
        print(f"--device {args.device}: serving the engine eagerly (no CUDA graphs)",
              flush=True)

    predict, buckets, image_size = build_predict(args)

    from yolo_tpu_torch.serving import YOLOServer

    with YOLOServer(
        predict, image_size,
        host=args.host, port=args.port,
        buckets=buckets, max_delay_ms=args.max_delay_ms,
    ) as server:
        print(f"{'warming up' if eager else 'capturing'} {len(buckets)} bucket(s) "
              f"{buckets} ...", flush=True)
        server.warmup()
        print(f"serving on http://{server.host}:{server.port} "
              f"(POST /predict, GET /healthz); Ctrl-C to stop", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            print("\nshutting down", flush=True)


if __name__ == "__main__":
    main()
