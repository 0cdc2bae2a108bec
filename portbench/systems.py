"""The system under test, built through ``yolo_tpu_torch``'s public entry
points from a cell's parameters. This is the only file of the harness that
builds the program; the drivers time what it returns.

Serving (``params["engine"]``):

- ``"int8"``: the int8 engine: a ResNet ``create_model`` with the seeded
  weights, ``serving.engine.build_int8_predict`` (fold, bf16 calibration on
  the seeded calibration images, quantize, the kernels' packed weights) with
  ``default_impl()``, closed over the cell's thresholds;
- ``"model"``: ``inference.YOLOInference(create_model(...,
  quantized=params["quantized"])).batch_fn`` closed over the thresholds;

each replayed from one CUDA graph per batch shape
(``serving.graphs.GraphedPredict``). On the CPU (tests) the callable runs
eagerly on the kernels' plain twins.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from portbench import traffic, weights


def seeded_weights(run):
    cfg = run.model_config()
    return weights.make(run.reference().param_spec(cfg), run.seed_for("weights"), run.device)


def calibration_images(run) -> List[torch.Tensor]:
    """The seeded uint8 calibration batches, on the run's device."""
    p, cfg = run.params, run.model_config()
    n, per = p.get("calibration_batches", 0), p.get("calibration_batch", 8)
    if n == 0:
        return []
    images = traffic.uint8_images(run.seed_for("calibration"), n * per, cfg["image_size"],
                                  run.device)
    return list(images.split(per))


def build_model(run, quantized: bool = False, fused_bn=False):
    from yolo_tpu_torch.models import create_model

    cfg = run.model_config()
    kwargs = dict(num_classes=cfg["num_classes"], S=cfg["S"], B=cfg["B"], device=run.device,
                  image_size=cfg["image_size"], quantized=quantized)
    if cfg["backbone"] == "resnet":
        kwargs.update(stage_sizes=tuple(cfg["stage_sizes"]), fused_bn=fused_bn)
    model = create_model(cfg["backbone"], **kwargs)
    model.load_state_dict(seeded_weights(run), strict=True)
    return model


def serving_predict(run) -> Callable:
    """``(images (n, H, W, 3) uint8 on the device) -> Detections``, thresholds bound."""
    p = run.params
    conf, iou = float(p["conf_threshold"]), float(p["nms_threshold"])
    if p["engine"] == "int8":
        from yolo_tpu_torch.data.transforms import device_normalize
        from yolo_tpu_torch.serving.engine import build_int8_predict, default_impl

        net = build_model(run)
        calib = [device_normalize(b) for b in calibration_images(run)]
        fn, q = build_int8_predict(net, calib, impl=default_impl())
        del net, calib

        def predict(images):
            return fn(q, images, conf, iou)
    elif p["engine"] == "model":
        from yolo_tpu_torch.inference import YOLOInference

        net = build_model(run, quantized=bool(p["quantized"]))
        predict = YOLOInference(net, run.device, image_size=run.model_config()["image_size"]
                                ).batch_fn(conf, iou)
    else:
        raise ValueError(f"unknown serving engine {p['engine']!r}")
    wrap = run.hooks.get("wrap_predict")
    return wrap(predict) if wrap is not None else predict


def served(run) -> Callable:
    """The served callable: the program's predict replayed from one CUDA graph
    per batch shape on the card; on the CPU, eager, with the host batch moved
    to the device. The hook ``served`` (the control) takes the program's place."""
    if "served" in run.hooks:
        return run.hooks["served"]
    predict = serving_predict(run)
    if run.device.type == "cuda":
        from yolo_tpu_torch.serving.graphs import GraphedPredict

        return GraphedPredict(predict, run.device)
    return lambda images: predict(torch.as_tensor(images).to(run.device))


def free_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
