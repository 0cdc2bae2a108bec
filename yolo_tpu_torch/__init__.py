"""yolo_tpu_torch — the YOLOv1 framework ported to PyTorch and CUDA (Hopper).

A second package beside the JAX one (``yolo_tpu``), with the same module
names. It imports torch and never jax. So far it covers the models (the
ResNet50 and 24-conv YOLOv1, remat, the dynamic-int8 variant on
``csrc/int8_conv.cu``), exact inference (``ops.decode``, NMS through the
hand-written CUDA kernel ``csrc/nms.cu``), its training (``training``,
``data``, the fused-BN kernels ``csrc/fused_bn.cu``) and its int8 serving
engine (``serving``, the kernels ``csrc/quant_s2d.cu``,
``csrc/int8_conv.cu``, the opt-in ``csrc/int8_bottleneck.cu`` and
``csrc/int8_wino.cu``), its mAP evaluator (``metrics``) and data and
tensor parallelism over a ("data", "model") mesh (``parallel``), driven by
``inference.YOLOInference`` and the ``predict``, ``train`` and ``evaluate``
CLIs.

Importing the package loads nothing else: the names below resolve on first
use, so PIL, pydantic and the kernel build stay out until needed.
"""

from importlib import import_module

from yolo_tpu_torch.version import __version__

_LAZY = {
    "Backbone": "yolo_tpu_torch.models",
    "BoundingBox": "yolo_tpu_torch.schemas",
    "CombinedVOCDataset": "yolo_tpu_torch.data",
    "Detection": "yolo_tpu_torch.schemas",
    "DetectionHead": "yolo_tpu_torch.models",
    "ResNetBackbone": "yolo_tpu_torch.models",
    "VOCDetectionYOLO": "yolo_tpu_torch.data",
    "VOC_CLASSES": "yolo_tpu_torch.data",
    "YOLOInference": "yolo_tpu_torch.inference",
    "YOLOLoss": "yolo_tpu_torch.ops.loss",
    "YOLOv1": "yolo_tpu_torch.models",
    "YOLOv1Backbone": "yolo_tpu_torch.models",
    "create_model": "yolo_tpu_torch.models",
    "create_voc_datasets": "yolo_tpu_torch.data",
    "evaluate_model": "yolo_tpu_torch.metrics",
    "mAPMetric": "yolo_tpu_torch.metrics",
    "yolo_loss": "yolo_tpu_torch.ops.loss",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'yolo_tpu_torch' has no attribute {name!r}")


__all__ = [*sorted(_LAZY), "__version__"]
