"""yolo_tpu_torch — the YOLOv1 framework ported to PyTorch and CUDA (Hopper).

A second package beside the JAX one (``yolo_tpu``), with the same module
names. It imports torch and never jax. So far it covers the ResNet50
model's exact inference (``models``, ``ops.decode``, NMS through the
hand-written CUDA kernel ``csrc/nms.cu``), its training (``training``,
``data``, the fused-BN kernels ``csrc/fused_bn.cu``) and its int8 serving
engine (``serving``, the kernels ``csrc/quant_s2d.cu``,
``csrc/int8_conv.cu``, the opt-in ``csrc/int8_bottleneck.cu`` and
``csrc/int8_wino.cu``), driven by ``inference.YOLOInference`` and the
``predict`` and ``train`` CLIs.

Importing the package loads nothing else: the names below resolve on first
use, so PIL, pydantic and the kernel build stay out until needed.
"""

from importlib import import_module

from yolo_tpu_torch.version import __version__

_LAZY = {
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
    "create_model": "yolo_tpu_torch.models",
    "create_voc_datasets": "yolo_tpu_torch.data",
    "yolo_loss": "yolo_tpu_torch.ops.loss",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'yolo_tpu_torch' has no attribute {name!r}")


__all__ = [*sorted(_LAZY), "__version__"]
