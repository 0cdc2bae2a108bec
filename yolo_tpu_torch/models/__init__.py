"""Torch models, NCHW, with the reference's parameter names.

- ``ResNetBackbone`` (ResNet50 feature extractor, reference models.py:131-176)
- ``DetectionHead`` (conv + FC head, models.py:279-348)
- ``YOLOv1`` (combinator, models.py:179-276) and ``create_model``
"""

from yolo_tpu_torch.models.backbones import Bottleneck, ResNetBackbone
from yolo_tpu_torch.models.heads import DetectionHead
from yolo_tpu_torch.models.yolo import YOLOv1, create_model, head_feature_size

__all__ = [
    "Bottleneck",
    "DetectionHead",
    "ResNetBackbone",
    "YOLOv1",
    "create_model",
    "head_feature_size",
]
