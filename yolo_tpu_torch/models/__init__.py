"""Torch models, NCHW, with the reference's parameter names.

- ``Backbone`` (abstract, reference models.py:6-30)
- ``YOLOv1Backbone`` (24-conv paper stack, models.py:33-128) and
  ``SimpleHead`` (its FC head, models.py:239-245)
- ``ResNetBackbone`` (ResNet50 feature extractor, models.py:131-176)
- ``SwinBackbone`` (Swin Transformer, arXiv:2103.14030, as the official
  detection backbone; ``create_model("swin_b")``) and ``WindowAttention``
- ``DetectionHead`` (conv + FC head, models.py:279-348)
- ``YOLOv1`` (combinator with backbone dispatch, models.py:179-276) and
  ``create_model``
"""

from yolo_tpu_torch.models.backbones import (Backbone, Bottleneck, ResNetBackbone,
                                             SwinBackbone, YOLOv1Backbone)
from yolo_tpu_torch.models.heads import DetectionHead, SimpleHead
from yolo_tpu_torch.models.layers import WindowAttention
from yolo_tpu_torch.models.yolo import YOLOv1, create_model, head_feature_size

__all__ = [
    "Backbone",
    "Bottleneck",
    "DetectionHead",
    "ResNetBackbone",
    "SimpleHead",
    "SwinBackbone",
    "WindowAttention",
    "YOLOv1",
    "YOLOv1Backbone",
    "create_model",
    "head_feature_size",
]
