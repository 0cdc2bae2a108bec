"""The YOLOv1 model: backbone + detection head, and its factory.

Port of yolo_tpu/models/yolo.py. The forward takes NCHW images and returns
the (N, S, S, B*5+C) grid. The head follows the backbone as in JAX's
dispatch (yolo.py:39-69; reference src/yolo/models.py:179-276):

- no backbone given        -> ``YOLOv1Backbone`` + ``SimpleHead``
- ``YOLOv1Backbone``       -> ``SimpleHead`` (Flatten -> 4096 -> out)
- ``ResNetBackbone``       -> ``DetectionHead`` (2048 in)
- ``SwinBackbone``         -> ``DetectionHead`` (its ``out_channels``, 1024
  for Swin-B), fc1 from ``head_feature_size(image_size, 4)``
- custom backbone, no head -> ``ValueError``

A 2-D head output is reshaped to the grid. Parameter names are the
reference's (``backbone.extractor.*`` / ``backbone.features.*``,
``head.conv_layers.*`` / ``head.fc_layers.*`` or ``head.{1,4}.*``), so a
reference ``.pth`` state dict loads as it is.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from yolo_tpu_torch.models.backbones import (SWIN_B, ResNetBackbone, SwinBackbone,
                                             YOLOv1Backbone, fused_mode, remat_mode,
                                             yolov1_feature_size)
from yolo_tpu_torch.models.heads import DetectionHead, SimpleHead
from yolo_tpu_torch.models.layers import init_weights_


class YOLOv1(nn.Module):
    """YOLOv1 detector: ``backbone`` features -> ``head`` grid.

    The submodules are built with their parameters uninitialised
    (``create_model`` initialises them). ``image_size`` fixes the width of
    the default head's fc1; ``quantized`` builds the default backbone's and
    the ResNet head's convs as dynamic-int8 ``Int8Conv2d``s.
    """

    def __init__(self, num_classes: int = 20, S: int = 7, B: int = 2,
                 backbone: Optional[nn.Module] = None, head: Optional[nn.Module] = None,
                 *, device: torch.device | str, image_size: int = 448,
                 quantized: bool = False):
        super().__init__()
        if backbone is None:
            backbone = YOLOv1Backbone(device=device, quantized=quantized)
        if head is None:
            if isinstance(backbone, YOLOv1Backbone):
                head = SimpleHead(num_classes, S, B, yolov1_feature_size(image_size),
                                  backbone.out_channels, device=device)
            elif isinstance(backbone, (ResNetBackbone, SwinBackbone)):
                if quantized and isinstance(backbone, SwinBackbone):
                    raise ValueError("the swin backbone has no int8 path (quantized=True)")
                head = DetectionHead(backbone.out_channels, num_classes, S, B,
                                     head_feature_size(image_size, backbone.num_stages),
                                     device=device, quantized=quantized)
            else:
                raise ValueError("Must provide detection_head for custom backbone types")
        self.backbone = backbone
        self.head = head
        self.num_classes, self.S, self.B = num_classes, S, B

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.head(self.backbone(x))
        if out.dim() == 2:
            out = out.reshape(-1, self.S, self.S, self.B * 5 + self.num_classes)
        return out


def head_feature_size(image_size: int, num_stages: int) -> int:
    """Side of the ResNet head's map after its stride-2 conv.

    Every stride-2 layer maps h -> (h - 1) // 2 + 1: the stem conv, the
    max pool, the first block of each stage after the first, and the head's
    second conv. 448 -> 7; 64 -> 1. The same holds for Swin's padded patch
    embedding (ceil(h / 4)) and its three merges (ceil(h / 2)).
    """
    h = image_size
    for _ in range(2 + (num_stages - 1) + 1):
        h = (h - 1) // 2 + 1
    return h


def create_model(
    backbone: str = "resnet",
    num_classes: int = 20,
    S: int = 7,
    B: int = 2,
    *,
    device: torch.device | str,
    generator: torch.Generator | None = None,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    image_size: int = 448,
    fused_bn: bool | str = False,
    remat: bool | str = False,
    quantized: bool = False,
) -> YOLOv1:
    """Build a YOLOv1 on ``device`` with PyTorch's default init, in eval mode.

    ``backbone``: "resnet" (the flagship), "yolov1" (the 24-conv stack
    and ``SimpleHead``) or "swin_b" (the published Swin-B, ``SWIN_B``, and
    ``DetectionHead(1024)``; bf16 training and float32 inference only, so
    ``quantized``, ``fused_bn`` and ``remat`` raise ``ValueError``).
    ``generator`` (on ``device``) draws the weights; None means a generator
    seeded with 0. ``image_size`` fixes the head's
    fc1 width. ResNet only: ``stage_sizes`` cuts its depth (tests use
    (1, 1, 1, 1)); ``fused_bn`` (False, True/"stats" or "full") selects the
    train-mode BN path; ``remat`` (False/"none", True/"block", "stage")
    recomputes activations in the backward pass, as JAX's train.py builds
    it for the ResNet only. ``quantized=True`` is the dynamic-int8
    inference variant: every conv runs the int8 conv kernel (the FC layers
    stay float), the parameters are the float model's.
    ``model.train()`` / ``model.eval()`` stand for JAX's ``train=``.
    """
    if backbone == "resnet":
        bb: nn.Module = ResNetBackbone(stage_sizes, device=device, fused_bn=fused_bn,
                                       quantized=quantized, remat=remat)
    elif backbone in ("yolov1", "swin_b"):
        if remat_mode(remat) != "none" or fused_mode(fused_bn) is not None:
            raise ValueError("remat and fused_bn apply to the resnet backbone only")
        bb = (YOLOv1Backbone(device=device, quantized=quantized) if backbone == "yolov1"
              else SwinBackbone(**SWIN_B, device=device))
    else:
        raise ValueError(f"Unknown backbone '{backbone}'")
    model = YOLOv1(num_classes, S, B, bb, device=device, image_size=image_size,
                   quantized=quantized)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_weights_(model, generator)
    return model.eval()
