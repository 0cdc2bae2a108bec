"""The YOLOv1 model: backbone + detection head, and its factory.

Port of yolo_tpu/models/yolo.py for the ResNet50 configuration. The forward
takes NCHW images and returns the (N, S, S, B*5+C) grid. Parameter names are
the reference's (``backbone.extractor.*``, ``head.conv_layers.*``,
``head.fc_layers.*``), so a reference ``.pth`` state dict loads as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolo_tpu_torch.models.backbones import ResNetBackbone
from yolo_tpu_torch.models.heads import DetectionHead
from yolo_tpu_torch.models.layers import init_weights_


class YOLOv1(nn.Module):
    """YOLOv1 detector: ``backbone`` features -> ``head`` grid."""

    def __init__(self, backbone: nn.Module, head: DetectionHead):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.num_classes, self.S, self.B = head.num_classes, head.S, head.B

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x))


def head_feature_size(image_size: int, num_stages: int) -> int:
    """Side of the head's map after its stride-2 conv.

    Every stride-2 layer maps h -> (h - 1) // 2 + 1: the stem conv, the
    max pool, the first block of each stage after the first, and the head's
    second conv. 448 -> 7; 64 -> 1.
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
) -> YOLOv1:
    """Build a YOLOv1 on ``device`` with PyTorch's default init, in eval mode.

    ``generator`` (on ``device``) draws the weights; None means a generator
    seeded with 0. ``stage_sizes`` cuts the ResNet's depth (tests use
    (1, 1, 1, 1)); ``image_size`` fixes the head's fc1 width; ``fused_bn``
    (False, True/"stats" or "full") selects the backbone's train-mode BN
    path. ``model.train()`` / ``model.eval()`` stand for JAX's ``train=``.
    """
    if backbone != "resnet":
        raise NotImplementedError(
            f"backbone {backbone!r} is not ported yet; only 'resnet' is"
        )
    bb = ResNetBackbone(stage_sizes, device=device, fused_bn=fused_bn)
    head = DetectionHead(
        bb.out_channels, num_classes, S, B,
        feature_size=head_feature_size(image_size, len(stage_sizes)),
        device=device,
    )
    model = YOLOv1(bb, head)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_weights_(model, generator)
    return model.eval()
