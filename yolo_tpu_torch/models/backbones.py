"""ResNet50 feature extractor in NCHW torch, without torchvision.

Port of yolo_tpu/models/backbones.py::ResNetBackbone. The layout is
torchvision's resnet50 minus avgpool/fc, as the reference wraps it
(src/yolo/models.py:131-176): ``extractor`` is a Sequential of stem conv
7x7/s2 (no bias), BN, ReLU, maxpool 3/2/1, then the bottleneck stages, so
parameters are named ``extractor.{0,1,4..7}...`` exactly as in a reference
``.pth``. Bottlenecks are v1.5 (stride on the 3x3 conv). Output is
(N, 2048, 14, 14) for a 448x448 input.

The 24-conv ``YOLOv1Backbone`` is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolo_tpu_torch.models.layers import batch_norm, conv


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3 (stride here) -> 1x1 x4, + shortcut."""

    def __init__(
        self, inplanes: int, planes: int, stride: int, downsample: bool,
        *, device: torch.device | str,
    ):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = batch_norm(planes, device=device)
        self.conv2 = conv(planes, planes, 3, stride, 1, bias=False, device=device)
        self.bn2 = batch_norm(planes, device=device)
        self.conv3 = conv(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = batch_norm(planes * 4, device=device)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(
                conv(inplanes, planes * 4, 1, stride, bias=False, device=device),
                batch_norm(planes * 4, device=device),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNetBackbone(nn.Module):
    """ResNet feature extractor; ``stage_sizes`` (3, 4, 6, 3) is ResNet50."""

    def __init__(
        self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
        *, device: torch.device | str,
    ):
        super().__init__()
        layers: list[nn.Module] = [
            conv(3, 64, 7, 2, 3, bias=False, device=device),
            batch_norm(64, device=device),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2, 1),  # pads with -inf, like the JAX max_pool
        ]
        inplanes = 64
        for stage, num_blocks in enumerate(stage_sizes):
            planes = 64 * 2**stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for block in range(num_blocks):
                blocks.append(Bottleneck(
                    inplanes, planes, stride if block == 0 else 1,
                    downsample=block == 0, device=device,
                ))
                inplanes = planes * 4
            layers.append(nn.Sequential(*blocks))
        self.extractor = nn.Sequential(*layers)
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.extractor(x)
