"""Detection head producing the (N, S, S, B*5+C) YOLO grid.

Port of yolo_tpu/models/heads.py::DetectionHead with the reference's module
names (src/yolo/models.py:313-332): ``conv_layers.{0,2,4,6}`` are four 3x3
convs to 1024 channels (the second with stride 2, 14x14 -> 7x7), each
followed by LeakyReLU(0.1); ``fc_layers`` is Flatten -> Linear(4096) ->
LeakyReLU -> Dropout(0.5) -> Linear(S*S*(B*5+C)). The dropout is the port's
generator-driven :class:`~yolo_tpu_torch.models.layers.Dropout`. Flatten takes the logical
(C, H, W) order, as the reference does; on a channels_last tensor it copies.

``SimpleHead`` (the 24-conv backbone's head) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_tpu_torch.models.layers import Dropout, conv, leaky_relu, linear


class DetectionHead(nn.Module):
    """Conv tower (in -> 1024, one stride-2) + FC stack, reshaped to the grid.

    ``feature_size`` is the side of the map after the stride-2 conv: 7 for
    448x448 images.
    """

    def __init__(
        self, in_channels: int = 2048, num_classes: int = 20, S: int = 7,
        B: int = 2, feature_size: int = 7, *, device: torch.device | str,
    ):
        super().__init__()
        self.S, self.B, self.num_classes = S, B, num_classes
        self.conv_layers = nn.Sequential(
            conv(in_channels, 1024, 3, 1, 1, device=device), leaky_relu(),
            conv(1024, 1024, 3, 2, 1, device=device), leaky_relu(),
            conv(1024, 1024, 3, 1, 1, device=device), leaky_relu(),
            conv(1024, 1024, 3, 1, 1, device=device), leaky_relu(),
        )
        self.fc_layers = nn.Sequential(
            nn.Flatten(),
            linear(1024 * feature_size * feature_size, 4096, device=device),
            leaky_relu(),
            Dropout(0.5),
            linear(4096, S * S * (B * 5 + num_classes), device=device),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc_layers(self.conv_layers(x))
        return x.reshape(-1, self.S, self.S, self.B * 5 + self.num_classes)
