"""Detection heads producing the YOLO grid.

Port of yolo_tpu/models/heads.py with the reference's module names:

- ``SimpleHead`` (JAX :22-38; reference src/yolo/models.py:239-245), the
  24-conv backbone's head, is itself the Sequential Flatten -> Linear(4096)
  -> LeakyReLU -> Dropout(0.5) -> Linear(S*S*(B*5+C)), so its parameters
  are ``head.1.*`` and ``head.4.*``. It returns (N, S*S*(B*5+C)); the model
  reshapes that to the grid.
- ``DetectionHead`` (src/yolo/models.py:313-332): ``conv_layers.{0,2,4,6}``
  are four 3x3 convs to 1024 channels (the second with stride 2, 14x14 ->
  7x7), each followed by LeakyReLU(0.1); ``fc_layers`` is the same FC stack.
  It returns (N, S, S, B*5+C).

The dropout is the port's generator-driven
:class:`~yolo_tpu_torch.models.layers.Dropout`. Flatten takes the logical
(C, H, W) order, as the reference does; on a channels_last tensor it copies.
``quantized=True`` makes the head's convs dynamic-int8; the FC layers stay
float, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_tpu_torch.models.layers import Dropout, conv, leaky_relu, linear


def _fc_stack(fin: int, num_classes: int, S: int, B: int, device) -> list:
    return [nn.Flatten(), linear(fin, 4096, device=device), leaky_relu(), Dropout(0.5),
            linear(4096, S * S * (B * 5 + num_classes), device=device)]


class SimpleHead(nn.Sequential):
    """Flatten -> Linear(4096) -> LeakyReLU -> Dropout(0.5) -> Linear(out).

    ``feature_size`` is the side of the backbone's 1024-channel map: 7 for
    448x448 images, so fc1 is 50176 -> 4096.
    """

    def __init__(self, num_classes: int = 20, S: int = 7, B: int = 2,
                 feature_size: int = 7, in_channels: int = 1024, *,
                 device: torch.device | str):
        super().__init__(*_fc_stack(in_channels * feature_size * feature_size, num_classes, S,
                                    B, device))
        self.S, self.B, self.num_classes = S, B, num_classes


class DetectionHead(nn.Module):
    """Conv tower (in -> 1024, one stride-2) + FC stack, reshaped to the grid.

    ``feature_size`` is the side of the map after the stride-2 conv: 7 for
    448x448 images.
    """

    def __init__(
        self, in_channels: int = 2048, num_classes: int = 20, S: int = 7,
        B: int = 2, feature_size: int = 7, *, device: torch.device | str,
        quantized: bool = False,
    ):
        super().__init__()
        self.S, self.B, self.num_classes = S, B, num_classes
        q = dict(device=device, quantized=quantized)
        self.conv_layers = nn.Sequential(
            conv(in_channels, 1024, 3, 1, 1, **q), leaky_relu(),
            conv(1024, 1024, 3, 2, 1, **q), leaky_relu(),
            conv(1024, 1024, 3, 1, 1, **q), leaky_relu(),
            conv(1024, 1024, 3, 1, 1, **q), leaky_relu(),
        )
        self.fc_layers = nn.Sequential(
            *_fc_stack(1024 * feature_size * feature_size, num_classes, S, B, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc_layers(self.conv_layers(x))
        return x.reshape(-1, self.S, self.S, self.B * 5 + self.num_classes)
