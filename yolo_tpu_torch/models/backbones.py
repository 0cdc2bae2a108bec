"""Feature-extractor backbones in NCHW torch: the 24-conv YOLOv1 stack and
ResNet50, without torchvision.

Port of yolo_tpu/models/backbones.py.

- ``YOLOv1Backbone`` (JAX :28-73): 24 convs with bias, each followed by
  LeakyReLU(0.1), and four 2x2/2 max pools, in JAX's order, as one flat
  ``features`` Sequential, so its parameters are named
  ``features.{i}.weight/bias``: the reference layout that JAX's
  ``convert_reference_state_dict(..., backbone="yolov1")`` reads in index
  order (yolo_tpu/convert.py:218-233). The reference itself is not at hand,
  so its exact indices are not checked here; the tests hold this layout
  against JAX's converter, both ways. Output is (N, 1024, 7, 7) for a
  448x448 input.
- ``ResNetBackbone``: torchvision's resnet50 minus avgpool/fc, as the
  reference wraps it (src/yolo/models.py:131-176): ``extractor`` is a
  Sequential of stem conv 7x7/s2 (no bias), BN, ReLU, maxpool 3/2/1, then
  the bottleneck stages, so parameters are named ``extractor.{0,1,4..7}...``
  exactly as in a reference ``.pth``. Bottlenecks are v1.5 (stride on the
  3x3 conv). Output is (N, 2048, 14, 14) for a 448x448 input.

``quantized=True`` builds every conv as a dynamic-int8 ``Int8Conv2d``
(inference only). ``remat`` ("block" or "stage", JAX :163-230) recomputes
each bottleneck's or each stage's activations in the backward pass
(``layers.checkpoint``); the stem stays outside, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolo_tpu_torch.models.layers import (FusedBatchNormAct, batch_norm, checkpoint, conv,
                                          leaky_relu)

#: The 24-conv stack in order: (out channels, kernel, stride, padding) for a
#: conv, "M" for a 2x2/2 max pool (JAX backbones.py:44-72).
YOLOV1_LAYERS = (
    (64, 7, 2, 3), "M",
    (192, 3, 1, 1), "M",
    (128, 1, 1, 0), (256, 3, 1, 1), (256, 1, 1, 0), (512, 3, 1, 1), "M",
    *((256, 1, 1, 0), (512, 3, 1, 1)) * 4, (512, 1, 1, 0), (1024, 3, 1, 1), "M",
    *((512, 1, 1, 0), (1024, 3, 1, 1)) * 2, (1024, 3, 1, 1), (1024, 3, 2, 1),
    (1024, 3, 1, 1), (1024, 3, 1, 1),
)


def yolov1_conv_indices() -> list:
    """Indices of the 24 convs in ``YOLOv1Backbone.features``, in order
    (each conv is followed by its LeakyReLU; a pool takes one index)."""
    indices, i = [], 0
    for layer in YOLOV1_LAYERS:
        if layer == "M":
            i += 1
        else:
            indices.append(i)
            i += 2
    return indices


def yolov1_conv_inputs(image_size: int) -> list:
    """(C, H, W) of each of the 24 convs' inputs at ``image_size``, in order:
    the shapes ``Int8Conv2d`` quantizes (448 -> 8,329,216 elements an image)."""
    shapes, c, h = [], 3, image_size
    for layer in YOLOV1_LAYERS:
        if layer == "M":
            h //= 2
        else:
            shapes.append((c, h, h))
            c, k, s, p = layer
            h = (h + 2 * p - k) // s + 1
    return shapes


def yolov1_feature_size(image_size: int) -> int:
    """Side of the 24-conv stack's output map: 448 -> 7, 64 -> 1."""
    h = image_size
    for layer in YOLOV1_LAYERS:
        if layer == "M":
            h //= 2
        else:
            _, k, s, p = layer
            h = (h + 2 * p - k) // s + 1
    return h


def remat_mode(remat: bool | str | None) -> str:
    """"none", "block" or "stage" for a ``remat`` flag (True means "block")."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "block"):
        return "block"
    if remat == "stage":
        return "stage"
    raise ValueError(f"remat must be False, True, 'none', 'block' or 'stage', got {remat!r}")


class Backbone(nn.Module):
    """Abstract feature extractor (reference src/yolo/models.py:6-30):
    subclasses map (N, 3, H, W) images to (N, C, h, w) features."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("Subclasses must implement forward")


class YOLOv1Backbone(Backbone):
    """The original 24-conv YOLOv1 backbone: 448x448x3 -> (N, 1024, 7, 7)."""

    out_channels = 1024

    def __init__(self, *, device: torch.device | str, quantized: bool = False):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for layer in YOLOV1_LAYERS:
            if layer == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                cout, k, s, p = layer
                layers += [conv(cin, cout, k, s, p, device=device, quantized=quantized),
                           leaky_relu()]
                cin = cout
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


def fused_mode(fused_bn: bool | str) -> str | None:
    """None (unfused), "stats" or "full" for a ``fused_bn`` flag."""
    if fused_bn in (False, None):
        return None
    if fused_bn in (True, "stats"):
        return "stats"
    if fused_bn == "full":
        return "full"
    raise ValueError(f"fused_bn must be False, True, 'stats' or 'full', got {fused_bn!r}")


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: 1x1 -> 3x3 (stride here) -> 1x1 x4, + shortcut."""

    def __init__(
        self, inplanes: int, planes: int, stride: int, downsample: bool,
        *, device: torch.device | str, fused_bn: bool | str = False, quantized: bool = False,
    ):
        super().__init__()
        mode = fused_mode(fused_bn)
        q = dict(device=device, quantized=quantized)

        def bn(c: int, relu: bool = True) -> nn.BatchNorm2d:
            if mode is None:
                return batch_norm(c, device=device)
            return FusedBatchNormAct(c, relu, mode, device=device)

        self.fused = mode is not None
        self.conv1 = conv(inplanes, planes, 1, bias=False, **q)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1, bias=False, **q)
        self.bn2 = bn(planes)
        self.conv3 = conv(planes, planes * 4, 1, bias=False, **q)
        self.bn3 = bn(planes * 4)
        if not self.fused:
            self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(
                conv(inplanes, planes * 4, 1, stride, bias=False, **q),
                bn(planes * 4, relu=False),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        if self.fused:
            out = self.bn2(self.conv2(self.bn1(self.conv1(x))))
            return self.bn3(self.conv3(out), identity)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNetBackbone(Backbone):
    """ResNet feature extractor; ``stage_sizes`` (3, 4, 6, 3) is ResNet50.

    ``remat``: False / "none" stores every activation for the backward
    pass; True / "block" recomputes inside each bottleneck, storing each
    block's input; "stage" stores only each stage's input and recomputes
    the whole stage. Recomputation applies where autograd records (grad
    enabled); it changes no parameter and no result.
    """

    def __init__(
        self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
        *, device: torch.device | str, fused_bn: bool | str = False,
        quantized: bool = False, remat: bool | str = False,
    ):
        super().__init__()
        mode = fused_mode(fused_bn)
        self.remat = remat_mode(remat)
        self.num_stages = len(stage_sizes)
        layers: list[nn.Module] = [
            conv(3, 64, 7, 2, 3, bias=False, device=device, quantized=quantized),
            batch_norm(64, device=device) if mode is None
            else FusedBatchNormAct(64, True, mode, device=device),
            nn.ReLU(inplace=True) if mode is None else nn.Identity(),
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
                    downsample=block == 0, device=device, fused_bn=fused_bn,
                    quantized=quantized,
                ))
                inplanes = planes * 4
            layers.append(nn.Sequential(*blocks))
        self.extractor = nn.Sequential(*layers)
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat == "none" or not torch.is_grad_enabled():
            return self.extractor(x)
        stem, stages = self.extractor[:4], self.extractor[4:]
        x = stem(x)
        for stage in stages:
            if self.remat == "stage":
                x = checkpoint(stage, x)
            else:
                for block in stage:
                    x = checkpoint(block, x)
        return x
