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

- ``SwinBackbone``: Swin Transformer (Liu et al. 2021, arXiv:2103.14030) in
  the form of its official detection backbone (Swin-Transformer-Object-
  Detection ``mmdet/models/backbones/swin_transformer.py``): patch
  embedding, stages of (shifted-)window blocks with patch merging between
  them, each block padding its map to a multiple of the window, and a
  LayerNorm on the last stage's output. Parameters are named as in the
  official checkpoints (``patch_embed.*``, ``layers.{i}.blocks.{j}.*``,
  ``layers.{i}.downsample.*``, ``norm.*``). Output is (N, 1024, 14, 14)
  for Swin-B at 448x448. bf16 training and float32 inference only.

``quantized=True`` builds every conv as a dynamic-int8 ``Int8Conv2d``
(inference only). ``remat`` ("block" or "stage", JAX :163-230) recomputes
each bottleneck's or each stage's activations in the backward pass
(``layers.checkpoint``); the stem stays outside, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolo_tpu_torch.models.layers import (FusedBatchNormAct, WindowAttention, batch_norm,
                                          checkpoint, conv, layer_norm, leaky_relu, linear,
                                          shift_mask)
from yolo_tpu_torch.utils import tracing

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


# ---------------------------------------------------------------- Swin
#: The published Swin-B (configs/swin/swin_base_patch4_window7_224.yaml).
SWIN_B = dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32))


class PatchEmbed(nn.Module):
    """Pad H and W to multiples of ``patch_size``, a ``patch_size`` conv with
    stride ``patch_size`` to ``embed_dim`` channels, LayerNorm: (N, 3, H, W)
    -> (N, H / p, W / p, C) (a view of the conv's output, contiguous when
    that is channels_last)."""

    def __init__(self, patch_size: int, embed_dim: int, *, device: torch.device | str):
        super().__init__()
        self.patch_size = patch_size
        self.proj = conv(3, embed_dim, patch_size, patch_size, device=device)
        self.norm = layer_norm(embed_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        h, w = x.shape[-2:]
        if h % p or w % p:
            x = F.pad(x, (0, -w % p, 0, -h % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class Mlp(nn.Module):
    """fc1 (C -> ratio * C) -> exact (erf) GELU -> fc2 (ratio * C -> C)."""

    def __init__(self, dim: int, hidden: int, *, device: torch.device | str):
        super().__init__()
        self.fc1 = linear(dim, hidden, device=device)
        self.fc2 = linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``, on (N, H, W, C).
    ``shift`` 0 is a W-MSA block, ``window_size // 2`` an SW-MSA one. The
    tracer's spans: ``swin.wmsa`` or ``swin.swmsa`` (norm1 through the
    residual add), then ``swin.mlp``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float, *, device: torch.device | str):
        super().__init__()
        self.shift = shift
        self.norm1 = layer_norm(dim, device=device)
        self.attn = WindowAttention(dim, num_heads, window_size, device=device)
        self.norm2 = layer_norm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        with tracing.span("swin.swmsa" if self.shift else "swin.wmsa"):
            x = x + self.attn(self.norm1(x), self.shift, mask)
        with tracing.span("swin.mlp"):
            return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """(N, H, W, C) -> (N, ceil(H/2), ceil(W/2), 2C): pad an odd side, concatenate
    each 2x2 neighbourhood in Swin's order (x[0::2, 0::2], x[1::2, 0::2],
    x[0::2, 1::2], x[1::2, 1::2]), LayerNorm(4C), Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, *, device: torch.device | str):
        super().__init__()
        self.norm = layer_norm(4 * dim, device=device)
        self.reduction = linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """``depth`` blocks, every second one shifted, then patch merging unless
    it is the last stage. The shifted blocks' mask depends on the padded map
    size: it is built on the input's device at the first forward of a size
    and kept as a non-persistent buffer."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, downsample: bool, *, device: torch.device | str):
        super().__init__()
        self.window_size = window_size
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio, device=device) for i in range(depth))
        self.downsample = PatchMerging(dim, device=device) if downsample else None
        self.register_buffer("shift_mask", torch.zeros(0, device=device), persistent=False)
        self._mask_hw = None

    def mask(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.window_size
        hp, wp = -(-x.shape[1] // ws) * ws, -(-x.shape[2] // ws) * ws
        if self._mask_hw != (hp, wp):  # the first forward at this padded size
            self.shift_mask = shift_mask(hp, wp, ws, ws // 2).to(x.device)
            self._mask_hw = (hp, wp)
        return self.shift_mask

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = self.mask(x) if len(self.blocks) > 1 else None
        for block in self.blocks:
            x = block(x, mask)
        if self.downsample is not None:
            with tracing.span("swin.merge"):
                x = self.downsample(x)
        return x


class SwinBackbone(Backbone):
    """Swin Transformer feature extractor: (N, 3, H, W) -> (N, 8C, H/32, W/32)
    (ceil at each stride), NCHW with channels_last strides.

    ``embed_dim`` C, ``depths`` and ``num_heads`` per stage; every stage
    doubles the channels. Spans: ``swin.embed``, the blocks' and merges'
    (``SwinBlock``, ``SwinStage``), ``swin.norm_out``; :meth:`count_padding`
    gives the token positions a forward pads. No drop path, no dropout, no
    absolute position embedding.
    """

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int = 7, mlp_ratio: float = 4.0, patch_size: int = 4, *,
                 device: torch.device | str):
        super().__init__()
        if len(depths) != len(num_heads):
            raise ValueError("depths and num_heads need one entry a stage")
        self.window_size = window_size
        self.depths = tuple(depths)
        self.num_stages = len(depths)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, device=device)
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, d, nh, window_size, mlp_ratio,
                      i < len(depths) - 1, device=device)
            for i, (d, nh) in enumerate(zip(depths, num_heads)))
        self.out_channels = embed_dim * 2 ** (len(depths) - 1)
        self.norm = layer_norm(self.out_channels, device=device)

    @staticmethod
    def count_padding(n: int, h: int, w: int, depths: Sequence[int],
                      window_size: int = 7) -> int:
        """Token positions that the windows and merges of a forward pad, summed
        over ``n`` images whose embedded map is ``h`` x ``w``, every block and
        every merge: 0 where each stage's map is a multiple of the window, as
        at 448x448."""
        ws, total = window_size, 0
        for i, depth in enumerate(depths):
            total += depth * ((-(-h // ws) * ws) * (-(-w // ws) * ws) - h * w)
            if i < len(depths) - 1:
                total += (h + h % 2) * (w + w % 2) - h * w
                h, w = -(-h // 2), -(-w // 2)
        return n * total

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.span("swin.embed"):
            x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        with tracing.span("swin.norm_out"):
            x = self.norm(x)
        return x.permute(0, 3, 1, 2)
