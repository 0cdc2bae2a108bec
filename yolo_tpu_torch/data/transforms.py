"""Eval-time image transforms: resize and ImageNet normalize.

The subset of yolo_tpu/data/transforms.py that inference uses, with the same
constants and rounding: host ``resize_bilinear`` (PIL's antialiased
bilinear, the filter of torchvision's ``Resize(antialias=True)``), host
``normalize``, ``eval_transform``, and ``device_normalize`` for uint8 NHWC
batches already on the device. PIL is imported only when resizing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Fused normalize constants: (x/255 - mean)/std == x*scale + bias, one pass.
_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_BIAS = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize HWC uint8 to (h, w) with PIL's antialiased bilinear filter."""
    from PIL import Image

    h, w = size
    return np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR), np.uint8)


def normalize(image: np.ndarray) -> np.ndarray:
    """HWC uint8 -> float32 ImageNet-normalized (single fused pass)."""
    return image.astype(np.float32) * _NORM_SCALE + _NORM_BIAS


def eval_transform(image: np.ndarray, target_size: Tuple[int, int]) -> np.ndarray:
    """Validation/test transform: resize, then normalize on the host."""
    return normalize(resize_bilinear(image, target_size))


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize a uint8 (..., 3) channel-last tensor where it lies."""
    scale = torch.from_numpy(_NORM_SCALE).to(images.device)
    bias = torch.from_numpy(_NORM_BIAS).to(images.device)
    return images.to(torch.float32) * scale + bias
