"""Host-side image transforms: decode, resize/normalize, and YOLO-paper augmentation.

Port of yolo_tpu/data/transforms.py, numpy/cv2/PIL code copied with its
constants, op order and rounding, so the same image and the same numpy
generator give the same pixels as ``yolo_tpu.data``:

- eval: PIL's antialiased bilinear resize (torchvision's
  ``Resize(antialias=True)``) + ImageNet normalize;
- train: a RandomResizedCrop (area scale (0.8, 1.2), ratio (0.8, 1.2)) that
  carries the boxes, then ColorJitter (brightness 0.5, saturation 0.5, hue
  0.1) in a random order, through cv2 when it is installed and PIL/numpy
  otherwise;
- :func:`device_normalize` normalizes uint8 NHWC batches already on the
  device, so loaders can ship uint8 (4x fewer bytes).

cv2 and PIL are imported on first use.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Fused normalize constants: (x/255 - mean)/std == x*scale + bias, one pass.
_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_BIAS = (-IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cv2():
    """The cv2 module, or None where it is not installed (PIL then decodes)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def load_image_rgb(path: str) -> np.ndarray:
    """Decode an image file to HWC uint8 RGB (cv2 fast path, PIL fallback)."""
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is not None:
            return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def resize_bilinear(image: np.ndarray, size: Tuple[int, int], exact: bool = True) -> np.ndarray:
    """Resize HWC uint8 to (h, w), antialiased on downscale.

    ``exact=True`` uses PIL's antialiased bilinear, the filter of the
    reference's eval pipeline; ``exact=False`` cv2 INTER_AREA/INTER_LINEAR
    (faster, approximately antialiased) where cv2 is installed.
    """
    h, w = size
    cv2 = _cv2()
    if cv2 is not None and not exact:
        shrinking = w < image.shape[1] or h < image.shape[0]
        interp = cv2.INTER_AREA if shrinking else cv2.INTER_LINEAR
        return cv2.resize(image, (w, h), interpolation=interp)
    from PIL import Image

    return np.asarray(Image.fromarray(image).resize((w, h), Image.BILINEAR), np.uint8)


def normalize(image: np.ndarray) -> np.ndarray:
    """HWC uint8 -> float32 ImageNet-normalized (single fused pass)."""
    return image.astype(np.float32) * _NORM_SCALE + _NORM_BIAS


def eval_transform(
    image: np.ndarray, target_size: Tuple[int, int], normalize_host: bool = True
) -> np.ndarray:
    """Validation/test transform: resize, then normalize unless deferred to the device."""
    resized = resize_bilinear(image, target_size)
    return normalize(resized) if normalize_host else resized


_NORM_ON_DEVICE: dict = {}


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize a uint8 (..., 3) channel-last tensor where it lies.

    The (3,) scale and bias are copied to each device once and kept there: a
    copy from host memory on every call would make the host wait for all
    the work queued on the device before it.
    """
    device = images.device
    if device not in _NORM_ON_DEVICE:
        _NORM_ON_DEVICE[device] = (torch.from_numpy(_NORM_SCALE).to(device),
                                   torch.from_numpy(_NORM_BIAS).to(device))
    scale, bias = _NORM_ON_DEVICE[device]
    return images.to(torch.float32) * scale + bias


def sample_resized_crop(
    rng: np.random.Generator,
    height: int,
    width: int,
    scale: Tuple[float, float] = (0.8, 1.2),
    ratio: Tuple[float, float] = (0.8, 1.2),
    attempts: int = 10,
) -> Tuple[int, int, int, int]:
    """Sample a crop window (top, left, h, w) a la RandomResizedCrop.

    Area fraction uniform in ``scale``, aspect ratio log-uniform in ``ratio``;
    a centered max-size crop after ``attempts`` misses.
    """
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(attempts):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def _jitter_ops(rng: np.random.Generator, brightness: float, saturation: float,
                hue: float) -> list:
    """The jitter factors, drawn in a fixed order, then shuffled."""
    ops = []
    if brightness > 0:
        ops.append(("b", rng.uniform(max(0.0, 1 - brightness), 1 + brightness)))
    if saturation > 0:
        ops.append(("s", rng.uniform(max(0.0, 1 - saturation), 1 + saturation)))
    if hue > 0:
        ops.append(("h", rng.uniform(-hue, hue)))
    rng.shuffle(ops)
    return ops


def _adjust_colors_u8(
    rng: np.random.Generator, image: np.ndarray, brightness: float, saturation: float,
    hue: float,
) -> np.ndarray:
    """ColorJitter-equivalent jitter on uint8 through cv2 (the fast path)."""
    cv2 = _cv2()
    for kind, value in _jitter_ops(rng, brightness, saturation, hue):
        if kind == "b":
            image = cv2.convertScaleAbs(image, alpha=value, beta=0.0)
        elif kind == "s":
            gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)  # 0.299/0.587/0.114
            gray3 = cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB)
            image = cv2.addWeighted(image, value, gray3, 1.0 - value, 0.0)
        else:
            hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(round(value * 180))) % 180
            image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
    return image


def _adjust_colors(
    rng: np.random.Generator, image_f: np.ndarray, brightness: float, saturation: float,
    hue: float,
) -> np.ndarray:
    """ColorJitter-equivalent brightness/saturation/hue on [0, 1] floats."""
    cv2 = _cv2()
    for kind, value in _jitter_ops(rng, brightness, saturation, hue):
        if kind == "b":
            image_f = np.clip(image_f * value, 0.0, 1.0)
        elif kind == "s":
            gray = (
                image_f[..., 0] * 0.299 + image_f[..., 1] * 0.587 + image_f[..., 2] * 0.114
            )[..., None]
            image_f = np.clip(gray + (image_f - gray) * value, 0.0, 1.0)
        elif cv2 is not None:
            hsv = cv2.cvtColor((image_f * 255).astype(np.uint8), cv2.COLOR_RGB2HSV).astype(
                np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(round(value * 180))) % 180
            image_f = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(
                np.float32) / 255.0
        else:
            from PIL import Image

            hsv = np.asarray(
                Image.fromarray((image_f * 255).astype(np.uint8)).convert("HSV"), np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(round(value * 255))) % 256
            image_f = np.asarray(
                Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB"), np.float32
            ) / 255.0
    return image_f


def train_transform(
    image: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    target_size: Tuple[int, int] = (448, 448),
    normalize_host: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Augment one sample: random resized crop (box-aware) + color jitter.

    ``image`` HWC uint8 RGB, ``boxes`` (M, 4) normalized center boxes. Returns
    (the image: float32 normalized, or uint8 with ``normalize_host=False``;
    the boxes clamped to the crop, then to [0, 1]; degenerate boxes kept).
    """
    height, width = image.shape[:2]
    top, left, ch, cw = sample_resized_crop(rng, height, width)

    crop = image[top: top + ch, left: left + cw]
    cv2 = _cv2()
    if cv2 is not None:
        crop = cv2.resize(crop, (target_size[1], target_size[0]),
                          interpolation=cv2.INTER_LINEAR)
        crop = _adjust_colors_u8(rng, crop, brightness=0.5, saturation=0.5, hue=0.1)
        image_f = normalize(crop) if normalize_host else crop
    else:
        crop = resize_bilinear(crop, target_size)
        image_f = crop.astype(np.float32) / 255.0
        image_f = _adjust_colors(rng, image_f, brightness=0.5, saturation=0.5, hue=0.1)
        if normalize_host:
            image_f = (image_f - IMAGENET_MEAN) / IMAGENET_STD
        else:
            image_f = (image_f * 255.0 + 0.5).astype(np.uint8)

    if boxes.size:
        corners = np.empty_like(boxes)
        corners[:, 0] = (boxes[:, 0] - boxes[:, 2] / 2) * width
        corners[:, 1] = (boxes[:, 1] - boxes[:, 3] / 2) * height
        corners[:, 2] = (boxes[:, 0] + boxes[:, 2] / 2) * width
        corners[:, 3] = (boxes[:, 1] + boxes[:, 3] / 2) * height
        corners[:, [0, 2]] = np.clip(corners[:, [0, 2]] - left, 0, cw)
        corners[:, [1, 3]] = np.clip(corners[:, [1, 3]] - top, 0, ch)
        out = np.empty_like(boxes)
        out[:, 0] = (corners[:, 0] + corners[:, 2]) / 2 / cw
        out[:, 1] = (corners[:, 1] + corners[:, 3]) / 2 / ch
        out[:, 2] = (corners[:, 2] - corners[:, 0]) / cw
        out[:, 3] = (corners[:, 3] - corners[:, 1]) / ch
        boxes = np.clip(out, 0.0, 1.0)
    return image_f, boxes
