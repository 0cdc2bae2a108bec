"""Plain PyTorch pieces every detection reference shares: the uint8 wire
format's normalization, exact integer convolutions with the int8 engines'
requant, the YOLO decode and per-class greedy NMS.

Written from the configuration's semantics, not from the program: this file
imports nothing of ``yolo_tpu_torch``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

#: ImageNet normalization of the uint8 wire format: x * SCALE + BIAS per channel.
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
NORM_SCALE = (1.0 / (255.0 * _STD)).astype(np.float32)
NORM_BIAS = (-_MEAN / _STD).astype(np.float32)
LEAKY = 0.1


class Dets(NamedTuple):
    """Per candidate: centre boxes (n, K, 4), scores (n, K), classes (n, K),
    the kept mask after NMS (n, K), and every class value of its cell
    (n, K, C), by which a chosen class is judged."""

    boxes: torch.Tensor
    scores: torch.Tensor
    class_ids: torch.Tensor
    valid: torch.Tensor
    class_values: Optional[torch.Tensor] = None


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32 (TF32 off) for the reference's dense layers."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def normalize(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> float32 ImageNet-normalized, where the images lie."""
    scale = torch.from_numpy(NORM_SCALE).to(images.device)
    bias = torch.from_numpy(NORM_BIAS).to(images.device)
    return images.to(torch.float32) * scale + bias


def f32(v: float, device) -> torch.Tensor:
    """A host float as a 0-dim float32 device tensor (divisions by it are true ones)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric: round(x / scale) clipped to +-qmax, as int8 (round half to even)."""
    return torch.round(x / scale).clamp(-qmax, qmax).to(torch.int8)


def quantize_weight(w: torch.Tensor, qmax: int, floor: float):
    """Per output channel (dim 0) of an OIHW or (out, in) weight:
    ``s_w = max(max|w| / qmax, floor)`` and the integer weight."""
    w = w.float()
    dims = tuple(range(1, w.dim()))
    s_w = torch.clamp(w.abs().amax(dim=dims) / f32(float(qmax), w.device), min=floor)
    shape = (-1,) + (1,) * (w.dim() - 1)
    return quantize(w, s_w.reshape(shape), qmax), s_w


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """The exact integer accumulator of an NHWC int8 conv with an OIHW int8
    weight, NHWC float64. Every product is an integer below 2**14 and every
    sum stays far below 2**53, so float64 is exact in any order; cuDNN is off
    so that no FFT or Winograd algorithm is chosen."""
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, wq.to(torch.float64), stride=stride, padding=pad)
    return acc.permute(0, 2, 3, 1)


def requant(acc: torch.Tensor, m: torch.Tensor, t: torch.Tensor, mode: str, qmax: int,
            res: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None):
    """``y = float32(acc) * m + t`` per channel, then by ``mode``: "float"
    returns y; "residual" adds ``res * r``, then ReLU; "relu"; "leaky" (0.1);
    "none"; the integer modes round and clip to +-qmax as int8."""
    y = acc.to(torch.float32) * m + t
    if mode == "float":
        return y
    if mode == "residual":
        y = y + res.to(torch.float32) * r
    if mode == "leaky":
        y = torch.where(y > 0, y, LEAKY * y)
    elif mode in ("relu", "residual"):
        y = torch.clamp(y, min=0.0)
    return torch.round(y).clamp(-qmax, qmax).to(torch.int8)


def decode(pred: torch.Tensor, S: int, B: int, C: int, conf: float) -> Dets:
    """(n, S, S, B*5+C) grid -> K = S*S*B candidates in (i, j, b) order:
    centres ((j, i) + offset) / S, score = confidence x the largest class
    value, class = its first argmax, valid = score > conf as a float64
    comparison decides it (conf rounded in float32)."""
    n = pred.shape[0]
    raw = pred[..., :B * 5].reshape(n, S, S, B, 5)
    cls = pred[..., B * 5:]
    idx = torch.arange(S, dtype=pred.dtype, device=pred.device)
    x = (idx[None, :, None] + raw[..., 0]) / S
    y = (idx[:, None, None] + raw[..., 1]) / S
    score = raw[..., 4] * torch.amax(cls, dim=-1)[..., None]
    K = S * S * B
    boxes = torch.stack([x, y, raw[..., 2], raw[..., 3]], dim=-1).reshape(n, K, 4)
    scores = score.reshape(n, K)
    class_ids = torch.argmax(cls, dim=-1)[..., None].expand(n, S, S, B).reshape(n, K)
    thr = float(np.float32(conf))
    valid = scores >= thr if thr > conf else scores > thr
    values = cls[..., None, :].expand(n, S, S, B, C).reshape(n, K, C)
    return Dets(boxes, scores, class_ids.to(torch.int32), valid, values)


def nms(d: Dets, iou_threshold: float, eps: float = 1e-6) -> Dets:
    """Per-class greedy NMS: in descending score order (ties: lower index
    first), a valid candidate is kept iff no kept candidate above it of its
    class has IoU >= the threshold; IoU = inter / (union + eps) on corners
    c -/+ 0.5 w, with the threshold and eps rounded to float32."""
    n, K = d.scores.shape
    thr, eps = float(np.float32(iou_threshold)), float(np.float32(eps))
    key = torch.where(d.valid, d.scores, torch.full_like(d.scores, float("-inf")))
    order = torch.sort(-key, dim=-1, stable=True).indices
    b = d.boxes.gather(1, order[..., None].expand(n, K, 4))
    c = d.class_ids.gather(1, order)
    v = d.valid.gather(1, order)
    cx, cy, w, h = b.unbind(-1)
    x1, y1, x2, y2 = cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5
    area = w * h
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0.0)
    inter = iw * ih
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + eps)
    hits = (iou >= thr) & (c[:, :, None] == c[:, None, :]) & v[:, :, None] & v[:, None, :]
    keep = v.clone()
    for i in range(1, K):
        keep[:, i] &= ~(keep[:, :i] & hits[:, :i, i]).any(dim=1)
    return d._replace(valid=torch.zeros_like(keep).scatter_(1, order, keep))
