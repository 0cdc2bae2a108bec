"""Vectorized box geometry in center format (cx, cy, w, h), in torch.

Port of yolo_tpu/ops/boxes.py with the same op order, so float32 results
agree bit for bit: corners are ``c -/+ w * 0.5``, the area is the
center-format ``w * h`` (unclamped), and IoU is ``inter / (union + eps)``,
or with ``eps == 0`` the evaluator's guarded ``inter / union``.
"""

from __future__ import annotations

import torch

EPSILON = 1e-6


def center_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-format boxes -> (..., 4) corners (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    half_w, half_h = w * 0.5, h * 0.5
    return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of center-format boxes: w * h."""
    return boxes[..., 2] * boxes[..., 3]


def _intersection(corners1: torch.Tensor, corners2: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(corners1[..., :2], corners2[..., :2])
    rb = torch.minimum(corners1[..., 2:], corners2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou_cellwise(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = EPSILON
) -> torch.Tensor:
    """Broadcast element-wise IoU between center-format boxes.

    ``eps == 0`` is the evaluator's IoU: ``inter / union`` with a
    ``union == 0 -> 0`` guard and no stabilizer.
    """
    inter = _intersection(center_to_corners(boxes1), center_to_corners(boxes2))
    union = box_area(boxes1) + box_area(boxes2) - inter
    if eps == 0.0:
        zero = union == 0.0
        return torch.where(zero, 0.0, inter / torch.where(zero, 1.0, union))
    return inter / (union + eps)


def iou_pairwise(
    boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = EPSILON
) -> torch.Tensor:
    """All-pairs IoU: (..., A, 4) x (..., B, 4) -> (..., A, B)."""
    return iou_cellwise(boxes1[..., :, None, :], boxes2[..., None, :, :], eps=eps)
