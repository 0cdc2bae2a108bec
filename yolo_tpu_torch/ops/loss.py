"""Multi-part YOLOv1 loss in torch, with masked vectorized ops.

Port of yolo_tpu/ops/loss.py with the same semantics and op order:

- object cells: any target confidence slot > 0;
- target box: the target slot whose confidence is set (argmax over the
  confidence mask; ties to the first index, as ``jnp.argmax`` and
  ``torch.argmax`` both break them);
- responsible predictor: argmax IoU against the target box;
- coordinate loss on responsible boxes: SSE on (x, y) plus SSE on
  ``sqrt(clamp(w|h, 1e-6))``, weighted by ``lambda_coord``;
- object confidence target: the best IoU itself, NOT detached, so gradients
  flow through the IoU (the reference does not detach it);
- no-object loss over every non-responsible box, weighted by
  ``lambda_noobj``; class SSE over object cells;
- total = sum / batch size, or with ``sample_mask`` sum / max(sum(mask), 1).

The parts stay device tensors: the caller decides when to sync.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from yolo_tpu_torch.ops.boxes import iou_cellwise

_SQRT_CLAMP = 1e-6


def _pick(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[..., index, :]`` along dim 3 of an (N, S, S, B, k) tensor."""
    idx = index[..., None, None].expand(*index.shape, 1, t.shape[-1])
    return t.gather(3, idx).squeeze(3)


def yolo_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    S: int = 7,
    B: int = 2,
    C: int = 20,
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
    sample_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """YOLOv1 loss of (N, S, S, B*5+C) predictions against targets.

    Returns ``(total, parts)`` with parts "total", "coord", "conf_obj",
    "conf_noobj" and "class", each divided by the batch size (or by the
    count of ``sample_mask``, an (N,) bool/float tensor that zeroes padded
    samples).
    """
    N = predictions.shape[0]
    pred_boxes = predictions[..., : B * 5].reshape(N, S, S, B, 5)
    pred_cls = predictions[..., B * 5:]
    target_boxes = targets[..., : B * 5].reshape(N, S, S, B, 5)
    target_cls = targets[..., B * 5:]

    target_conf_mask = target_boxes[..., 4] > 0  # (N, S, S, B)
    obj_mask = target_conf_mask.any(dim=-1)  # (N, S, S)
    obj_f = obj_mask.to(predictions.dtype)
    if sample_mask is not None:
        mask_f = sample_mask.to(predictions.dtype)
        obj_f = obj_f * mask_f[:, None, None]

    target_slot = target_conf_mask.to(torch.int32).argmax(dim=-1)
    target_box = _pick(target_boxes[..., :4], target_slot)  # (N, S, S, 4)

    ious = iou_cellwise(pred_boxes[..., :4], target_box[..., None, :])  # (N, S, S, B)
    best_box = ious.argmax(dim=-1)
    best_iou = ious.gather(-1, best_box[..., None]).squeeze(-1)
    responsible = torch.nn.functional.one_hot(best_box, B).bool() & obj_mask[..., None]
    resp_box = _pick(pred_boxes, best_box)  # (N, S, S, 5)

    xy_err = ((resp_box[..., :2] - target_box[..., :2]) ** 2).sum(dim=-1)
    wh_err = (
        (torch.sqrt(resp_box[..., 2:4].clamp(min=_SQRT_CLAMP))
         - torch.sqrt(target_box[..., 2:4].clamp(min=_SQRT_CLAMP))) ** 2
    ).sum(dim=-1)
    coord_loss = lambda_coord * (obj_f * (xy_err + wh_err)).sum()

    conf_obj_loss = (obj_f * (resp_box[..., 4] - best_iou) ** 2).sum()

    noobj_sq = torch.where(responsible, 0.0, pred_boxes[..., 4] ** 2)
    if sample_mask is not None:
        noobj_sq = noobj_sq * mask_f[:, None, None, None]
    conf_noobj_loss = lambda_noobj * noobj_sq.sum()

    class_loss = (obj_f[..., None] * (pred_cls - target_cls) ** 2).sum()

    denom = N if sample_mask is None else mask_f.sum().clamp(min=1.0)
    total = (coord_loss + conf_obj_loss + conf_noobj_loss + class_loss) / denom
    parts = {
        "total": total,
        "coord": coord_loss / denom,
        "conf_obj": conf_obj_loss / denom,
        "conf_noobj": conf_noobj_loss / denom,
        "class": class_loss / denom,
    }
    return total, parts


class YOLOLoss:
    """``YOLOLoss(S, B, C)(predictions, targets)`` -> (total, parts), the reference API."""

    def __init__(self, S: int = 7, B: int = 2, C: int = 20, lambda_coord: float = 5.0,
                 lambda_noobj: float = 0.5):
        self.S, self.B, self.C = S, B, C
        self.lambda_coord, self.lambda_noobj = lambda_coord, lambda_noobj

    def __call__(self, predictions: torch.Tensor, targets: torch.Tensor):
        return yolo_loss(predictions, targets, S=self.S, B=self.B, C=self.C,
                         lambda_coord=self.lambda_coord, lambda_noobj=self.lambda_noobj)

    @staticmethod
    def compute_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
        return iou_cellwise(boxes1, boxes2)
