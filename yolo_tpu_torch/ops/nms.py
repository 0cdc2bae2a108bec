"""Per-class greedy NMS in plain torch: stable sort, then the greedy scan.

Port of yolo_tpu/ops/nms.py. A candidate is kept iff no higher-ranked kept
candidate of its class has IoU >= threshold with it. Candidates are ranked by
a stable descending sort over the (i, j, b) decode order, so equal scores
keep their decode order; invalid candidates sink to the end and never
suppress. This is the port's reference NMS: the kernel in ops/cuda_nms.py
must give the same keep mask.
"""

from __future__ import annotations

import torch

from yolo_tpu_torch.ops.boxes import EPSILON, iou_pairwise
from yolo_tpu_torch.ops.decode import Detections


def _keep_mask(
    boxes: torch.Tensor,  # (n, K, 4)
    scores: torch.Tensor,  # (n, K)
    class_ids: torch.Tensor,  # (n, K)
    valid: torch.Tensor,  # (n, K)
    iou_threshold: float,
    eps: float,
) -> torch.Tensor:
    K = scores.shape[-1]
    sort_key = torch.where(valid, scores, float("-inf"))
    order = torch.sort(-sort_key, dim=-1, stable=True).indices

    sb = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    sc = class_ids.gather(1, order)
    sv = valid.gather(1, order)

    iou = iou_pairwise(sb, sb, eps=eps)  # (n, K, K)
    same_class = sc[:, :, None] == sc[:, None, :]
    # suppress[:, j, i]: kept j (ranked above i) would suppress i.
    suppress = (iou >= iou_threshold) & same_class & sv[:, :, None] & sv[:, None, :]

    keep = sv.clone()
    for i in range(1, K):
        above = keep[:, :i] & suppress[:, :i, i]
        keep[:, i] &= ~above.any(dim=1)
    return torch.zeros_like(keep).scatter_(1, order, keep)


def batched_nms(
    dets: Detections, iou_threshold: float = 0.4, eps: float = EPSILON
) -> Detections:
    """Per-class greedy NMS over the last axis of batched Detections.

    Returns ``dets`` with ``valid`` narrowed to the survivors. ``eps`` is the
    IoU stabilizer: 1e-6 for inference, 0 for the mAP evaluator.
    """
    batch_shape = dets.scores.shape[:-1]
    K = dets.scores.shape[-1]
    keep = _keep_mask(
        dets.boxes.reshape(-1, K, 4),
        dets.scores.reshape(-1, K),
        dets.class_ids.reshape(-1, K),
        dets.valid.reshape(-1, K),
        iou_threshold,
        eps,
    )
    return dets._replace(valid=keep.reshape(*batch_shape, K))
