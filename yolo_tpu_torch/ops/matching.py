"""Greedy prediction-to-GT matching for mAP, batched, in torch.

Port of yolo_tpu/ops/matching.py. Within one image, the score-sorted
predictions claim GTs in turn: a prediction's best GT is the first maximum
of its IoU row, masked to valid GTs of its class (an all-zero row picks GT
0 at IoU 0); it is a TP iff it is valid, that IoU is >= the threshold and
the GT is not yet claimed, and a TP claims its GT. Predictions are sorted
by a stable descending sort of ``where(valid, score, -inf)``.

JAX runs that rule as a ``lax.scan`` over the K predictions with a
``gt_taken`` state. The port computes the same flags without the K-step
loop: a prediction's best GT and IoU do not depend on the state, so "not
yet claimed" means "no earlier eligible prediction (valid, IoU >= threshold)
has the same best GT". The first eligible index per (image, mask,
threshold, GT) is one ``scatter_reduce(amin)``; a prediction is a TP iff it
is eligible and is that first index. Integer and boolean logic only, so the
flags equal the scan's on every device, for all M masks and T thresholds
at once.

The module has the JAX module's three entries. The evaluator calls
:func:`match_detections_masked`; :func:`match_detections` (one mask) and
:func:`_match_single_threshold` (one image, one threshold) are JAX's other
two, kept so that code written against JAX's module finds them, and held
against JAX and the literal scan by the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yolo_tpu_torch.ops.boxes import iou_pairwise


def _first_claims(best_gt: torch.Tensor, eligible: torch.Tensor, G: int) -> torch.Tensor:
    """TP flags (..., K): eligible and the first eligible k with its best GT.

    ``best_gt`` (..., K) int64 and ``eligible`` (..., K) bool broadcast
    together; the flags are the greedy scan's.
    """
    best_gt, eligible = torch.broadcast_tensors(best_gt, eligible)
    K = best_gt.shape[-1]
    k = torch.arange(K, device=best_gt.device).expand_as(best_gt)
    first = torch.full((*best_gt.shape[:-1], G), K, dtype=torch.int64, device=best_gt.device)
    first = first.scatter_reduce(-1, best_gt, torch.where(eligible, k, K), reduce="amin")
    return eligible & (first.gather(-1, best_gt) == k)


def _match_single_threshold(
    iou: torch.Tensor,  # (K, G) pred x GT IoU, masked to same-class valid GTs
    pred_valid: torch.Tensor,  # (K,) in score-sorted order
    threshold: torch.Tensor | float,
) -> torch.Tensor:
    """Greedy matching of score-sorted predictions; TP flags (K,)."""
    best_gt = iou.argmax(dim=-1)  # first maximum, as jnp.argmax
    best_iou = iou.gather(-1, best_gt[:, None])[:, 0]
    return _first_claims(best_gt, pred_valid & (best_iou >= threshold), iou.shape[-1])


def match_detections_masked(
    pred_boxes: torch.Tensor,  # (N, K, 4)
    pred_scores: torch.Tensor,  # (N, K)
    pred_class: torch.Tensor,  # (N, K)
    pred_valid: torch.Tensor,  # (N, K) post-NMS keep mask
    gt_boxes: torch.Tensor,  # (N, G, 4)
    gt_class: torch.Tensor,  # (N, G)
    gt_valid_masks: torch.Tensor,  # (M, N, G) GT-filter variants (e.g. sizes)
    thresholds: torch.Tensor,  # (T,)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy matching over M GT-validity masks and T thresholds at once.

    The score sort and the (K, G) IoU matrix are computed once per image
    and shared by every mask and threshold. Returns (tp (N, M, T, K),
    scores_sorted, class_sorted, valid_sorted (N, K)), the TP flags in
    score-sorted order. Runs on the inputs' device.
    """
    key = torch.where(pred_valid, pred_scores, float("-inf"))
    order = torch.sort(-key, dim=-1, stable=True).indices  # (N, K)
    pb = pred_boxes.gather(1, order[..., None].expand(-1, -1, 4))
    ps, pc, pv = pred_scores.gather(1, order), pred_class.gather(1, order), \
        pred_valid.gather(1, order)

    # eps=0: the metric's IoU has no stabilizer, so an IoU of exactly 0.5
    # stays a TP at the 0.5 threshold.
    iou = iou_pairwise(pb, gt_boxes, eps=0.0)  # (N, K, G)
    ok = (pc[:, :, None] == gt_class[:, None, :])[:, None] \
        & gt_valid_masks.permute(1, 0, 2)[:, :, None, :]  # (N, M, K, G)
    iou_masked = torch.where(ok, iou[:, None], 0.0)
    best_gt = iou_masked.argmax(dim=-1)  # (N, M, K), first maximum
    best_iou = iou_masked.gather(-1, best_gt[..., None])[..., 0]
    eligible = pv[:, None, None, :] & (best_iou[:, :, None, :]
                                       >= thresholds[None, None, :, None])  # (N, M, T, K)
    tp = _first_claims(best_gt[:, :, None, :], eligible, gt_boxes.shape[1])
    return tp, ps, pc, pv


def match_detections(
    pred_boxes: torch.Tensor,
    pred_scores: torch.Tensor,
    pred_class: torch.Tensor,
    pred_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_class: torch.Tensor,
    gt_valid: torch.Tensor,  # (N, G)
    thresholds: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-mask form of :func:`match_detections_masked`: tp (N, T, K)."""
    tp, ps, pc, pv = match_detections_masked(pred_boxes, pred_scores, pred_class, pred_valid,
                                             gt_boxes, gt_class, gt_valid[None], thresholds)
    return tp[:, 0], ps, pc, pv
