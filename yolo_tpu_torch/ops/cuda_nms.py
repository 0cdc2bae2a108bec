"""Per-class greedy NMS through the hand-written CUDA kernel ``csrc/nms.cu``.

Port of the TPU kernel yolo_tpu/ops/pallas_nms.py::_nms_kernel. The rule:
K times, or until nothing is active, keep the active candidate with the
highest score (ties to the lowest index) and deactivate every active
candidate of the same class whose IoU with it is >= the threshold. The
kernel computes the same keep mask without that chain: it ranks the
eligible candidates, builds the pairwise suppression mask in sorted order
in parallel and leaves one warp a bit scan (the header of ``nms.cu``). The
keep mask equals ops/nms.py::batched_nms bit for bit.

:func:`nms` launches the kernel for CUDA tensors and runs
:func:`nms_reference`, the selection loop in plain torch, for CPU tensors. A
CUDA tensor never reaches the plain loop: the kernel runs or the call raises.
Boxes and scores are float32 (serving, the fast evaluator) or float64 (the
precise evaluator); the kernel has an instantiation for each.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_tpu_torch.ops.boxes import EPSILON
from yolo_tpu_torch.ops.decode import Detections
from yolo_tpu_torch.utils import kernels

#: Largest candidate count per image the kernel takes (two candidates a
#: thread of 512, csrc/nms.cu).
MAX_CANDIDATES = 1024
#: (name, dtype, trailing box axis) of each Detections field the kernel reads;
#: a dtype of None is the scores' own, float32 or float64.
_FIELDS = (("boxes", None, True), ("scores", None, False),
           ("class_ids", torch.int32, False), ("valid", torch.bool, False))
_FLOATS = (torch.float32, torch.float64)


def nms_reference(
    boxes: torch.Tensor,  # (n, K, 4) center format
    scores: torch.Tensor,  # (n, K)
    class_ids: torch.Tensor,  # (n, K)
    valid: torch.Tensor,  # (n, K) bool
    iou_threshold: float,
    eps: float,
) -> torch.Tensor:
    """The kernel's selection loop in plain torch: keep mask (n, K) bool.

    Same op order as pallas_nms.py:131-135 (corners, area) and :90-93 (IoU).
    """
    n, K = scores.shape
    cx, cy, w, h = boxes.unbind(-1)
    x1, y1 = cx - w * 0.5, cy - h * 0.5
    x2, y2 = cx + w * 0.5, cy + h * 0.5
    area = w * h
    lane = torch.arange(K, device=scores.device).expand(n, K)

    active = valid.clone()
    keep = torch.zeros_like(valid)
    for _ in range(K):
        if not bool(active.any()):
            break
        masked = torch.where(active, scores, float("-inf"))
        best_val = masked.amax(dim=1, keepdim=True)
        found = best_val > float("-inf")
        is_best = (masked == best_val) & active
        best = torch.where(is_best, lane, K).amin(dim=1, keepdim=True)
        sel = lane == best
        bi = best.clamp(max=K - 1)

        def pick(v: torch.Tensor) -> torch.Tensor:
            return v.gather(1, bi)

        inter_w = (torch.minimum(x2, pick(x2)) - torch.maximum(x1, pick(x1))).clamp(min=0.0)
        inter_h = (torch.minimum(y2, pick(y2)) - torch.maximum(y1, pick(y1))).clamp(min=0.0)
        inter = inter_w * inter_h
        union = area + pick(area) - inter
        if eps == 0.0:
            zero = union == 0.0
            iou = torch.where(zero, 0.0, inter / torch.where(zero, 1.0, union))
        else:
            iou = inter / (union + eps)

        suppress = active & (class_ids == pick(class_ids)) & (iou >= iou_threshold)
        keep |= sel & found
        active &= ~sel & ~suppress & found
    return keep


def _launch(boxes, scores, class_ids, valid, iou_threshold, eps) -> torch.Tensor:
    n, K = scores.shape
    keep = torch.empty((n, K), dtype=torch.bool, device=scores.device)
    entry = "yolo_nms_f64" if scores.dtype == torch.float64 else "yolo_nms"
    kernels.launch(entry, scores.device, boxes.data_ptr(), scores.data_ptr(),
                   class_ids.data_ptr(), valid.data_ptr(), keep.data_ptr(), n, K,
                   iou_threshold, eps)
    return keep


def _check(dets: Detections, K: int) -> None:
    shape = dets.scores.shape
    device = dets.scores.device
    if dets.scores.dtype not in _FLOATS:
        raise TypeError(f"nms: scores must be float32 or float64, got {dets.scores.dtype}")
    for name, dtype, box in _FIELDS:
        t = getattr(dets, name)
        want = (*shape, 4) if box else tuple(shape)
        dtype = dtype or dets.scores.dtype
        if t.dtype != dtype:
            raise TypeError(f"nms: {name} must be {dtype}, got {t.dtype}")
        if t.shape != want:
            raise ValueError(f"nms: {name} must have shape {want}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"nms: {name} is on {t.device}, scores on {device}")
        if not t.is_contiguous():
            raise ValueError(f"nms: {name} must be contiguous")
    if device.type == "cuda" and K > MAX_CANDIDATES:
        raise ValueError(f"nms: the kernel takes K <= {MAX_CANDIDATES}, got {K}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"nms: unsupported device {device}")


def keep_args(dets: Detections, iou_threshold: float, eps: float) -> tuple:
    """The checked operands of one keep-mask computation: the four fields as
    (n, K) rows, then ``iou_threshold`` and ``eps`` rounded to the scores'
    dtype, as the JAX compare rounds them."""
    K = dets.scores.shape[-1]
    _check(dets, K)
    rnd = np.float32 if dets.scores.dtype == torch.float32 else np.float64
    return (
        dets.boxes.reshape(-1, K, 4),
        dets.scores.reshape(-1, K),
        dets.class_ids.reshape(-1, K),
        dets.valid.reshape(-1, K),
        float(rnd(iou_threshold)),
        float(rnd(eps)),
    )


def keep_mask(boxes, scores, class_ids, valid, iou_threshold: float,
              eps: float) -> torch.Tensor:
    """(n, K) keep mask of :func:`keep_args`' operands: the kernel on CUDA,
    :func:`nms_reference` on the CPU."""
    if scores.device.type == "cuda":
        return _launch(boxes, scores, class_ids, valid, iou_threshold, eps)
    return nms_reference(boxes, scores, class_ids, valid, iou_threshold, eps)


def nms(
    dets: Detections, iou_threshold: float = 0.4, eps: float = EPSILON
) -> Detections:
    """Per-class greedy NMS over the last axis; ``valid`` narrowed to the keep mask.

    Takes ``boxes`` (..., K, 4) in center format and ``scores`` (..., K),
    both float32 or both float64, ``class_ids`` i32 (..., K) and ``valid``
    bool (..., K), all contiguous and on one device. ``iou_threshold`` and
    ``eps`` are rounded to the scores' dtype, as the JAX compare rounds them.
    On CUDA the kernel runs; on the CPU, :func:`nms_reference`.
    """
    keep = keep_mask(*keep_args(dets, iou_threshold, eps))
    # keep implies valid: only valid candidates are ever kept.
    return dets._replace(valid=keep.reshape(dets.scores.shape))
