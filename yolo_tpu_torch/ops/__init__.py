"""Torch ops of the inference path: box geometry, decode and NMS.

``nms`` is the hand-written CUDA kernel (``csrc/nms.cu``) with its plain
torch twin for CPU tensors; ``batched_nms`` is the sort-then-scan reference
both must equal.
"""

from yolo_tpu_torch.ops.boxes import (
    EPSILON,
    box_area,
    center_to_corners,
    iou_cellwise,
    iou_pairwise,
)
from yolo_tpu_torch.ops.cuda_nms import nms, nms_reference
from yolo_tpu_torch.ops.decode import Detections, decode_predictions
from yolo_tpu_torch.ops.nms import batched_nms

__all__ = [
    "EPSILON",
    "Detections",
    "batched_nms",
    "box_area",
    "center_to_corners",
    "decode_predictions",
    "iou_cellwise",
    "iou_pairwise",
    "nms",
    "nms_reference",
]
