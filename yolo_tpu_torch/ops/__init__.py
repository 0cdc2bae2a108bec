"""Torch ops: box geometry, decode, NMS, the YOLO loss and the fused BN.

``nms`` is the hand-written CUDA kernel (``csrc/nms.cu``) with its plain
torch twin for CPU tensors; ``batched_nms`` is the sort-then-scan reference
both must equal. ``fused_bn`` holds the train-mode BN(+residual)+ReLU
through the kernels of ``csrc/fused_bn.cu``; ``loss`` the YOLOv1 loss.
"""

from yolo_tpu_torch.ops.boxes import (
    EPSILON,
    box_area,
    center_to_corners,
    corners_to_center,
    iou_cellwise,
    iou_pairwise,
)
from yolo_tpu_torch.ops.cuda_nms import nms, nms_reference
from yolo_tpu_torch.ops.decode import Detections, decode_ground_truth, decode_predictions
from yolo_tpu_torch.ops.loss import YOLOLoss, yolo_loss
from yolo_tpu_torch.ops.nms import batched_nms

__all__ = [
    "EPSILON",
    "Detections",
    "YOLOLoss",
    "batched_nms",
    "box_area",
    "center_to_corners",
    "corners_to_center",
    "decode_ground_truth",
    "decode_predictions",
    "iou_cellwise",
    "iou_pairwise",
    "nms",
    "nms_reference",
    "yolo_loss",
]
