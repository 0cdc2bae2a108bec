"""mAP evaluation (COCO-style thresholds, VOC 11-point interpolation)."""

from yolo_tpu_torch.metrics.map import evaluate_model, mAPMetric

__all__ = ["evaluate_model", "mAPMetric"]
