"""Data: VOC class names and the eval transforms (the dataset is not ported yet)."""

from yolo_tpu_torch.data.voc import VOC_CLASSES

__all__ = ["VOC_CLASSES"]
