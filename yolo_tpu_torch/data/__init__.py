"""Data: the VOC dataset, target encoding, transforms and the prefetching loader."""

from yolo_tpu_torch.data.loader import DataLoader, pad_batch
from yolo_tpu_torch.data.voc import (
    VOC_CLASSES,
    CombinedVOCDataset,
    VOCDetectionYOLO,
    create_voc_datasets,
    encode_target,
    parse_voc_xml,
)

__all__ = [
    "VOC_CLASSES",
    "CombinedVOCDataset",
    "DataLoader",
    "VOCDetectionYOLO",
    "create_voc_datasets",
    "encode_target",
    "pad_batch",
    "parse_voc_xml",
]
