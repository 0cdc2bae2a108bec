"""PASCAL VOC dataset: direct XML parsing + YOLO target encoding.

Port of yolo_tpu/data/voc.py (numpy code, copied): the VOC layout
``VOCdevkit/VOC{year}/{JPEGImages,Annotations,ImageSets/Main}`` is read
directly, under the official or the Kaggle archive directory names. There
is no download: the dataset must be on disk.

Target encoding (reference dataset.py:487-532): cell i = int(S*y),
j = int(S*x) clamped to S-1; cell-relative x/y; confidence 1.0 in slot 0
only; one-hot class at 5*B + class_id; one object per cell, the first wins.
Augmentation draws come from ``np.random.default_rng((seed, epoch, idx))``,
so a sample depends only on its index and the epoch, in any worker.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from yolo_tpu_torch.data import transforms as T

VOC_CLASSES = [
    "aeroplane",
    "bicycle",
    "bird",
    "boat",
    "bottle",
    "bus",
    "car",
    "cat",
    "chair",
    "cow",
    "diningtable",
    "dog",
    "horse",
    "motorbike",
    "person",
    "pottedplant",
    "sheep",
    "sofa",
    "train",
    "tvmonitor",
]

CLASS_TO_IDX = {name: i for i, name in enumerate(VOC_CLASSES)}

# Kaggle archive directory names per (year, split) (reference dataset.py:75-88).
SPLIT_PATHS = {
    "2007": {
        "trainval": "VOCtrainval_06-Nov-2007",
        "test": "VOCtest_06-Nov-2007",
        "train": "VOCtrainval_06-Nov-2007",
        "val": "VOCtrainval_06-Nov-2007",
    },
    "2012": {
        "trainval": "VOCtrainval_11-May-2012",
        "test": "VOCtest_11-May-2012",
        "train": "VOCtrainval_11-May-2012",
        "val": "VOCtrainval_11-May-2012",
    },
}


def parse_voc_xml(xml_path: str | Path) -> Tuple[np.ndarray, List[int], Tuple[int, int]]:
    """Parse one VOC annotation XML.

    Returns (boxes, class_ids, (img_width, img_height)): boxes (M, 4) float32
    normalized center format, clamped to [0, 1]. Unknown class names are
    skipped.
    """
    root = ET.parse(str(xml_path)).getroot()
    size = root.find("size")
    img_w = float(size.find("width").text)
    img_h = float(size.find("height").text)

    boxes, class_ids = [], []
    for obj in root.iter("object"):
        name = obj.find("name").text
        if name not in CLASS_TO_IDX:
            continue
        bb = obj.find("bndbox")
        xmin = float(bb.find("xmin").text)
        ymin = float(bb.find("ymin").text)
        xmax = float(bb.find("xmax").text)
        ymax = float(bb.find("ymax").text)
        cx = np.clip((xmin + xmax) / 2.0 / img_w, 0.0, 1.0)
        cy = np.clip((ymin + ymax) / 2.0 / img_h, 0.0, 1.0)
        w = np.clip((xmax - xmin) / img_w, 0.0, 1.0)
        h = np.clip((ymax - ymin) / img_h, 0.0, 1.0)
        boxes.append([cx, cy, w, h])
        class_ids.append(CLASS_TO_IDX[name])
    return np.asarray(boxes, np.float32).reshape(-1, 4), class_ids, (int(img_w), int(img_h))


def encode_target(
    boxes: np.ndarray, class_ids: Sequence[int], S: int = 7, B: int = 2, C: int = 20
) -> np.ndarray:
    """Encode normalized center boxes into the (S, S, 5B+C) YOLO target."""
    target = np.zeros((S, S, 5 * B + C), np.float32)
    for box, class_id in zip(boxes, class_ids):
        cx, cy, w, h = (float(v) for v in box)
        i = min(int(S * cy), S - 1)
        j = min(int(S * cx), S - 1)
        if target[i, j, 4] == 0:
            target[i, j, 0] = S * cx - j
            target[i, j, 1] = S * cy - i
            target[i, j, 2] = w
            target[i, j, 3] = h
            target[i, j, 4] = 1.0
            target[i, j, 5 * B + int(class_id)] = 1.0
    return target


def _resolve_voc_dir(root: Path, year: str, image_set: str) -> Path:
    """Locate the VOC{year} directory under the official or Kaggle layouts."""
    base_year = year.split("-")[0]
    candidates = [
        root / SPLIT_PATHS.get(base_year, {}).get(image_set, "") / "VOCdevkit" / f"VOC{base_year}",
        root / "VOCdevkit" / f"VOC{base_year}",
        root / f"VOC{base_year}",
        root,
    ]
    for cand in candidates:
        if (cand / "JPEGImages").is_dir() and (cand / "Annotations").is_dir():
            return cand
    raise FileNotFoundError(
        f"Could not find VOC{base_year} (JPEGImages + Annotations) under {root};"
        f" tried {[str(c) for c in candidates]}"
    )


class VOCDetectionYOLO:
    """VOC dataset yielding (image HWC, YOLO target (S, S, 5B+C) float32).

    The image is float32 normalized, or uint8 with ``normalize_host=False``
    (then ``transforms.device_normalize`` runs on the device). Augmentation
    applies to the ``train`` split only.
    """

    VOC_CLASSES = VOC_CLASSES
    split_paths = SPLIT_PATHS

    def __init__(
        self,
        root: str | Path,
        year: str = "2007",
        image_set: str = "train",
        S: int = 7,
        B: int = 2,
        transform=None,
        target_size: Tuple[int, int] = (448, 448),
        augment: bool = True,
        seed: int = 0,
        normalize_host: bool = True,
    ):
        self.S = S
        self.B = B
        self.C = len(VOC_CLASSES)
        self.target_size = target_size
        self.augment = augment and image_set == "train"
        self.class_to_idx = CLASS_TO_IDX
        self.class_names = VOC_CLASSES
        self.transform = transform
        self.normalize_host = normalize_host
        self.seed = seed
        self.epoch = 0

        voc_dir = _resolve_voc_dir(Path(root), year, image_set)
        split_file = voc_dir / "ImageSets" / "Main" / f"{image_set}.txt"
        if not split_file.exists():
            raise FileNotFoundError(f"Split list not found: {split_file}")
        ids = [line.strip() for line in split_file.read_text().splitlines() if line.strip()]
        self.images = [str(voc_dir / "JPEGImages" / f"{i}.jpg") for i in ids]
        self.annotations = [str(voc_dir / "Annotations" / f"{i}.xml") for i in ids]

    def __len__(self) -> int:
        return len(self.images)

    def set_epoch(self, epoch: int) -> None:
        """Mix the epoch into the per-sample augmentation streams."""
        self.epoch = int(epoch)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        image = T.load_image_rgb(self.images[idx])
        boxes, class_ids, _ = parse_voc_xml(self.annotations[idx])

        if self.transform is not None:
            image = self.transform(image)
        elif self.augment:
            rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
            image, boxes = T.train_transform(
                image, boxes, rng, self.target_size, normalize_host=self.normalize_host
            )
        else:
            image = T.eval_transform(image, self.target_size, normalize_host=self.normalize_host)

        target = encode_target(boxes, class_ids, self.S, self.B, self.C)
        if not self.normalize_host and image.dtype == np.uint8:
            return image, target
        return image.astype(np.float32), target


class CombinedVOCDataset:
    """Concatenate several VOC datasets (reference dataset.py:590-659)."""

    def __init__(self, datasets: list):
        self.datasets = datasets
        self.lengths = [len(ds) for ds in datasets]
        self.cumulative = np.concatenate(([0], np.cumsum(self.lengths)))
        if datasets:
            first = datasets[0]
            self.S, self.B, self.C = first.S, first.B, first.C
            self.class_names, self.class_to_idx = first.class_names, first.class_to_idx
            for ds in datasets[1:]:
                if (ds.S, ds.B, ds.C) != (self.S, self.B, self.C):
                    raise ValueError(
                        f"All datasets must have the same S, B, C: {(self.S, self.B, self.C)}"
                        f" != {(ds.S, ds.B, ds.C)}")

    def __len__(self) -> int:
        return int(sum(self.lengths))

    def set_epoch(self, epoch: int) -> None:
        for ds in self.datasets:
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def __getitem__(self, idx: int):
        ds_idx = int(np.searchsorted(self.cumulative, idx, side="right")) - 1
        return self.datasets[ds_idx][idx - int(self.cumulative[ds_idx])]


def create_voc_datasets(
    years_and_splits: List[Tuple[str, str]],
    root: str | Path,
    S: int = 7,
    B: int = 2,
    target_size: Tuple[int, int] = (448, 448),
    augment: bool = True,
    normalize_host: bool = True,
):
    """One (possibly combined) dataset from (year, split) pairs (reference dataset.py:662-720)."""
    datasets = [
        VOCDetectionYOLO(
            root=root, year=year, image_set=image_set, S=S, B=B, target_size=target_size,
            augment=augment, normalize_host=normalize_host,
        )
        for year, image_set in years_and_splits
    ]
    return datasets[0] if len(datasets) == 1 else CombinedVOCDataset(datasets)
