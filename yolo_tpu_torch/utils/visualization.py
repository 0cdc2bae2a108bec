"""Draw detections on images (PIL).

The part of yolo_tpu/utils/visualization.py that the predict CLI uses:
``draw_detections`` (boxes and labels in a class-cycled palette, coordinates
clamped, boxes under ``min_box_size`` skipped). The label font is PIL's
built-in one. The objectness grids and matplotlib figures are not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

from PIL import Image, ImageDraw, ImageFont

# 9-color palette cycled by class id (reference visualization.py:64-76).
_COLORS = [
    "#e6194b",
    "#3cb44b",
    "#ffe119",
    "#4363d8",
    "#f58231",
    "#911eb4",
    "#46f0f0",
    "#f032e6",
    "#bcf60c",
]


def _detection_fields(det) -> tuple:
    """A Detection or a legacy ``(class_id, conf, cx, cy, w, h)`` tuple ->
    ``(class_id, confidence, class_name_or_None, cx, cy, w, h)``."""
    if isinstance(det, (tuple, list)):
        class_id, conf, cx, cy, w, h = det
        return int(class_id), float(conf), None, float(cx), float(cy), float(w), float(h)
    b = det.bbox
    return det.class_id, det.confidence, det.class_name, b.x, b.y, b.width, b.height


def draw_detections(
    image: Image.Image,
    detections: Sequence,
    class_names: Optional[Sequence[str]] = None,
    conf_threshold: float = 0.5,
    box_width: int = 3,
    font_size: int = 20,
    min_box_size: int = 2,
) -> Image.Image:
    """Draw detections onto a copy of ``image`` (reference visualization.py:34-147)."""
    out = image.copy()
    draw = ImageDraw.Draw(out)
    font = ImageFont.load_default(font_size)
    W, H = out.size

    for det in detections:
        class_id, conf, name, cx, cy, bw, bh = _detection_fields(det)
        if conf < conf_threshold:
            continue
        # Same int truncation as BoundingBox.to_pixel_coords / the reference.
        x1 = int((cx - bw / 2) * W)
        y1 = int((cy - bh / 2) * H)
        x2 = int((cx + bw / 2) * W)
        y2 = int((cy + bh / 2) * H)
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        x1, x2 = max(0, min(x1, W - 1)), max(0, min(x2, W - 1))
        y1, y2 = max(0, min(y1, H - 1)), max(0, min(y2, H - 1))
        if (x2 - x1) < min_box_size or (y2 - y1) < min_box_size:
            continue
        color = _COLORS[class_id % len(_COLORS)]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=box_width)
        name = name or (
            class_names[class_id]
            if class_names and class_id < len(class_names)
            else f"class_{class_id}"
        )
        label = f"{name}: {conf:.2f}"
        bbox = draw.textbbox((0, 0), label, font=font)
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        ty = y1 - th - 4 if y1 - th - 4 > 0 else y1 + 2
        draw.rectangle([x1, ty, x1 + tw + 4, ty + th + 4], fill=color)
        draw.text((x1 + 2, ty + 2), label, fill="white", font=font)
    return out

