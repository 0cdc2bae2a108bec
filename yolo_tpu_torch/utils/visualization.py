"""Draw detections and objectness grids on images (PIL).

Port of yolo_tpu/utils/visualization.py: ``draw_detections`` (boxes and
labels in a class-cycled palette, coordinates clamped, boxes under
``min_box_size`` skipped), and the objectness views of a raw (S, S, B*5+C)
grid: ``extract_objectness_scores`` (the max box confidence a cell),
``draw_objectness_grid_on_image`` (grid lines and each cell's score) and
``visualize_objectness_grid`` (a 3-panel matplotlib figure). The label font
is PIL's built-in one. matplotlib is imported by ``visualize_objectness_grid``
alone, so the rest needs only PIL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
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


def _grid_array(pred) -> np.ndarray:
    """A raw grid (numpy array or tensor, 3-D or batched 4-D) as numpy."""
    if hasattr(pred, "detach"):  # a torch tensor
        pred = pred.detach().cpu()
        if not pred.dtype.is_floating_point or pred.itemsize < 4:
            pred = pred.float()
        return pred.numpy()
    return np.asarray(pred)


def extract_objectness_scores(pred, S: int = 7, B: int = 2) -> np.ndarray:
    """Max box confidence per cell -> (S, S) heatmap; a 4-D batch gives its
    first image's (reference visualization.py:209-254)."""
    pred = _grid_array(pred)
    if pred.ndim == 4:
        pred = pred[0]
    confs = np.stack([pred[..., b * 5 + 4] for b in range(B)], axis=-1)
    return confs.max(axis=-1)


def visualize_objectness_grid(
    image: Image.Image,
    pred,
    S: int = 7,
    B: int = 2,
    save_path: Optional[str] = None,
):
    """3-panel figure: image | objectness heatmap | overlay
    (reference visualization.py:257-328). Requires matplotlib; returns the
    figure, or ``save_path`` after writing it there."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("visualize_objectness_grid needs matplotlib, which is not "
                          "installed; draw_objectness_grid_on_image needs only PIL") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scores = extract_objectness_scores(pred, S, B)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(image)
    axes[0].set_title("Input")
    axes[0].axis("off")
    im = axes[1].imshow(scores, cmap="hot", vmin=0)
    axes[1].set_title("Objectness (max box conf per cell)")
    fig.colorbar(im, ax=axes[1])
    axes[2].imshow(image)
    axes[2].imshow(
        np.kron(scores, np.ones((image.size[1] // S, image.size[0] // S))),
        cmap="hot",
        alpha=0.45,
        vmin=0,
    )
    axes[2].set_title("Overlay")
    axes[2].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def draw_objectness_grid_on_image(image: Image.Image, pred, S: int = 7,
                                  B: int = 2) -> Image.Image:
    """Grid lines + per-cell score text on a copy of ``image`` (reference
    visualization.py:331-390)."""
    out = image.copy()
    draw = ImageDraw.Draw(out)
    font = ImageFont.load_default(12)
    W, H = out.size
    scores = extract_objectness_scores(pred, S, B)
    cell_w, cell_h = W / S, H / S
    for k in range(1, S):
        draw.line([(k * cell_w, 0), (k * cell_w, H)], fill="white", width=1)
        draw.line([(0, k * cell_h), (W, k * cell_h)], fill="white", width=1)
    for i in range(S):
        for j in range(S):
            draw.text((j * cell_w + 3, i * cell_h + 3), f"{scores[i, j]:.2f}",
                      fill="yellow", font=font)
    return out
