"""The one traffic generator: every input of a run, drawn from its ``--seed``.

A cell's ``params`` (in ``workloads/<cell>.json``) say how much of what:
image pools (``pool_batches`` x ``batch`` uint8 images of ``image_size``)
and training targets (``boxes_per_image``).
The same seed gives the same inputs; the amount of work never depends on the
seed, only the values and the order.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def uint8_images(seed: int, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) uniform uint8 images, drawn on ``device`` in one call."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), generator=gen, device=device,
                         dtype=torch.uint8)


def host_batches(images: torch.Tensor, batch: int) -> List[torch.Tensor]:
    """Host copies of ``images`` in batches, pinned where CUDA is available, so
    each copy to the card is asynchronous."""
    out = []
    for i in range(0, images.shape[0], batch):
        host = images[i:i + batch].cpu()
        out.append(host.pin_memory() if torch.cuda.is_available() else host)
    return out


def yolo_targets(seed: int, n: int, S: int, B: int, C: int,
                 boxes_per_image: Sequence[int]) -> np.ndarray:
    """(n, S, S, B*5+C) float32 YOLO targets of random boxes: per image a
    count in ``boxes_per_image`` (inclusive), centres in (0.05, 0.95), sides
    in (0.05, 0.9), classes uniform. A cell holds the first box whose centre
    falls in it (slot 0: offsets in the cell, sides, confidence 1, one-hot class)."""
    rng = np.random.default_rng(seed)
    lo, hi = boxes_per_image
    out = np.zeros((n, S, S, B * 5 + C), np.float32)
    for k in range(n):
        for _ in range(int(rng.integers(lo, hi + 1))):
            cx, cy = rng.uniform(0.05, 0.95, size=2)
            w, h = rng.uniform(0.05, 0.9, size=2)
            cls = int(rng.integers(0, C))
            i, j = min(int(S * cy), S - 1), min(int(S * cx), S - 1)
            if out[k, i, j, 4] == 0:
                out[k, i, j, :5] = (S * cx - j, S * cy - i, w, h, 1.0)
                out[k, i, j, B * 5 + cls] = 1.0
    return out
