"""Batched decode of YOLO grid outputs into flat candidate lists, in torch.

Port of yolo_tpu/ops/decode.py. Semantics kept:

- absolute centers ``x = (j + x_cell) / S``, ``y = (i + y_cell) / S``;
- score = box confidence * max class probability; class = first argmax;
- strict ``score > threshold``, with the threshold rounded in the score
  dtype: when the rounded value lies above the true threshold (0.1 in
  float32), ``>=`` against it reproduces the float64 reference;
- flat candidate order (i, j, b) row-major, which the stable tie-breaking
  of NMS depends on.

The one difference: torch divides by S truly, where XLA rewrites a division
by the constant S into a multiply by its reciprocal, so decoded centers may
differ from the JAX ones by 1 ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    """Fixed-shape batched detections with a validity mask.

    Attributes:
        boxes: (..., K, 4) center-format absolute normalized boxes.
        scores: (..., K) final confidence (objectness * class prob).
        class_ids: (..., K) int32 argmax class per candidate.
        valid: (..., K) bool, True for candidates above the confidence
            threshold (and, after NMS, surviving suppression).
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    class_ids: torch.Tensor
    valid: torch.Tensor


def threshold_mask(scores: torch.Tensor, conf_threshold: float) -> torch.Tensor:
    """``scores > conf_threshold`` as the float64 reference decides it."""
    thr = torch.tensor(conf_threshold, dtype=scores.dtype).item()
    if thr > conf_threshold:  # threshold rounded UP in this dtype
        return scores >= thr
    return scores > thr


def decode_predictions(
    pred: torch.Tensor, S: int, B: int, C: int, conf_threshold: float
) -> Detections:
    """Decode raw grid predictions (..., S, S, B*5+C) into flat detections.

    Returns Detections with K = S*S*B candidates per image, ordered (i, j, b).
    """
    batch_shape = pred.shape[:-3]
    boxes_raw = pred[..., : B * 5].reshape(*batch_shape, S, S, B, 5)
    class_probs = pred[..., B * 5 :]

    idx = torch.arange(S, dtype=pred.dtype, device=pred.device)
    x_abs = (idx[None, :, None] + boxes_raw[..., 0]) / S
    y_abs = (idx[:, None, None] + boxes_raw[..., 1]) / S
    w = boxes_raw[..., 2]
    h = boxes_raw[..., 3]
    conf = boxes_raw[..., 4]

    class_id = torch.argmax(class_probs, dim=-1)  # first max wins, as in jnp
    class_prob = torch.amax(class_probs, dim=-1)
    score = conf * class_prob[..., None]

    K = S * S * B
    boxes = torch.stack([x_abs, y_abs, w, h], dim=-1).reshape(*batch_shape, K, 4)
    scores = score.reshape(*batch_shape, K)
    class_ids = (
        class_id[..., None]
        .expand(*class_id.shape, B)
        .reshape(*batch_shape, K)
        .to(torch.int32)
    )
    valid = threshold_mask(scores, conf_threshold)
    return Detections(boxes=boxes, scores=scores, class_ids=class_ids, valid=valid)
