"""Batched decode of YOLO grid outputs into flat candidate lists, in torch.

Port of yolo_tpu/ops/decode.py. Semantics kept:

- absolute centers ``x = (j + x_cell) / S``, ``y = (i + y_cell) / S``;
- score = box confidence * max class probability; class = first argmax;
- strict ``score > threshold``, with the threshold rounded in the score
  dtype: when the rounded value lies above the true threshold (0.1 in
  float32), ``>=`` against it reproduces the float64 reference;
- flat candidate order (i, j, b) row-major, which the stable tie-breaking
  of NMS depends on.

The division by S: with the Python int ``S`` (serving), XLA multiplies by
the reciprocal 1/S, and torch divides truly on the CPU but multiplies by the
reciprocal on CUDA, so decoded centers may differ from the JAX ones by 1
ulp. ``s_divisor``, float(S) as a 0-dim tensor on the data's device (JAX's
traced scalar), makes both packages divide truly on every device: the
evaluator passes it, so its decode equals JAX's evaluator decode bit for bit.
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
    pred: torch.Tensor, S: int, B: int, C: int, conf_threshold: float,
    s_divisor: torch.Tensor | None = None,
) -> Detections:
    """Decode raw grid predictions (..., S, S, B*5+C) into flat detections.

    Returns Detections with K = S*S*B candidates per image, ordered (i, j, b).
    ``s_divisor``: float(S) as a 0-dim tensor on ``pred``'s device, for a
    true division on every device (the evaluator's decode); None divides by
    the int ``S`` (serving).
    """
    batch_shape = pred.shape[:-3]
    boxes_raw = pred[..., : B * 5].reshape(*batch_shape, S, S, B, 5)
    class_probs = pred[..., B * 5 :]

    div = S if s_divisor is None else s_divisor
    idx = torch.arange(S, dtype=pred.dtype, device=pred.device)
    x_abs = (idx[None, :, None] + boxes_raw[..., 0]) / div
    y_abs = (idx[:, None, None] + boxes_raw[..., 1]) / div
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


def decode_ground_truth(
    target: torch.Tensor, S: int, B: int, C: int, s_divisor: torch.Tensor | None = None
) -> Detections:
    """Decode YOLO targets (..., S, S, B*5+C) into flat ground-truth boxes.

    A cell holds an object iff its slot-0 confidence is > 0 (the target
    encoder writes slot 0 only). One GT per cell: K = S*S slots, ordered
    (i, j); ``scores`` is the slot-0 confidence. ``s_divisor`` as in
    :func:`decode_predictions`.
    """
    batch_shape = target.shape[:-3]
    div = S if s_divisor is None else s_divisor
    idx = torch.arange(S, dtype=target.dtype, device=target.device)
    x_abs = (idx[None, :] + target[..., 0]) / div
    y_abs = (idx[:, None] + target[..., 1]) / div

    K = S * S
    boxes = torch.stack([x_abs, y_abs, target[..., 2], target[..., 3]],
                        dim=-1).reshape(*batch_shape, K, 4)
    conf0 = target[..., 4]
    class_ids = torch.argmax(target[..., B * 5 :], dim=-1).reshape(*batch_shape, K)
    return Detections(boxes=boxes, scores=conf0.reshape(*batch_shape, K),
                      class_ids=class_ids.to(torch.int32),
                      valid=(conf0 > 0).reshape(*batch_shape, K))
