"""The port's decode and NMS held against the JAX package on the same inputs.

Inputs are made with numpy from fixed seeds and handed to both sides. NMS
keep masks must be equal bit for bit: the port's sort-then-scan
``batched_nms``, the CUDA kernel's plain twin ``nms_reference`` and the
kernel wrapper ``cuda_nms.nms`` on CPU tensors, against JAX's
``batched_nms`` and (at its fixed eps 1e-6) ``pallas_nms`` in interpret
mode. Decode must give the same class ids and valid masks exactly, and boxes
and scores within rtol 1e-6: torch divides by S where XLA multiplies by 1/S.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.ops.decode import Detections as JDetections
from yolo_tpu.ops.decode import decode_predictions as j_decode
from yolo_tpu.ops.nms import batched_nms as j_batched_nms
from yolo_tpu.ops.pallas_nms import pallas_nms
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.boxes import iou_pairwise
from yolo_tpu_torch.ops.decode import Detections, decode_predictions
from yolo_tpu_torch.ops.nms import batched_nms
from yolo_tpu_torch.utils import kernels

S, B, C = 7, 2, 20


def _grid(cells, s=S):
    """(1, s, s, B*5+C) grid; cells: {(i, j): [(box5, class_id)]}."""
    pred = np.zeros((1, s, s, B * 5 + C), np.float32)
    for (i, j), entries in cells.items():
        for b, (box5, cid) in enumerate(entries):
            pred[0, i, j, b * 5 : b * 5 + 5] = box5
            pred[0, i, j, B * 5 + cid] = 1.0
    return pred


def _decoded(pred, s, thr):
    """Decode with JAX; the NMS cases then share these exact float32 inputs."""
    d = j_decode(jnp.asarray(pred), s, B, C, thr)
    return tuple(np.asarray(x) for x in d)


def _explicit(boxes, scores, class_ids, valid=None):
    boxes = np.asarray(boxes, np.float32)[None]
    scores = np.asarray(scores, np.float32)[None]
    class_ids = np.asarray(class_ids, np.int32)[None]
    valid = np.ones(scores.shape, bool) if valid is None else np.asarray(valid, bool)[None]
    return boxes, scores, class_ids, valid


def _tie_storm(seed, n=6, K=98):
    """Few distinct scores (with both signed zeros), few distinct boxes, 2 classes."""
    r = np.random.default_rng(seed)
    palette = r.uniform(0.2, 0.8, size=(5, 4)).astype(np.float32)
    palette[:, 2:] *= 0.6
    boxes = palette[r.integers(0, 5, size=(n, K))]
    levels = np.array([0.0, -0.0, 0.5, 0.5, 0.75], np.float32)
    scores = levels[r.integers(0, 5, size=(n, K))]
    class_ids = r.integers(0, 2, size=(n, K)).astype(np.int32)
    valid = r.uniform(size=(n, K)) < 0.8
    valid[-1] = False  # an all-invalid row
    return boxes, scores, class_ids, valid


def _exact_iou_half():
    # inter 0.5, union 1.0: IoU exactly 0.5 at eps 0, just below it at 1e-6.
    # The last two boxes are degenerate (zero area): union == 0.
    return _explicit(
        [[0.5, 0.5, 1.0, 1.0], [0.5, 0.25, 1.0, 0.5], [0.2, 0.2, 0.0, 0.0],
         [0.2, 0.2, 0.0, 0.0]],
        [0.9, 0.8, 0.7, 0.6], [1, 1, 2, 2],
    )


CASES = {
    "same_class_overlap": lambda: _explicit(
        [[0.5, 0.5, 0.2, 0.2], [0.51, 0.5, 0.2, 0.2], [0.9, 0.9, 0.1, 0.1]],
        [0.9, 0.8, 0.7], [3, 3, 3]),
    "different_classes": lambda: _explicit(
        [[0.5, 0.5, 0.2, 0.2], [0.5, 0.5, 0.2, 0.2]], [0.9, 0.8], [3, 4]),
    "invalid_never_suppresses": lambda: _explicit(
        [[0.5, 0.5, 0.2, 0.2], [0.5, 0.5, 0.2, 0.2]], [0.9, 0.8], [3, 3],
        [False, True]),
    "chain_release": lambda: _explicit(
        [[0.50, 0.5, 0.20, 0.2], [0.58, 0.5, 0.20, 0.2], [0.66, 0.5, 0.20, 0.2]],
        [0.9, 0.8, 0.7], [0, 0, 0]),
    "empty": lambda: _explicit(np.zeros((4, 4)), np.zeros(4), np.zeros(4), np.zeros(4)),
    "pipeline_from_grid": lambda: _decoded(_grid({
        (3, 3): [((0.9, 0.5, 0.3, 0.3, 0.9), 2)],
        (3, 4): [((0.0, 0.5, 0.3, 0.3, 0.8), 2)]}), S, 0.5),
    "random_k98": lambda: _decoded(
        np.random.default_rng(7).uniform(0, 1, size=(4, 7, 7, 30)).astype(np.float32),
        7, 0.3),
    "random_k162": lambda: _decoded(
        np.random.default_rng(11).uniform(0, 1, size=(3, 9, 9, 30)).astype(np.float32),
        9, 0.3),
    "tie_storm_k98": lambda: _tie_storm(3),
    "tie_storm_k162": lambda: _tie_storm(5, K=162),
    "exact_iou_half": _exact_iou_half,
}


def _port_masks(arrays, t, eps):
    boxes, scores, class_ids, valid = (torch.from_numpy(np.array(a)) for a in arrays)
    dets = Detections(boxes, scores, class_ids, valid)
    n, K = scores.shape
    return {
        "port batched_nms": batched_nms(dets, t, eps=eps).valid.numpy(),
        "kernel twin": cuda_nms.nms_reference(
            boxes, scores, class_ids, valid, float(np.float32(t)), float(np.float32(eps))
        ).numpy(),
        "cuda_nms.nms (cpu)": cuda_nms.nms(dets, t, eps=eps).valid.numpy(),
    }


@pytest.mark.parametrize("eps", [1e-6, 0.0])
@pytest.mark.parametrize("t", [0.4, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_keep_masks_equal_jax(case, t, eps):
    arrays = CASES[case]()
    jd = JDetections(*(jnp.asarray(a) for a in arrays))
    ref = np.asarray(j_batched_nms(jd, t, eps=eps).valid)
    for name, got in _port_masks(arrays, t, eps).items():
        np.testing.assert_array_equal(got, ref, err_msg=f"{name} vs JAX batched_nms")
    if eps == 1e-6:
        pal = np.asarray(pallas_nms(jd, t, interpret=True).valid)
        np.testing.assert_array_equal(pal, ref, err_msg="pallas vs JAX batched_nms")


def _iou_just_above_0_4():
    # IoU 0.4000000000000001 in float64: >= 0.4, but < float32(0.4).
    boxes, scores, class_ids, valid = _explicit(
        [[0.5, 0.5, 1.0, 1.0], [0.5, 0.2, 1.0, 0.4]], [0.9, 0.8], [1, 1])
    return boxes.astype(np.float64), scores.astype(np.float64), class_ids, valid


CASES_F64 = {**CASES, "iou_just_above_0_4": _iou_just_above_0_4}


@pytest.mark.parametrize("eps", [1e-6, 0.0])
@pytest.mark.parametrize("t", [0.4, 0.5])
@pytest.mark.parametrize("case", sorted(CASES_F64))
def test_nms_float64_keep_masks_equal_jax_x64(case, t, eps):
    """The precise evaluator's NMS: the port on float64 tensors (threshold
    and eps kept as float64) against JAX's batched_nms under x64."""
    arrays = [np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a
              for a in CASES_F64[case]()]
    with jax.enable_x64(True):
        jd = JDetections(*(jnp.asarray(a) for a in arrays))
        ref = np.asarray(j_batched_nms(jd, t, eps=eps).valid)
    boxes, scores, class_ids, valid = (torch.from_numpy(np.array(a)) for a in arrays)
    dets = Detections(boxes, scores, class_ids, valid)
    np.testing.assert_array_equal(batched_nms(dets, t, eps=eps).valid.numpy(), ref)
    np.testing.assert_array_equal(cuda_nms.nms(dets, t, eps=eps).valid.numpy(), ref)
    if case == "iou_just_above_0_4":
        # The threshold is not rounded to float32: at eps 0 the second box
        # goes at 0.4.
        assert ref[0].tolist() == [True, not (t == 0.4 and eps == 0.0)]


def test_nms_cases_do_real_work():
    """The cases suppress something and keep something, so equality means a lot."""
    kept = total = 0
    for make in CASES.values():
        arrays = make()
        keep = _port_masks(arrays, 0.4, 1e-6)["kernel twin"]
        kept += int(keep.sum())
        total += int(arrays[3].sum())
    assert 0 < kept < total
    # eps decides the exactly-0.5 pair: suppressed at eps 0, kept at 1e-6.
    arrays = _exact_iou_half()
    assert _port_masks(arrays, 0.5, 0.0)["kernel twin"][0].tolist() == [True, False, True, True]
    assert _port_masks(arrays, 0.5, 1e-6)["kernel twin"][0].tolist() == [True, True, True, True]


def test_nms_wrapper_checks_inputs():
    boxes, scores, class_ids, valid = (torch.from_numpy(a) for a in _tie_storm(1))
    good = Detections(boxes, scores, class_ids, valid)
    with pytest.raises(TypeError):
        cuda_nms.nms(good._replace(scores=scores.double()))
    with pytest.raises(TypeError):
        cuda_nms.nms(good._replace(class_ids=class_ids.long()))
    with pytest.raises(TypeError):
        cuda_nms.nms(good._replace(boxes=boxes.half(), scores=scores.half()))
    with pytest.raises(ValueError):
        cuda_nms.nms(good._replace(boxes=boxes[:, :-1]))
    with pytest.raises(ValueError):
        cuda_nms.nms(good._replace(boxes=boxes.transpose(0, 1).contiguous().transpose(0, 1)))
    before = kernels.LAUNCHES["yolo_nms"]
    cuda_nms.nms(good)
    assert kernels.LAUNCHES["yolo_nms"] == before  # the CPU path launches nothing


def test_iou_pairwise_matches_jax():
    from yolo_tpu.ops.boxes import iou_pairwise as j_iou

    r = np.random.default_rng(2)
    boxes = r.uniform(0.1, 0.9, size=(2, 12, 4)).astype(np.float32)
    boxes[0, 3] = 0.0
    for eps in (1e-6, 0.0):
        ref = np.asarray(j_iou(jnp.asarray(boxes), jnp.asarray(boxes), eps=eps))
        got = iou_pairwise(torch.from_numpy(boxes), torch.from_numpy(boxes), eps=eps)
        np.testing.assert_array_equal(got.numpy(), ref)


DECODE_CASES = {
    "random_k98_thr03": (
        lambda: np.random.default_rng(0).uniform(-0.2, 1, size=(3, 7, 7, 30)), 7, 0.3),
    "random_k162_thr05": (
        lambda: np.random.default_rng(1).uniform(0, 1, size=(2, 9, 9, 30)), 9, 0.5),
    # 0.1 rounds UP in float32: a score equal to float32(0.1) counts as above.
    "threshold_rounding_0p1": (
        lambda: _grid({(0, 0): [((0.5, 0.5, 0.2, 0.2, 0.1), 1)],
                       (2, 3): [((0.5, 0.5, 0.2, 0.3, 0.8), 5)]}), 7, 0.1),
    "threshold_strict_0p5": (
        lambda: _grid({(0, 0): [((0.5, 0.5, 0.2, 0.2, 0.5), 1)]}), 7, 0.5),
    "class_argmax_ties": (
        lambda: np.round(np.random.default_rng(4).uniform(0, 1, size=(2, 7, 7, 30)), 1),
        7, 0.2),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_jax(case):
    make, s, thr = DECODE_CASES[case]
    pred = make().astype(np.float32)
    ref = j_decode(jnp.asarray(pred), s, B, C, thr)
    got = decode_predictions(torch.from_numpy(pred), s, B, C, thr)
    np.testing.assert_array_equal(got.class_ids.numpy(), np.asarray(ref.class_ids))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=1e-6, atol=0)
    assert got.class_ids.dtype == torch.int32 and got.valid.dtype == torch.bool
    if case == "threshold_rounding_0p1":
        assert int(got.valid.sum()) == 2
