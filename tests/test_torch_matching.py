"""The evaluator's decodes and greedy matcher, held against the JAX package.

Both decodes with ``s_divisor`` (JAX's traced scalar; a 0-dim tensor in the
port) divide truly, so decoded boxes, scores, classes and masks are equal
bit for bit in float32 and float64, as is ``decode_ground_truth``. The
matcher (a ``lax.scan`` in JAX, a first-claim scatter in the port) must
give the same TP flags and sorted arrays on random boxes, tied IoUs, rows
with no same-class GT, duplicates, IoUs exactly on a threshold and tied
scores, in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.ops import boxes as jboxes
from yolo_tpu.ops.decode import decode_ground_truth as j_decode_gt
from yolo_tpu.ops.decode import decode_predictions as j_decode
from yolo_tpu.ops.matching import match_detections as j_match
from yolo_tpu.ops.matching import match_detections_masked as j_match_masked
from yolo_tpu_torch.ops import matching
from yolo_tpu_torch.ops.boxes import corners_to_center
from yolo_tpu_torch.ops.decode import decode_ground_truth, decode_predictions

S, B, C = 7, 2, 20
D = B * 5 + C
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "float64": (np.float64, torch.float64, jnp.float64)}
THRESHOLDS = [0.5 + 0.05 * i for i in range(10)]


def _grid(seed, n, dtype):
    r = np.random.default_rng(seed)
    g = r.uniform(0, 1, (n, S, S, D)).astype(dtype)
    g[..., 10:] = r.uniform(0, 1, (n, S, S, C)) ** 4
    g[0, 2, 3, 10:13] = 0.5  # a class tie: the first maximum wins
    return g


def _equal(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decodes_with_s_divisor_equal_jax_bit_for_bit(dtype):
    np_t, t_t, j_t = DTYPES[dtype]
    pred, target = _grid(0, 3, np_t), _grid(1, 3, np_t)
    target[..., 4] = np.where(target[..., 4] > 0.6, 1.0, 0.0)
    with jax.enable_x64(dtype == "float64"):
        j_div = jnp.asarray(float(S), j_t)
        ref = jax.jit(lambda p, d: j_decode(p, S, B, C, 0.1, s_divisor=d))(pred, j_div)
        ref_gt = jax.jit(lambda t, d: j_decode_gt(t, S, B, C, s_divisor=d))(target, j_div)
        ref = jax.device_get(ref)
        ref_gt = jax.device_get(ref_gt)
    div = torch.tensor(float(S), dtype=t_t)
    got = decode_predictions(torch.from_numpy(pred), S, B, C, 0.1, s_divisor=div)
    got_gt = decode_ground_truth(torch.from_numpy(target), S, B, C, s_divisor=div)
    for a, b in zip(got, ref):
        _equal(a, b)
    for a, b in zip(got_gt, ref_gt):
        _equal(a, b)
    assert 0 < int(got_gt.valid.sum()) < got_gt.valid.numel()
    # The true division differs from a multiply by 1/S on some centers.
    recip = (torch.arange(S, dtype=t_t)[None, :, None] + torch.from_numpy(pred)[..., 0:10:5]) \
        * (1 / S)
    true = got.boxes[..., 0].reshape(3, S, S, B)
    assert bool((recip != true).any())


def test_decode_without_s_divisor_is_unchanged():
    pred = torch.from_numpy(_grid(2, 2, np.float32))
    a = decode_predictions(pred, S, B, C, 0.1)
    b = decode_predictions(pred, S, B, C, 0.1, s_divisor=torch.tensor(float(S)))
    for x, y in zip(a, b):  # a true division on the CPU either way
        assert torch.equal(x, y)


def test_corners_to_center_matches_jax():
    r = np.random.default_rng(3)
    corners = r.uniform(0, 1, (5, 7, 4)).astype(np.float32)
    _equal(corners_to_center(torch.from_numpy(corners)),
           jboxes.corners_to_center(jnp.asarray(corners)))


def _boxes(r, n, k):
    b = r.uniform(0.1, 0.9, (n, k, 4))
    b[..., 2:] = r.uniform(0.05, 0.5, (n, k, 2))
    return b


def _case(kind, seed, n=3, K=98, G=49):
    """(pred_boxes, scores, classes, valid, gt_boxes, gt_class, masks) in float64."""
    r = np.random.default_rng(seed)
    pb, gb = _boxes(r, n, K), _boxes(r, n, G)
    ps = r.uniform(0, 1, (n, K))
    pc = r.integers(0, 4, (n, K)).astype(np.int32)
    gc = r.integers(0, 4, (n, G)).astype(np.int32)
    pv = r.uniform(size=(n, K)) < 0.7
    gv = r.uniform(size=(n, G)) < 0.4
    if kind == "duplicates":  # every prediction one of a few boxes, on GTs
        idx = r.integers(0, 4, (n, K))
        pb = np.take_along_axis(gb, idx[..., None].repeat(4, axis=2), axis=1)
        pc = np.take_along_axis(gc, idx, axis=1)
        gv[:, :4] = True
    elif kind == "tied_iou":  # two identical valid GTs of a class: first wins
        gb[:, 1], gc[:, 1], gv[:, :2] = gb[:, 0], gc[:, 0], True
        pb[:, :10], pc[:, :10] = gb[:, :1], gc[:, :1]
        ps[:, :10] = 0.5  # tied scores: stable order
    elif kind == "no_gt_rows":  # classes no GT has: all-zero IoU rows
        pc[:] = 7
    elif kind == "on_threshold":  # IoU exactly 0.5 / 0.75 / 1 against GT 0
        gb[:, 0], gc[:, 0], gv[:, 0] = [0.5, 0.5, 0.5, 0.5], 1, True
        for k, w in enumerate((0.25, 0.375, 0.5, 0.25)):
            pb[:, k], pc[:, k], pv[:, k] = [0.5, 0.5, w, 0.5], 1, True
        ps[:, :4], ps[:, 4:] = [0.9, 0.8, 0.7, 0.95], ps[:, 4:] * 0.5
        gc[:, 1:] = np.where(gc[:, 1:] == 1, 2, gc[:, 1:])  # GT 0 is class 1's only GT
    masks = np.stack([gv, gv & (gb[..., 2] < 0.3), gv & (gb[..., 2] >= 0.3)])
    return pb, ps, pc, pv, gb, gc, masks


KINDS = ["random", "duplicates", "tied_iou", "no_gt_rows", "on_threshold"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_match_detections_masked_equals_jax(kind, dtype):
    np_t, t_t, j_t = DTYPES[dtype]
    pb, ps, pc, pv, gb, gc, masks = _case(kind, KINDS.index(kind))
    pb, ps, gb = pb.astype(np_t), ps.astype(np_t), gb.astype(np_t)
    thr = np.asarray(THRESHOLDS, np_t)
    with jax.enable_x64(dtype == "float64"):
        ref = jax.device_get(j_match_masked(pb, ps, pc, pv, gb, gc, masks, thr))
    got = matching.match_detections_masked(*map(torch.from_numpy, (pb, ps, pc, pv, gb, gc,
                                                                   masks, thr)))
    assert got[0].shape == (3, 3, 10, 98)
    for a, b in zip(got, ref):
        _equal(a, b)
    tp, fp = got[0].numpy(), ~got[0].numpy() & got[3].numpy()[:, None, None]
    assert fp.any() and tp.any() == (kind != "no_gt_rows")
    if kind == "on_threshold":
        # Sorted: IoU 0.5 (0.95), 0.5 (0.9), 0.75 (0.8), 1 (0.7). IoU 0.5 is a
        # TP at 0.5 only, 0.75 claims the GT at 0.55-0.75, 1 at 0.8-0.95.
        want = np.zeros((4, 10), bool)
        want[0, 0], want[2, 1:6], want[3, 6:] = True, True, True
        for image in tp[:, 0]:
            np.testing.assert_array_equal(image[:, :4].T, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_match_detections_single_mask_equals_jax(dtype):
    np_t, t_t, j_t = DTYPES[dtype]
    pb, ps, pc, pv, gb, gc, masks = _case("random", 11)
    pb, ps, gb = pb.astype(np_t), ps.astype(np_t), gb.astype(np_t)
    thr = np.asarray([0.5], np_t)
    with jax.enable_x64(dtype == "float64"):
        ref = jax.device_get(j_match(pb, ps, pc, pv, gb, gc, masks[0], thr))
    got = matching.match_detections(*map(torch.from_numpy, (pb, ps, pc, pv, gb, gc,
                                                            masks[0], thr)))
    for a, b in zip(got, ref):
        _equal(a, b)


def test_match_single_threshold_is_the_scan():
    """``_match_single_threshold`` against the scan written out step by step."""
    r = np.random.default_rng(5)
    for trial in range(20):
        iou = r.choice([0.0, 0.3, 0.5, 0.5, 0.7, 1.0], size=(40, 6))
        valid = r.uniform(size=40) < 0.8
        taken = np.zeros(6, bool)
        want = np.zeros(40, bool)
        for k in range(40):
            g = int(np.argmax(iou[k]))
            want[k] = valid[k] and iou[k, g] >= 0.5 and not taken[g]
            taken[g] |= want[k]
        got = matching._match_single_threshold(torch.from_numpy(iou), torch.from_numpy(valid),
                                               0.5)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"trial {trial}")
