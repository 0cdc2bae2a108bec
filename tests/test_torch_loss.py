"""The port's YOLO loss against JAX's ``yolo_loss`` on the same inputs.

Every case of tests/test_loss.py (golden components, the coordinate term and
lambda, the responsible box, batch division, no objects, ``sample_mask``)
plus seeded random grids. Both sides get the same float32 numpy arrays; the
total, the four parts and the gradient with respect to the predictions
(``jax.grad`` against autograd) must agree to rtol 1e-5: the two evaluate
the same float32 expressions in the same order, and differ only where XLA
and torch sum a reduction in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.ops.loss import yolo_loss as jax_loss
from yolo_tpu_torch.ops.loss import YOLOLoss, yolo_loss

KEYS = ("total", "coord", "conf_obj", "conf_noobj", "class")
RTOL = 1e-5


def _golden(S=2, B=2, C=3):
    """tests/test_loss.py::build_case: one object in cell (0, 0), a stray
    confidence in an empty cell."""
    D = B * 5 + C
    pred = np.zeros((1, S, S, D), np.float32)
    target = np.zeros((1, S, S, D), np.float32)
    target[0, 0, 0, 0:5] = [0.5, 0.5, 0.4, 0.4, 1.0]
    target[0, 0, 0, B * 5 + 1] = 1.0
    pred[0, 0, 0, 0:5] = [0.5, 0.5, 0.4, 0.4, 0.8]
    pred[0, 0, 0, 5:10] = [0.1, 0.1, 0.1, 0.1, 0.3]
    pred[0, 0, 0, B * 5:] = [0.2, 0.6, 0.1]
    pred[0, 1, 1, 4] = 0.5
    return pred, target


def _case(name):
    """(pred, target, mask, kwargs) for each case of tests/test_loss.py."""
    pred, target = _golden()
    if name == "golden":
        return pred, target, None, {}
    if name == "coord":
        pred[0, 0, 0, 0:4] = [0.6, 0.5, 0.3, 0.4]
        return pred, target, None, {}
    if name == "coord_lambda":
        pred[0, 0, 0, 0:4] = [0.6, 0.5, 0.3, 0.4]
        return pred, target, None, {"lambda_coord": 10.0}
    if name == "responsible":
        pred[0, 0, 0, 0:5] = [0.1, 0.1, 0.1, 0.1, 0.3]
        pred[0, 0, 0, 5:10] = [0.5, 0.5, 0.4, 0.4, 0.9]
        return pred, target, None, {}
    if name == "batch":
        return np.concatenate([pred, pred]), np.concatenate([target, target]), None, {}
    if name == "no_objects":
        r = np.random.default_rng(0)
        return (r.normal(size=(2, 2, 2, 13)).astype(np.float32),
                np.zeros((2, 2, 2, 13), np.float32), None, {})
    if name in ("mask", "mask_ones"):
        r = np.random.default_rng(3)
        full, n = 8, 3
        pred = r.normal(size=(full, 2, 2, 13)).astype(np.float32)
        target = np.zeros((full, 2, 2, 13), np.float32)
        target[:n, 0, 1, 0:5] = [0.4, 0.6, 0.2, 0.3, 1.0]
        target[:n, 0, 1, 12] = 1.0
        mask = np.arange(full) < (n if name == "mask" else full)
        return pred, target, mask, {}
    raise KeyError(name)


def _random(seed, n=4, S=7, B=2, C=20):
    """Seeded grids: positive w/h on most boxes, objects in ~30% of cells,
    some with the object's confidence in slot 1, near-ties of IoU."""
    r = np.random.default_rng(seed)
    D = B * 5 + C
    pred = r.normal(0.3, 0.4, size=(n, S, S, D)).astype(np.float32)
    target = np.zeros((n, S, S, D), np.float32)
    obj = r.uniform(size=(n, S, S)) < 0.3
    slot = r.integers(0, B, size=(n, S, S))
    box = r.uniform(0.05, 0.95, size=(n, S, S, 4)).astype(np.float32)
    for b in range(B):
        sel = obj & (slot == b)
        target[..., 5 * b: 5 * b + 4][sel] = box[sel]
        target[..., 5 * b + 4][sel] = 1.0
    cls = r.integers(0, C, size=(n, S, S))
    target[..., B * 5:] = np.eye(C, dtype=np.float32)[cls] * obj[..., None]
    pred[0, 0, 0, 5:10] = pred[0, 0, 0, 0:5]  # an exact IoU tie: the first box wins
    target[0, 0, 0, :5] = [0.5, 0.5, 0.3, 0.3, 1.0]
    return pred, target, None, {"S": S, "B": B, "C": C}


def _both(pred, target, mask, kw):
    S, B, C = kw.pop("S", 2), kw.pop("B", 2), kw.pop("C", 3)
    jmask = None if mask is None else jnp.asarray(mask)

    def jtotal(p):
        return jax_loss(p, jnp.asarray(target), S=S, B=B, C=C, sample_mask=jmask, **kw)

    (jt, jparts), jgrad = jax.value_and_grad(jtotal, has_aux=True)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    tt, tparts = yolo_loss(tp, torch.from_numpy(target), S=S, B=B, C=C, sample_mask=tmask, **kw)
    tt.backward()
    tparts = {k: float(v.detach()) for k, v in tparts.items()}
    return (jt, jparts, np.asarray(jgrad)), (float(tt.detach()), tparts, tp.grad.numpy())


def _assert_agree(ref, got):
    (jt, jparts, jgrad), (tt, tparts, tgrad) = ref, got
    assert set(tparts) == set(KEYS)
    np.testing.assert_allclose(float(tt), float(jt), rtol=RTOL, atol=1e-7)
    for k in KEYS:
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(tgrad, jgrad, rtol=RTOL, atol=1e-6 * np.abs(jgrad).max())


@pytest.mark.parametrize("name", ["golden", "coord", "coord_lambda", "responsible", "batch",
                                  "no_objects", "mask", "mask_ones"])
def test_loss_cases_match_jax(name):
    _assert_agree(*_both(*_case(name)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_grids_match_jax(seed):
    _assert_agree(*_both(*_random(seed)))


def test_masked_random_grid_matches_jax():
    pred, target, _, kw = _random(7, n=6)
    _assert_agree(*_both(pred, target, np.array([1, 1, 0, 1, 0, 0], bool), kw))


def test_wrapper_and_parts_stay_on_the_device_tensor():
    pred, target, _, _ = _case("golden")
    total, parts = YOLOLoss(S=2, B=2, C=3)(torch.from_numpy(pred), torch.from_numpy(target))
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in parts.values())
    assert float(total) == float(parts["total"])
    iou = YOLOLoss.compute_iou(torch.tensor([0.5, 0.5, 0.4, 0.4]), torch.tensor([0.5, 0.5, 0.4, 0.4]))
    np.testing.assert_allclose(float(iou), 0.16 / (0.16 + 1e-6), rtol=1e-6)
