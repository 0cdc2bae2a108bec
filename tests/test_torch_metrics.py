"""The port's mAP evaluator held against the JAX package's, key for key.

``mAPMetric`` on the same inputs must give all 77 keys equal (``==``) to
JAX's: ``precise=True`` (float64 where the predictions lie) against JAX's
precise path, ``precise=False`` (float32) against JAX's fast path; here on
the CPU, NMS through the kernel's plain twin. The per-batch
arrays (TP flags, sorted scores, classes, masks) must be equal too. Every
case of tests/test_metrics.py that needs no mesh has a counterpart here,
run on both packages and both paths; then ``evaluate_model`` on a small
ResNet with the weights carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import eval_batches, eval_grids, exact_iou_grids
from yolo_tpu.metrics import evaluate_model as j_evaluate_model
from yolo_tpu.metrics import mAPMetric as JMetric
from yolo_tpu_torch.metrics import evaluate_model, mAPMetric
from yolo_tpu_torch.metrics import map as port_map

S, B, C = 7, 2, 20
D = B * 5 + C
PATHS = [pytest.param(True, id="precise"), pytest.param(False, id="fast")]


def make_pair(cells, conf=0.9):
    """Matched (pred, target) grids: perfect detections in ``cells``."""
    pred = np.zeros((1, S, S, D), np.float32)
    target = np.zeros((1, S, S, D), np.float32)
    for (i, j), (box, cid) in cells.items():
        target[0, i, j, 0:5] = list(box) + [1.0]
        target[0, i, j, B * 5 + cid] = 1.0
        pred[0, i, j, 0:5] = list(box) + [conf]
        pred[0, i, j, B * 5 + cid] = 1.0
    return pred, target


def both(precise, batches, **kwargs):
    """(port results, JAX results, port metric, JAX metric) over ``batches``
    of (pred, target[, sample_mask])."""
    port = mAPMetric(num_classes=C, precise=precise, **kwargs)
    ref = JMetric(num_classes=C, precise=precise, **kwargs)
    for batch in batches:
        port.update(*batch)
        ref.update(*batch)
    return port.compute(), ref.compute(), port, ref


def assert_same(got, ref, port=None, jmetric=None):
    assert got.keys() == ref.keys()
    bad = {k: (got[k], ref[k]) for k in ref if got[k] != ref[k]}
    assert not bad, bad
    if port is not None:
        assert len(port._chunks) == len(jmetric._chunks)
        for a, b in zip(port._chunks, jmetric._chunks):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -------------------------------------------------- tests/test_metrics.py cases
def test_init_and_reset():
    for metric in (mAPMetric(num_classes=C), JMetric(num_classes=C)):
        assert metric.iou_thresholds == JMetric(num_classes=C).iou_thresholds
        assert len(metric.iou_thresholds) == 10 and metric.iou_thresholds[0] == 0.5
        pred, target = make_pair({(3, 3): ((0.5, 0.5, 0.3, 0.3), 0)})
        metric.update(pred, target)
        assert len(metric._chunks) == 1
        metric.reset()
        assert len(metric._chunks) == 0


@pytest.mark.parametrize("precise", PATHS)
def test_scalar_threshold_accepted(precise):
    assert mAPMetric(num_classes=C, iou_thresholds=0.5).iou_thresholds == [0.5]
    pred, target = make_pair({(3, 3): ((0.5, 0.5, 0.3, 0.3), 0)})
    got, ref, port, jm = both(precise, [(pred, target)], iou_thresholds=0.5)
    assert_same(got, ref, port, jm)
    assert "AP75_class_0" not in got and "mAP75" not in got
    assert got["AP50_class_0"] == pytest.approx(1.0, abs=1e-6)


def test_empty_compute():
    got, ref = mAPMetric(num_classes=C).compute(), JMetric(num_classes=C).compute()
    assert_same(got, ref)
    assert got["mAP50:95"] == 0.0 and got["recall"] == 0.0


@pytest.mark.parametrize("precise", PATHS)
def test_perfect_predictions(precise):
    pred, target = make_pair({(1, 1): ((0.5, 0.5, 0.3, 0.3), 2),
                              (5, 5): ((0.5, 0.5, 0.25, 0.4), 7)})
    got, ref, port, jm = both(precise, [(pred, target)])
    assert_same(got, ref, port, jm)
    assert got["AP50_class_2"] == pytest.approx(1.0, abs=1e-6)
    assert got["AP50:95_class_7"] == pytest.approx(1.0, abs=1e-6)
    assert got["mAP50"] == pytest.approx(2 / 20, abs=1e-6)
    assert got["precision"] == pytest.approx(1.0, abs=1e-4)
    assert got["recall"] == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("precise", PATHS)
def test_result_key_schema(precise):
    pred, target = make_pair({(3, 3): ((0.5, 0.5, 0.3, 0.3), 0)})
    got, ref, port, jm = both(precise, [(pred, target)])
    assert_same(got, ref, port, jm)
    assert len(got) == 77
    for c in range(C):
        assert {f"AP50_class_{c}", f"AP75_class_{c}", f"AP50:95_class_{c}"} <= set(got)
    for size in ("small", "medium", "large"):
        assert {f"mAP50:95_{size}", f"mAP50_{size}", f"mAP75_{size}",
                f"num_{size}_objects"} <= set(got)


@pytest.mark.parametrize("precise", PATHS)
def test_no_predictions_zero_recall(precise):
    _, target = make_pair({(3, 3): ((0.5, 0.5, 0.3, 0.3), 4)})
    got, ref, port, jm = both(precise, [(np.zeros((1, S, S, D), np.float32), target)])
    assert_same(got, ref, port, jm)
    assert got["recall"] == 0.0 and got["AP50_class_4"] == 0.0


@pytest.mark.parametrize("precise", PATHS)
def test_localization_error_fails_high_iou(precise):
    pred, target = make_pair({(3, 3): ((0.5, 0.5, 0.4, 0.4), 0)})
    pred[0, 3, 3, 0] = 0.5 + 0.7
    got, ref, port, jm = both(precise, [(pred, target)])
    assert_same(got, ref, port, jm)
    assert got["AP50_class_0"] > 0.9
    assert got["AP75_class_0"] < got["AP50_class_0"] + 1e-9


@pytest.mark.parametrize("precise", PATHS)
def test_duplicate_detection_is_fp(precise):
    target = np.zeros((1, S, S, D), np.float32)
    target[0, 3, 3, 0:5] = [0.5, 0.5, 0.3, 0.3, 1.0]
    target[0, 3, 3, B * 5 + 0] = 1.0
    pred = np.zeros((1, S, S, D), np.float32)
    pred[0, 3, 3, 0:5] = [0.5, 0.5, 0.3, 0.3, 0.9]
    pred[0, 3, 3, 5:10] = [0.5, 0.5, 0.3, 0.3, 0.7]
    pred[0, 3, 3, B * 5 + 0] = 1.0
    got, ref, port, jm = both(precise, [(pred, target)], iou_thresholds=0.5,
                              nms_threshold=1.1)
    assert_same(got, ref, port, jm)
    assert got["precision"] == pytest.approx(0.5, abs=1e-4)
    assert got["recall"] == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("precise", PATHS)
def test_size_buckets(precise):
    pred, target = make_pair({(1, 1): ((0.5, 0.5, 0.7, 0.7), 0),
                              (3, 3): ((0.5, 0.5, 0.1, 0.1), 1),
                              (5, 5): ((0.5, 0.5, 0.05, 0.04), 2)})
    got, ref, port, jm = both(precise, [(pred, target)])
    assert_same(got, ref, port, jm)
    assert (got["num_large_objects"], got["num_medium_objects"],
            got["num_small_objects"]) == (1, 1, 1)
    assert got["mAP50_large"] == pytest.approx(1 / 20, abs=1e-6)
    assert got["mAP50_medium"] == pytest.approx(1 / 20, abs=1e-6)


@pytest.mark.parametrize("precise", PATHS)
def test_multi_batch_accumulation(precise):
    pred1, target1 = make_pair({(1, 1): ((0.5, 0.5, 0.3, 0.3), 0)}, conf=0.9)
    pred2 = np.zeros((1, S, S, D), np.float32)
    pred2[0, 2, 2, 0:5] = [0.5, 0.5, 0.3, 0.3, 0.5]
    pred2[0, 2, 2, B * 5 + 0] = 1.0
    target2 = np.zeros((1, S, S, D), np.float32)
    got, ref, port, jm = both(precise, [(pred1, target1), (pred2, target2)],
                              iou_thresholds=0.5)
    assert_same(got, ref, port, jm)
    assert got["AP50_class_0"] == pytest.approx(1.0, abs=1e-6)
    assert got["precision"] == pytest.approx(0.5, abs=1e-4)


# ------------------------------------------------------ seeded and constructed
@pytest.mark.parametrize("precise", PATHS)
@pytest.mark.parametrize("nms", [0.4, 1.1])
def test_all_keys_equal_jax_over_batches(precise, nms):
    """chip_smoke's parity batches (two seeded, the exact-IoU one, and a
    ragged batch of 5 padded to 8 and masked; phase 24 holds the card's fast
    path against the CPU's on them): per-batch arrays and all 77 keys equal
    JAX's."""
    got, ref, port, jm = both(precise, eval_batches(), nms_threshold=nms)
    assert_same(got, ref, port, jm)
    assert len(got) == 77 and 0.05 < got["mAP50"] < 0.95 and got["mAP75"] < got["mAP50"]
    assert port._chunks[-1]["scores"].shape[0] == 5
    assert min(got[f"num_{s}_objects"] for s in ("small", "medium", "large")) > 0


@pytest.mark.parametrize("precise", PATHS)
def test_exact_iou_ties_are_tps(precise):
    """IoU exactly 0.5 and 0.75 count at those thresholds on both paths."""
    got, ref, port, jm = both(precise, [exact_iou_grids()], nms_threshold=1.1)
    assert_same(got, ref, port, jm)
    tp = port._chunks[0]["tp_all"]  # (2, 10, 98), sorted by score
    # Image 0: IoU 0.5 (0.9) then IoU 0.75 (0.8).
    np.testing.assert_array_equal(tp[0, :, 0], [True] + [False] * 9)
    np.testing.assert_array_equal(tp[0, :, 1], [False] + [True] * 5 + [False] * 4)


def test_cpu_tensors_and_numpy_give_the_same_keys():
    pred, target = eval_grids(3, 4)
    a = mAPMetric(num_classes=C, precise=False)
    a.update(torch.from_numpy(pred), torch.from_numpy(target),
             sample_mask=torch.tensor([True, True, False, True]))
    b = mAPMetric(num_classes=C, precise=False)
    b.update(pred, target, sample_mask=np.array([True, True, False, True]))
    assert a.compute() == b.compute()


# ------------------------------------------------------------ the slice itself
class FakeLoader:
    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def small_models():
    """JAX's and the port's (1, 1, 1, 1) ResNet YOLOv1 at 64x64, one set of
    weights (test_torch_inference's randomize: random BN, fc2 scaled)."""
    from test_torch_inference import SIZE, STAGES, randomize
    from yolo_tpu.models import ResNetBackbone as JResNet
    from yolo_tpu.models import YOLOv1 as JYOLOv1
    from yolo_tpu.models import init_model
    from yolo_tpu_torch.convert import state_dict_from_jax
    from yolo_tpu_torch.models import create_model

    model = JYOLOv1(num_classes=C, S=S, B=B, backbone=JResNet(stage_sizes=STAGES))
    variables = randomize(init_model(model, jax.random.PRNGKey(0), image_size=SIZE))
    port = create_model("resnet", C, S, B, device="cpu", stage_sizes=STAGES, image_size=SIZE)
    port.load_state_dict(state_dict_from_jax(variables))
    return model, variables, port, SIZE


def slice_batches(size, dtype, n=11, batch=4):
    """Seeded images (float32 normalized-range or uint8) and targets in
    batches of 4, the last ragged (3)."""
    r = np.random.default_rng(17)
    if dtype == "uint8":
        images = r.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    else:
        images = r.normal(0, 1, (n, size, size, 3)).astype(np.float32)
    _, targets = eval_grids(18, n)
    return [(images[i:i + batch], targets[i:i + batch]) for i in range(0, n, batch)]


@pytest.mark.parametrize("precise", PATHS)
def test_evaluate_model_with_jax_grids_equals_jax(small_models, precise):
    """The port's evaluate_model fed JAX's forward (``forward_fn``) gives all
    77 keys equal to JAX's evaluate_model, ragged last batch included."""
    model, variables, _, size = small_models
    loader = FakeLoader(slice_batches(size, "float32"), batch_size=4)
    apply = jax.jit(lambda x: model.apply(variables, x, train=False))
    calls = []

    def forward_fn(images):
        calls.append(images.shape[0])
        return torch.from_numpy(np.array(apply(images.numpy())))

    ref = j_evaluate_model(model, variables, loader, num_classes=C, S=S, B=B, verbose=False,
                           precise=precise)
    got = evaluate_model(None, loader, num_classes=C, S=S, B=B, verbose=False, device="cpu",
                         forward_fn=forward_fn, precise=precise)
    assert calls == [4, 4, 4]  # the ragged batch is padded to the loader's batch
    assert_same(got, ref)
    assert got["mAP50"] > 0


# The port's float32 forward agrees with JAX's to 1e-4 * max|grid| + 1e-5
# (test_torch_models.py), which moves a decision only where a score, an IoU
# or a score order lies within that of a threshold; these seeded inputs have
# none there, and the keys must then agree to 1e-6.
KEY_TOL = 1e-6


@pytest.mark.parametrize("precise", PATHS)
def test_evaluate_model_port_forward_matches_jax(small_models, precise):
    model, variables, port, size = small_models
    loader = FakeLoader(slice_batches(size, "uint8"), batch_size=4)
    ref = j_evaluate_model(model, variables, loader, num_classes=C, S=S, B=B, verbose=False,
                           precise=precise)
    got = evaluate_model(port, loader, num_classes=C, S=S, B=B, verbose=False,
                         precise=precise)
    assert got.keys() == ref.keys() and len(got) == 77
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=KEY_TOL), k
    assert got["mAP50"] > 0


@pytest.mark.parametrize("forward", ["jax_grid", "port"])
def test_trainer_validate_compute_map_matches_jax_trainer(small_models, monkeypatch, forward):
    """``Trainer.validate(compute_map=True)`` against JAX's on the same
    weights and loader (batches of 4, the last ragged): the same keys, the
    losses to rtol 1e-4 (test_torch_training's tolerance), and the mAP keys
    ``==`` JAX's where the port's evaluator is fed JAX's grid, within
    KEY_TOL with the port's own forward."""
    import optax

    from yolo_tpu.training import Trainer as JTrainer
    from yolo_tpu.training.trainer import TrainState
    from yolo_tpu_torch.training import trainer as port_trainer
    from yolo_tpu_torch.training.optim import make_optimizer

    model, variables, port, size = small_models
    loader = FakeLoader(slice_batches(size, "float32"), batch_size=4)
    tx = optax.sgd(0.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(0))
    ref = JTrainer(model, tx).validate(state, loader, compute_map=True)

    if forward == "jax_grid":
        apply = jax.jit(lambda x: model.apply(variables, x, train=False))
        evaluate = port_trainer.evaluate_model

        def with_jax_grid(*args, **kwargs):
            return evaluate(*args, **kwargs, forward_fn=lambda images: torch.from_numpy(
                np.array(apply(images.numpy()))))

        monkeypatch.setattr(port_trainer, "evaluate_model", with_jax_grid)
    optimizer, schedule = make_optimizer(port)
    got = port_trainer.Trainer(port, optimizer, schedule, device="cpu").validate(
        loader, compute_map=True)

    assert got.keys() == ref.keys()
    map_keys = [k for k in ref if k.startswith(("mAP", "precision", "recall"))]
    assert len(map_keys) == 8 and got["mAP50"] > 0
    for k in ref:
        if k not in map_keys:
            assert got[k] == pytest.approx(ref[k], rel=1e-4), k
        elif forward == "jax_grid":
            assert got[k] == ref[k], k
        else:
            assert got[k] == pytest.approx(ref[k], abs=KEY_TOL), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_one_transfer_packing_round_trips(n, dtype):
    """Off the CPU, both paths pack a batch's outputs into one uint8 buffer
    for their single copy to the host; unpacking gives the arrays back, for
    odd batches too (1-byte segments must not misalign 4- or 8-byte ones)."""
    pred, target = eval_grids(4, n)
    metric = mAPMetric(num_classes=C)
    div = torch.tensor(7.0, dtype=dtype)
    out = port_map._process_batch(
        torch.from_numpy(pred).to(dtype), torch.from_numpy(target).to(dtype), S, B, C, 0.01,
        0.4, torch.tensor(metric.iou_thresholds, dtype=dtype), div)
    assert out["scores"].dtype == dtype
    back = port_map._unpack(port_map._pack(out), out)
    assert list(back) == list(out)
    for k, v in out.items():
        assert back[k].dtype == v.numpy().dtype and back[k].shape == tuple(v.shape), k
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
