"""The port's inference slice held against the JAX engine, and its CLI.

Both sides run ``YOLOInference`` on the same small ResNet YOLOv1 (stages
(1, 1, 1, 1) at 64x64, seeded random BN, converted with
``state_dict_from_jax``) and the same seeded uint8 images. The detection sets
must be equal: valid masks and class ids exactly, boxes within 1e-5. The
forwards differ by float rounding (see test_torch_models.py), so a score
that lies near the confidence threshold, or a same-class IoU near the NMS
threshold, could flip a decision on one side only. The confidence threshold
is therefore taken from the JAX scores so that none lies within 1e-3 of it,
and a seed whose same-class IoUs come within 1e-4 of the NMS threshold is
skipped for the next one.
"""

import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from yolo_tpu.inference import YOLOInference as JInference
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.inference import YOLOInference
from yolo_tpu_torch.models import create_model

from test_torch_models import randomize_bn

REPO = Path(__file__).resolve().parents[1]
STAGES = (1, 1, 1, 1)
SIZE = 64
NMS_T = 0.4
FC2_SCALE = 50.0


def randomize(variables):
    """Seeded random BN (as in test_torch_models.py); fc2 scaled so that
    outputs are O(1) (with the default init they are ~1e-2 and scores ~1e-4,
    too close for the margins), and its bias shifted towards positive
    widths/heights and three classes, so that same-class boxes overlap and
    NMS has work to do."""
    variables = randomize_bn(variables)
    fc2 = variables["params"]["detection_head"]["fc2"]["Dense_0"]
    fc2["kernel"] *= np.float32(FC2_SCALE)
    fc2["bias"] *= np.float32(FC2_SCALE)
    grid_bias = fc2["bias"].reshape(7, 7, 30)
    grid_bias[..., [2, 3, 7, 8]] += np.float32(0.4)
    grid_bias[..., 10:13] += np.float32(1.0)
    return variables


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: the checkpoints written
    here are hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def engines():
    model = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    variables = randomize(init_model(model, jax.random.PRNGKey(0), image_size=SIZE))
    port = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                        image_size=SIZE)
    port.load_state_dict(state_dict_from_jax(variables))
    return (JInference(model, variables, image_size=SIZE),
            YOLOInference(port, "cpu", image_size=SIZE), variables)


def pick_threshold(scores, margin=1e-3):
    """A threshold near the median score with no score within ``margin``."""
    s = np.sort(scores.ravel().astype(np.float64))
    mids = (s[1:] + s[:-1]) / 2
    ok = (s[1:] - s[:-1]) > 2 * margin
    ok &= (mids > np.quantile(s, 0.2)) & (mids < np.quantile(s, 0.8))
    if not ok.any():
        return None
    cands = mids[ok]
    return float(cands[np.argmin(np.abs(cands - np.median(s)))])


def iou_margin_ok(dets, t=NMS_T, margin=1e-4):
    """No same-class pair of valid candidates has IoU within ``margin`` of t."""
    for boxes, cls, valid in zip(np.asarray(dets.boxes, np.float64),
                                 np.asarray(dets.class_ids), np.asarray(dets.valid)):
        b, c = boxes[valid], cls[valid]
        x1, y1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
        x2, y2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
        iw = np.clip(np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1), 0, None)
        ih = np.clip(np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1), 0, None)
        inter = iw * ih
        area = b[:, 2] * b[:, 3]
        iou = inter / (area[:, None] + area - inter + 1e-6)
        same = (c[:, None] == c) & ~np.eye(len(c), dtype=bool)
        if np.any(same & (np.abs(iou - t) < margin)):
            return False
    return True


def comparable_batch(j_engine, first_seed, make):
    """(inputs, conf_threshold) of the first seed that clears both margins."""
    for seed in range(first_seed, first_seed + 10):
        inputs = make(seed)
        raw = j_engine.predict_batch_arrays(inputs, conf_threshold=-1e30,
                                            nms_threshold=2.0)
        thr = pick_threshold(np.asarray(raw.scores))
        if thr is None:
            continue
        dets = j_engine.predict_batch_arrays(inputs, conf_threshold=thr,
                                             nms_threshold=2.0)
        if iou_margin_ok(dets):
            return inputs, thr
    raise AssertionError("no seed cleared the threshold margins")


def assert_same_detections(got, ref):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.cpu().numpy(), valid)
    np.testing.assert_array_equal(got.class_ids.cpu().numpy()[valid],
                                  np.asarray(ref.class_ids)[valid])
    np.testing.assert_allclose(got.boxes.cpu().numpy()[valid],
                               np.asarray(ref.boxes)[valid], rtol=0, atol=1e-5)


def test_batch_arrays_uint8_match_jax(engines):
    j_engine, engine, _ = engines

    def make(seed):
        r = np.random.default_rng(seed)
        return r.integers(0, 256, size=(4, SIZE, SIZE, 3), dtype=np.uint8)

    images, thr = comparable_batch(j_engine, 0, make)
    ref = j_engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=NMS_T)
    got = engine.predict_batch_arrays(images, conf_threshold=thr, nms_threshold=NMS_T)
    assert_same_detections(got, ref)
    n_valid = int(np.asarray(ref.valid).sum())
    before = int((np.asarray(ref.scores) > thr).sum())
    assert 0 < n_valid < before  # NMS kept some and suppressed some


def test_predict_files_match_jax(engines, tmp_path):
    j_engine, engine, _ = engines
    paths = []
    for k in range(3):
        r = np.random.default_rng(100 + k)
        img = r.integers(0, 256, size=(80, 96, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"img{k}.png"))
        Image.fromarray(img).save(paths[-1])
    arrays = np.stack([engine._transform(engine.load_image(p)) for p in paths])
    _, thr = comparable_batch(j_engine, 0, lambda seed: arrays)
    ref = j_engine.predict_batch_files(paths, conf_threshold=thr, nms_threshold=NMS_T)
    got = engine.predict_batch_files(paths, conf_threshold=thr, nms_threshold=NMS_T,
                                     batch_size=2)
    one = engine.predict(paths[0], conf_threshold=thr, nms_threshold=NMS_T)
    assert [len(d) for d in got] == [len(d) for d in ref]
    assert sum(len(d) for d in got) > 0
    for dets_got, dets_ref in zip(got, ref):
        for a, b in zip(dets_got, dets_ref):
            assert a.class_id == b.class_id
            assert a.confidence == pytest.approx(b.confidence, abs=1e-5)
            for f in ("x", "y", "width", "height"):
                assert getattr(a.bbox, f) == pytest.approx(getattr(b.bbox, f), abs=1e-5)
    assert [d.class_id for d in one] == [d.class_id for d in got[0]]


def test_host_helpers_match_jax(engines):
    j_engine, engine, _ = engines
    pred = np.zeros((7, 7, 30), np.float32)
    pred[3, 3, 0:5] = [0.5, 0.5, 0.2, 0.2, 0.9]
    pred[3, 3, 14] = 1.0
    pred[3, 4, 0:5] = [0.0, 0.5, 0.2, 0.2, 0.8]
    pred[3, 4, 14] = 1.0
    got = engine.parse_predictions(pred, conf_threshold=0.5)
    ref = j_engine.parse_predictions(pred, conf_threshold=0.5)
    assert [(d.class_id, d.confidence) for d in got] == [(d.class_id, d.confidence) for d in ref]
    kept = engine.non_max_suppression(got, nms_threshold=0.4)
    assert [d.confidence for d in kept] == [
        d.confidence for d in j_engine.non_max_suppression(ref, nms_threshold=0.4)]
    assert engine.iou(got[0].bbox, got[1].bbox) == j_engine.iou(ref[0].bbox, ref[1].bbox)
    with pytest.warns(DeprecationWarning):
        engine.non_max_suppression(got, iou_threshold=0.4)


def test_cli_on_jax_checkpoint_with_optax_state(engines, tmp_path):
    """``python -m yolo_tpu_torch.predict --device cpu`` on a JAX ``.ckpt``
    whose optimizer state holds optax classes, with jax/optax/flax blocked."""
    _, _, variables = engines
    opt = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-4))
    opt_state = opt.init({"stem": variables["params"]["backbone"]["conv1"]})
    payload = {
        "version": 1, "epoch": 3,
        "model_state_dict": {"params": variables["params"],
                             "batch_stats": variables["batch_stats"]},
        "optimizer_state_dict": jax.tree.map(np.asarray, opt_state),
        "scheduler_state_dict": {"step": 7},
    }
    ckpt = tmp_path / "yolo_latest.ckpt"
    with open(ckpt, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    img_dir, out_dir = tmp_path / "images", tmp_path / "out"
    img_dir.mkdir()
    for k in range(2):
        r = np.random.default_rng(200 + k)
        Image.fromarray(r.integers(0, 256, size=(70, 90, 3), dtype=np.uint8)).save(
            img_dir / f"im{k}.jpg")
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'flax', 'yolo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from yolo_tpu_torch.predict import main\n"
        f"main(['--checkpoint', {str(ckpt)!r}, '--image-dir', {str(img_dir)!r},"
        f" '--output', {str(out_dir)!r}, '--device', 'cpu', '--conf-threshold=-1e9'])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sorted(p.name for p in out_dir.iterdir()) == ["im0_pred.jpg", "im1_pred.jpg"]
    assert "Processed 2 images" in proc.stdout
