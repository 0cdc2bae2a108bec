"""The port's serving front end held against the JAX package's.

The small flagship of test_torch_serving.py (stages (1, 1, 1, 1) at 64x64,
seeded random BN, fc2 scaled so that scores are O(1)) serves in both
packages: JAX builds the int8 q-params, the port gets them through
``to_torch`` and its weights through ``state_dict_from_jax``; images are
made with numpy from seeds.

- ``preprocess_array`` equals JAX's exactly, and refuses what JAX refuses.
- One PNG POSTed to JAX's ``YOLOServer`` and to the port's gives the same
  JSON: count, order and class ids equal, boxes and scores within rtol 1e-5,
  atol 1e-6. The int8 activations are equal bit for bit, but the float32 fc2
  sums run in another order in the two frameworks (the grid tolerance of
  test_torch_serving.py), which moves scores by up to ~3.3e-6 relative; the
  port's decode also divides by S where XLA multiplies by 1/S
  (yolo_tpu_torch/ops/decode.py). The confidence threshold keeps every score
  1e-3 away, and the image has no same-class IoU within 1e-4 of the NMS
  threshold, so float rounding flips no decision.
- JAX's five batcher tests and three server tests
  (tests/test_serving.py), on the port's engine on the CPU.
- The serve CLI on the CPU: ``--engine``, its refusals, the exit without
  CUDA, and a subprocess that serves; ``GraphedPredict`` refuses the CPU.
  The captured graphs themselves are tested on the card
  (tests/test_torch_cuda.py).
"""

import http.client
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolo_tpu.inference import preprocess_array as jpreprocess_array
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu.serving import YOLOServer as JYOLOServer
from yolo_tpu.serving.engine import build_int8_predict as jbuild_int8_predict
from yolo_tpu.serving.server import detections_to_json as jdetections_to_json
from yolo_tpu_torch import serve
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.data.transforms import eval_transform
from yolo_tpu_torch.data.voc import VOC_CLASSES
from yolo_tpu_torch.inference import YOLOInference, preprocess_array
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.ops.decode import Detections
from yolo_tpu_torch.serving import RequestBatcher, YOLOServer, engine, export
from yolo_tpu_torch.serving.graphs import GraphedPredict
from yolo_tpu_torch.serving.server import detections_to_json

from test_torch_inference import iou_margin_ok, pick_threshold, randomize
from test_torch_serving import to_torch

REPO = Path(__file__).resolve().parents[1]
STAGES = (1, 1, 1, 1)
SIZE = 64
NMS_T = 0.4


@pytest.fixture(scope="module")
def stack():
    """JAX's engine and the port's on JAX's q-params, at one threshold."""
    jmodel = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    variables = randomize(init_model(jmodel, jax.random.PRNGKey(0), image_size=SIZE))
    calib = np.random.default_rng(1).normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)
    jfn, qj = jbuild_int8_predict(jmodel, variables, [jnp.asarray(calib)])
    qp = to_torch(qj)
    pfn = engine.make_int8_engine_fn(7, 2, 20)
    probe = np.random.default_rng(2).integers(0, 256, (8, SIZE, SIZE, 3), np.uint8)
    conf = pick_threshold(np.asarray(jfn(qj, probe, -1e30, 2.0).scores))
    port = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES, image_size=SIZE)
    port.load_state_dict(state_dict_from_jax(variables))
    return {
        "jpredict": lambda images: jfn(qj, images, conf, NMS_T),
        "jraw": lambda images: jfn(qj, images, -1e30, 2.0),
        "jfn": jfn, "qj": qj, "qp": qp, "pfn": pfn, "conf": conf, "port": port,
        "predict": lambda images: pfn(qp, torch.tensor(np.asarray(images)), conf, NMS_T),
    }


def _png(array_u8) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array_u8).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, body: bytes, path="/predict"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    payload = json.loads(resp.read().decode())
    conn.close()
    return resp.status, payload


def _post_image(port, array_u8, path="/predict"):
    return _post(port, _png(array_u8), path)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    payload = json.loads(resp.read().decode())
    conn.close()
    return resp.status, payload


def _first(dets):
    """Image 0 of a batch of Detections, as numpy."""
    return Detections(*(np.asarray(a)[0] for a in dets))


def assert_same_json(got, want, rtol, atol=0.0):
    assert len(got) == len(want)
    assert [d["class_id"] for d in got] == [d["class_id"] for d in want]
    assert [d.get("class_name") for d in got] == [d.get("class_name") for d in want]
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose([d["box"] for d in got], [d["box"] for d in want],
                               rtol=rtol, atol=atol)


# ----------------------------------------------------------------- preprocess
def _preprocess_input(kind):
    r = np.random.default_rng(5)
    if kind == "uint8":
        return r.integers(0, 256, (50, 70, 3), np.uint8), "auto"
    if kind == "unit":
        return r.uniform(0, 1, (50, 70, 3)).astype(np.float32), "unit"
    if kind == "255":
        return r.uniform(0, 255, (50, 70, 3)).astype(np.float32), "255"
    if kind == "auto-unit":
        return r.uniform(0, 1, (48, 48, 3)), "auto"  # float64
    if kind == "auto-255":
        return r.uniform(0, 255, (90, 40, 3)).astype(np.float32), "auto"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["uint8", "unit", "255", "auto-unit", "auto-255"])
def test_preprocess_array_matches_jax(kind):
    image, value_range = _preprocess_input(kind)
    got = preprocess_array(image, SIZE, value_range)
    want = jpreprocess_array(image, SIZE, value_range)
    assert got.dtype == want.dtype == np.float32 and got.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)


def test_preprocess_array_refuses_what_jax_refuses():
    image = np.zeros((8, 8, 3), np.float32)
    for fn in (preprocess_array, jpreprocess_array):
        with pytest.raises(ValueError, match="value_range must be auto|unit|255"):
            fn(image, SIZE, "percent")
    # A uint8 image needs no range, so neither package checks it.
    u8 = np.zeros((8, 8, 3), np.uint8)
    np.testing.assert_array_equal(preprocess_array(u8, SIZE, "percent"),
                                  jpreprocess_array(u8, SIZE, "percent"))


# ------------------------------------------------------------ server parity
def test_server_json_matches_jax_server(stack):
    """The same PNG through JAX's YOLOServer and the port's: equal JSON."""
    for seed in range(30, 40):
        img = np.random.default_rng(seed).integers(0, 256, (80, 96, 3), np.uint8)
        pre = eval_transform(img, (SIZE, SIZE), normalize_host=False)
        raw = stack["jraw"](pre[None])
        scores = np.asarray(raw.scores)
        if np.min(np.abs(scores - stack["conf"])) > 1e-3 and iou_margin_ok(
                stack["jpredict"](pre[None])):
            break
    else:
        raise AssertionError("no seed cleared the threshold margins")
    with JYOLOServer(stack["jpredict"], image_size=SIZE, buckets=(1,),
                     max_delay_ms=1.0) as jserver, \
            YOLOServer(stack["predict"], image_size=SIZE, buckets=(1,),
                       max_delay_ms=1.0) as server:
        jserver.warmup()
        server.warmup()
        jstatus, want = _post_image(jserver.port, img)
        status, got = _post_image(server.port, img)
    assert status == jstatus == 200
    assert len(want["detections"]) > 1
    assert_same_json(got["detections"], want["detections"], rtol=1e-5, atol=1e-6)
    # And the JSON helper itself, on the same numpy detections.
    dets = _first(stack["predict"](pre[None]))
    assert detections_to_json(dets, None) == jdetections_to_json(dets, None)


# -------------------------------------------------------------------- batcher
def test_request_batcher_matches_per_image_calls(stack):
    """Batcher assembly/pad/slice is exact, and pad rows are inert.

    Bit-exact vs a direct call on the same padded bucket; tolerance vs
    independent per-image calls (another batch shape may sum in another
    order)."""
    predict = stack["predict"]
    images = np.random.default_rng(81).normal(size=(5, SIZE, SIZE, 3)).astype(np.float32)
    with RequestBatcher(predict, (SIZE, SIZE, 3), buckets=(8,), max_delay_ms=500.0) as b:
        b.warmup()
        futs = [b.submit(img) for img in images]
        got = [f.result(timeout=60) for f in futs]

    padded = np.zeros((8, SIZE, SIZE, 3), np.float32)
    padded[:5] = images
    bucket_want = [t.numpy() for t in predict(padded)]
    assert sum(int(g.valid.sum()) for g in got) > 0
    for i, g in enumerate(got):
        assert isinstance(g, Detections)
        for a, w in zip(g, bucket_want):
            np.testing.assert_array_equal(a, w[i])
        single = predict(images[i:i + 1])
        for a, w in zip(g, single):
            np.testing.assert_allclose(np.asarray(a, np.float32), w[0].numpy().astype(np.float32),
                                       rtol=1e-4, atol=1e-6)


def test_request_batcher_coalesces_into_buckets(stack):
    """Concurrent submits ride one padded bucket; stats expose occupancy."""
    images = np.zeros((6, SIZE, SIZE, 3), np.float32)
    b = RequestBatcher(stack["predict"], (SIZE, SIZE, 3), buckets=(1, 4, 8),
                       max_delay_ms=500.0)
    b.warmup()
    futs = [b.submit(img) for img in images]
    for f in futs:
        f.result(timeout=60)
    b.close()
    assert b.images_served == 6
    # A 500 ms fill window >> the submit loop: at most 2 batches.
    assert b.batches_dispatched <= 2
    assert sum(b.bucket_batches.values()) == b.batches_dispatched
    assert sum(k * v for k, v in b.bucket_batches.items()) >= 6


def test_request_batcher_single_request_flushes_on_timeout(stack):
    """A lone request is served after max_delay without co-riders."""
    b = RequestBatcher(stack["predict"], (SIZE, SIZE, 3), buckets=(4,), max_delay_ms=5.0)
    b.warmup()
    fut = b.submit(np.zeros((SIZE, SIZE, 3), np.float32))
    res = fut.result(timeout=60)
    assert res.scores.shape == (98,)  # per-image K candidates
    b.close()
    assert b.batches_dispatched == 1 and b.images_served == 1
    assert dict(b.bucket_batches) == {4: 1}


def test_request_batcher_validates_and_propagates_errors(stack):
    b = RequestBatcher(stack["predict"], (SIZE, SIZE, 3), buckets=(1,))
    with pytest.raises(ValueError, match="image shape"):
        b.submit(np.zeros((32, 32, 3), np.float32))

    def boom(images):
        raise RuntimeError("engine down")

    b2 = RequestBatcher(boom, (SIZE, SIZE, 3), buckets=(1,))
    fut = b2.submit(np.zeros((SIZE, SIZE, 3), np.float32))
    with pytest.raises(RuntimeError, match="engine down"):
        fut.result(timeout=60)
    b2.close()
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((SIZE, SIZE, 3), np.float32))
    with pytest.raises(ValueError, match="ascending"):
        RequestBatcher(boom, (SIZE, SIZE, 3), buckets=(4, 1))


def test_request_batcher_cancelled_future_does_not_kill_worker(stack):
    """A caller cancelling its future while the batch computes must not
    crash the worker (set_result on a cancelled future raises)."""
    gate = threading.Event()
    predict = stack["predict"]

    def slow_predict(images):
        gate.wait(timeout=30)
        return predict(images)

    b = RequestBatcher(slow_predict, (SIZE, SIZE, 3), buckets=(1,), max_delay_ms=1.0)
    f1 = b.submit(np.zeros((SIZE, SIZE, 3), np.float32))
    f1.cancel()  # pending or running; cancel best-effort
    gate.set()
    # The worker must survive to serve the next request.
    f2 = b.submit(np.ones((SIZE, SIZE, 3), np.float32))
    assert f2.result(timeout=60) is not None
    b.close()


# --------------------------------------------------------------------- server
def test_http_server_serves_predictions(stack):
    """POST /predict returns the detections of a direct engine call on the
    identically preprocessed image; /healthz reports served counts."""
    predict = stack["predict"]
    img = np.random.default_rng(7).integers(0, 256, (SIZE, SIZE, 3), np.uint8)
    with YOLOServer(predict, image_size=SIZE, buckets=(1, 2), max_delay_ms=1.0) as server:
        server.warmup()
        status, body = _post_image(server.port, img)
        assert status == 200
        # PNG is lossless, so the server's array is exactly eval_transform(img).
        pre = eval_transform(img, (SIZE, SIZE), normalize_host=False)
        want = detections_to_json(_first(predict(pre[None])), server._class_names)
        assert body["detections"] == want
        for det in body["detections"]:
            assert set(det) >= {"class_id", "class_name", "score", "box"}
            assert len(det["box"]) == 4
        status, health = _get(server.port, "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["images_served"] >= 1


def test_http_server_error_paths(stack):
    with YOLOServer(stack["predict"], image_size=SIZE, buckets=(1,)) as server:
        # A garbage body -> 400, not a crash.
        status, body = _post(server.port, b"not an image")
        assert status == 400 and "error" in body
        # Unknown paths -> 404 on both verbs.
        assert _get(server.port, "/nope")[0] == 404
        assert _post(server.port, b"x", path="/nope")[0] == 404
        # Still healthy after the errors.
        status, body = _post_image(
            server.port, np.random.default_rng(8).integers(0, 256, (SIZE, SIZE, 3), np.uint8))
        assert status == 200 and "detections" in body

    def boom(images):
        raise RuntimeError("engine down")

    with YOLOServer(boom, image_size=SIZE, buckets=(1,)) as server:
        status, body = _post_image(server.port, np.zeros((SIZE, SIZE, 3), np.uint8))
        assert status == 500 and "engine down" in body["error"]


def test_http_server_request_hygiene(stack):
    """A malformed Content-Length -> 400, an oversized body -> 413, and a
    failed bind closes the batcher's worker."""
    predict = stack["predict"]
    with YOLOServer(predict, image_size=SIZE, buckets=(1,), max_body_bytes=100_000) as server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "banana")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read().decode())["error"]
        conn.close()

        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("POST", "/predict", body=b"x" * 200_000)
        assert conn.getresponse().status == 413
        conn.close()

        workers = _batcher_workers()
        with pytest.raises(OSError):
            YOLOServer(predict, image_size=SIZE, buckets=(1,), host=server.host,
                       port=server.port)
        assert _batcher_workers() == workers  # the failed server's worker was joined

        status, body = _post_image(
            server.port, np.random.default_rng(9).integers(0, 256, (32, 32, 3), np.uint8))
        assert status == 200 and "detections" in body


def _batcher_workers() -> int:
    return sum(t.name.endswith("(_run)") for t in threading.enumerate())


def test_server_float_wire_normalizes_on_the_host(stack):
    """dtype=float32: the server sends normalized floats, which the engine
    serves as the uint8 wire's on-device normalize does (to float rounding)."""
    img = np.random.default_rng(10).integers(0, 256, (SIZE, SIZE, 3), np.uint8)
    answers = []
    for dtype in (np.uint8, np.float32):
        with YOLOServer(stack["predict"], image_size=SIZE, dtype=dtype, buckets=(1,),
                        max_delay_ms=1.0) as server:
            status, body = _post_image(server.port, img)
            assert status == 200
            answers.append(body["detections"])
    pre = eval_transform(img, (SIZE, SIZE))
    assert answers[1] == detections_to_json(_first(stack["predict"](pre[None])), VOC_CLASSES)
    assert_same_json(answers[1], answers[0], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- the CLI
@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: a checkpoint written here
    is ~250 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def artifact(stack, tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "engine.npz"
    export.save_engine(path, stack["qp"], S=7, B=2, num_classes=20)
    yield path
    path.unlink()


def test_serve_cli_builds_the_engine_from_an_artifact_on_the_cpu(stack, artifact):
    args = serve.parse_args(["--engine", str(artifact), "--device", "cpu", "--image-size",
                             str(SIZE), "--buckets", "1,2",
                             f"--conf-threshold={stack['conf']!r}"])
    # An unset threshold is None (an AOT artifact's baked one is noted only
    # against an explicit flag); the engine resolves it to the default, 0.4.
    assert args.port == 8000 and args.nms_threshold is None and serve.DEFAULT_NMS == NMS_T
    predict, buckets, image_size = serve.build_predict(args)
    assert buckets == (1, 2) and image_size == SIZE
    assert not isinstance(predict, GraphedPredict)
    images = np.random.default_rng(11).integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)
    got = predict(torch.from_numpy(images))
    want = stack["predict"](images)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert int(want.valid.sum()) > 0


def test_serve_cli_builds_the_engine_from_a_checkpoint_on_the_cpu(stack, tmp_path, capsys):
    """--checkpoint without --calib-dir calibrates on seeded noise, says so,
    and serves what YOLOInference calibrated on the same batches serves."""
    ckpt = tmp_path / "small.pth"
    torch.save(stack["port"].state_dict(), ckpt)
    args = serve.parse_args(["--checkpoint", str(ckpt), "--device", "cpu", "--image-size",
                             str(SIZE), f"--conf-threshold={stack['conf']!r}"])
    predict, buckets, image_size = serve.build_predict(args)
    assert "calibrating int8 activation scales on random noise" in capsys.readouterr().out
    assert buckets == (1, 4, 16) and image_size == SIZE
    calib = serve._calibration_batches(args)
    ref = YOLOInference(stack["port"], "cpu", image_size=SIZE, optimize="int8",
                        calibration=calib)
    images = np.random.default_rng(13).integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)
    got = predict(torch.from_numpy(images))
    want = ref.predict_batch_arrays(images, stack["conf"], NMS_T)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("flags", [["--compiled", "ART"],
                                   ["--compiled", "ART", "--save-compiled", "aot.pt2"]])
def test_serve_cli_refuses_the_aot_artifact(artifact, flags):
    """--compiled takes only an AOT artifact (not the plain engine .npz), and
    --save-compiled needs an engine built here, not a recorded one."""
    argv = [str(artifact) if f == "ART" else f for f in flags] + ["--device", "cpu"]
    match = ("not a yolo-tpu AOT engine artifact" if len(flags) == 2
             else r"--save-compiled needs a live or frozen engine build \(not --compiled\)")
    with pytest.raises(SystemExit, match=match):
        serve.main(argv)


def test_serve_cli_exits_without_cuda_at_the_default_device(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(["--engine", str(artifact)])
    assert args.device == "cuda"
    with pytest.raises(SystemExit, match="CUDA is not available"):
        serve.build_predict(args)


def test_serve_cli_serves_on_the_cpu(stack, artifact):
    """``python -m yolo_tpu_torch.serve --device cpu --port 0``: it says it
    serves eagerly, prints its port, and answers /healthz and /predict as
    the in-process engine does."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-m", "yolo_tpu_torch.serve", "--engine", str(artifact),
           "--device", "cpu", "--port", "0", "--image-size", str(SIZE),
           f"--conf-threshold={stack['conf']!r}"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert "serving the engine eagerly" in first, first
        for line in proc.stdout:
            match = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if match:
                break
        else:
            raise AssertionError("serve exited before it served")
        port = int(match.group(1))
        status, health = _get(port, "/healthz")
        assert status == 200 and health["status"] == "ok"
        img = np.random.default_rng(12).integers(0, 256, (SIZE, SIZE, 3), np.uint8)
        status, body = _post_image(port, img)
        assert status == 200
        pre = eval_transform(img, (SIZE, SIZE), normalize_host=False)
        assert body["detections"] == detections_to_json(
            _first(stack["predict"](pre[None])), VOC_CLASSES)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0


# -------------------------------------------------------------------- graphs
def test_graphed_predict_refuses_the_cpu(stack):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphedPredict(stack["predict"], "cpu")
    exact = YOLOInference(stack["port"], "cpu", image_size=SIZE)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphedPredict(exact.batch_fn(0.5, NMS_T), exact.device)


def test_batch_fn_refuses_an_uncalibrated_int8_engine(stack):
    lazy = YOLOInference(stack["port"], "cpu", image_size=SIZE, optimize="int8")
    with pytest.raises(RuntimeError, match="calibrates on its first"):
        lazy.batch_fn(0.5, NMS_T)


@pytest.mark.parametrize("optimize", [None, "int8"])
def test_batch_fn_equals_predict_batch_arrays(stack, optimize):
    """The closed batch path at fixed thresholds (what GraphedPredict
    captures) equals the engine's own batch call, bit for bit."""
    r = np.random.default_rng(17)
    calib = None if optimize is None else [
        r.normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)]
    eng = YOLOInference(stack["port"], "cpu", image_size=SIZE, optimize=optimize,
                        calibration=calib)
    images = torch.from_numpy(r.integers(0, 256, (3, SIZE, SIZE, 3), np.uint8))
    want = eng.predict_batch_arrays(images, stack["conf"], NMS_T)
    got = eng.batch_fn(stack["conf"], NMS_T)(images)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want.valid.sum()) > 0
