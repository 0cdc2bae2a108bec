"""The int8 engine's Winograd convs (``wino=``) held against the JAX package's.

Two small ResNet YOLOv1s with seeded random BN (test_torch_inference.randomize),
quantized by the JAX package with per-tap Winograd params; the port runs the
same q-params (its kernel wrappers run the plain twins on CPU tensors):

- (1, 1, 1, 1) at 64x64: the Winograd points l1b0_conv2 and head_conv1 (2x2),
  and head_conv3 and head_conv4 at 1x1 (the odd path). Calibration with
  ``wino_points`` within rtol 1e-4, and ``quantize_folded(wino=...)`` bit
  for bit.
- At 64x64 and at (2, 2, 2, 2) 128x128 (all 8 Winograd points even and
  square): the stem's, every block's and every head conv's int8 output
  equals JAX's engine code's bit for bit, with JAX's Winograd hooks running
  the documented op order (``test_torch_winograd.wino_reference_np``, one
  rounding per float32 step); JAX's own Winograd conv (the Pallas kernel in
  interpret mode where it takes the shape, the XLA path otherwise) stays
  within 1 of it in under 0.1% of the values, because XLA:CPU fuses the
  dequant multiply into the inverse transform's add now and then. Grids
  within ``1e-5*max|ref| + 1e-6`` (float32 FC sums in another order, as in
  tests/test_torch_serving.py) and detections equal.
- Artifacts both ways, ``YOLOInference(wino=)`` calibrated and lazy, a
  stage-chain hook shadowing its stage's ``conv2_s1`` hooks, and the
  refusal of names that are not stride-1 3x3 convs.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu.serving import calibrate_activations as jcalibrate
from yolo_tpu.serving import engine as jengine
from yolo_tpu.serving import export as jexport
from yolo_tpu.serving import fold_flagship as jfold
from yolo_tpu.serving import quantize_folded as jquantize
from yolo_tpu.serving import winograd as jw
from yolo_tpu.serving.pallas_wino import conv3x3_wino_pallas
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.inference import YOLOInference
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.serving import cuda_bottleneck, cuda_pool, cuda_stem, engine, export, quant
from yolo_tpu_torch.serving import winograd as pw

from test_torch_inference import assert_same_detections, comparable_batch, randomize
from test_torch_serving import _JaxEngine, _host, _jax_stem, assert_trees, to_torch
from test_torch_winograd import wino_reference_np

NMS_T = 0.4
SMALL_WINO = ("l1b0_conv2", "head_conv1", "head_conv3", "head_conv4")


def _build(stages, size, seed, wino, n_calib):
    jmodel = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=stages))
    variables = randomize(init_model(jmodel, jax.random.PRNGKey(seed), image_size=size))
    port = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=stages, image_size=size)
    port.load_state_dict(state_dict_from_jax(variables))
    calib = np.random.default_rng(seed + 1).normal(size=(n_calib, size, size, 3)).astype(
        np.float32)
    jfolded = jfold(variables)
    act_max = jcalibrate(jfolded, [jnp.asarray(calib)], wino_points=wino)
    qj = jquantize(jfolded, act_max, wino=wino)
    return {"port": port, "calib": calib, "jfolded": jfolded, "act_max": act_max, "qj": qj,
            "qp": to_torch(qj), "size": size}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: the checkpoints and
    engine artifacts written here are tens to hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def small():
    return _build((1, 1, 1, 1), 64, 0, SMALL_WINO, 8)


@pytest.fixture(scope="module")
def even():
    return _build((2, 2, 2, 2), 128, 20, tuple(pw.valid_points((2, 2, 2, 2))), 4)


def _images(seed, n, size):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def test_calibration_with_wino_points_matches_jax(small):
    folded = to_torch(small["jfolded"])
    got = quant.calibrate_activations(folded, [torch.from_numpy(small["calib"])],
                                      wino_points=SMALL_WINO)
    want = small["act_max"]
    assert set(got) == set(want)
    assert [k for k in got if k.endswith("_wtap")] == [f"{n}_wtap" for n in SMALL_WINO]
    for k, w in want.items():
        if k.endswith("_wtap"):
            assert got[k].dtype == np.float32 and got[k].shape == (16,), k
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-4, atol=0, err_msg=k)
        else:
            assert got[k] == pytest.approx(w, rel=1e-4), k
    # Two batches: the running elementwise maximum.
    half = [torch.from_numpy(small["calib"][:4]), torch.from_numpy(small["calib"][4:])]
    two = quant.calibrate_activations(folded, half, wino_points=SMALL_WINO)
    for k in got:
        np.testing.assert_allclose(two[k], got[k], rtol=1e-6, err_msg=k)


def test_quantize_folded_with_wino_matches_jax_bit_for_bit(small):
    got = quant.quantize_folded(to_torch(small["jfolded"]), small["act_max"], wino=SMALL_WINO)
    assert_trees(got, small["qj"], exact=True)
    assert pw.wino_points_of(got) == SMALL_WINO == jw.wino_points_of(small["qj"])


def _jax_wino(leaky):
    """JAX's Winograd conv as its TPU dispatch picks it: the Pallas kernel
    (here in interpret mode) on even square images, the XLA path otherwise."""
    def conv(x, qc):
        if x.shape[1] == x.shape[2] and x.shape[1] % 2 == 0:
            return conv3x3_wino_pallas(x, qc, leaky=leaky, interpret=True)
        return jw.conv3x3_wino_rq(x, qc, leaky=leaky)
    return conv


def _exact_wino(leaky):
    """A JAX engine hook running the Winograd conv in the documented order
    with separate roundings (the numpy reference, also under jit)."""
    def conv(x, qc):
        qw = qc["wino"]
        return jax.pure_callback(
            lambda *a: wino_reference_np(np.asarray(a[0]), dict(zip(
                ("uq", "mw", "t", "dinv"), a[1:])), leaky),
            jax.ShapeDtypeStruct((*x.shape[:3], qw["uq"].shape[-1]), jnp.int8),
            x, qw["uq"], qw["mw"], qw["t"], qw["dinv"])
    return conv


def _jax_impl(wino, conv):
    return {"conv2_s1": {n.removesuffix("_conv2"): conv(False) for n in wino
                         if n.endswith("_conv2")},
            **{n: conv(True) for n in wino if n.startswith("head_")}}


def _assert_within_one(got, ref, what):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (what, diff.max(), (diff > 0).sum())


def _check_every_conv(data, wino, u8):
    """Stem, blocks and head convs on JAX's activations, through JAX's engine
    code with the exact-order Winograd hook and through the port: equal bit
    for bit. At each Winograd conv the port equals the numpy reference, and
    JAX's own Winograd conv is within 1 of it in under 0.1% of the values
    (XLA:CPU fuses a multiply into an add now and then)."""
    qj, qp = data["qj"], data["qp"]
    jexact, jown = _jax_impl(wino, _exact_wino), _jax_impl(wino, _jax_wino)
    pimpl = pw.wino_impl_hooks(wino)
    seen = []

    def checked(name, jfn, jref, pfn):
        def conv(x, qc):
            want = jfn(x, qc)
            got = pfn(torch.from_numpy(np.array(x)), to_torch(qc))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
            _assert_within_one(jref(x, qc), want, name)
            seen.append(name)
            return want
        return conv

    want = _jax_stem(qj, jnp.asarray(u8))
    got = cuda_pool.max_pool_int8(engine.kernel_conv(
        cuda_stem.quant_s2d(torch.from_numpy(u8), qp["s_img"]), qp["stem"], 1,
        ((2, 1), (2, 1)), "relu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg="stem")
    for si, (jblocks, pblocks) in enumerate(zip(qj["layers"], qp["layers"])):
        for bi, (jb, pb) in enumerate(zip(jblocks, pblocks)):
            tag, stride = f"l{si + 1}b{bi}", 2 if (si > 0 and bi == 0) else 1
            s1 = jexact["conv2_s1"].get(tag)
            if s1 is not None:
                s1 = checked(f"{tag}_conv2", s1, jown["conv2_s1"][tag],
                             pimpl["conv2_s1"][tag])
            got = engine._block(torch.from_numpy(np.array(want)), pb, stride,
                                conv2_s1=pimpl["conv2_s1"].get(tag))
            want = jengine._block_xla(want, jb, stride, conv2s1_fn=s1)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=tag)
    for i, stride in ((1, 1), (2, 2), (3, 1), (4, 1)):
        name, jc = f"head_conv{i}", qj["head"][f"conv{i}"]
        if name in wino:
            want = checked(name, jexact[name], jown[name], pimpl[name])(want, jc)
        else:
            got = engine.kernel_conv(torch.from_numpy(np.array(want)), qp["head"][f"conv{i}"],
                                     stride, 1, "leaky")
            want = jengine._requant(jengine._conv_i8(want, jc["wq"], stride, 1), jc["m"],
                                    jc["t"], leaky=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert sorted(seen) == sorted(wino)
    return jexact, pimpl


def _check_grid_and_detections(data, jexact, pimpl, seed, detections=True):
    qj, qp, size = data["qj"], data["qp"], data["size"]
    images = _images(seed, 2, size)
    want = np.asarray(jengine.int8_forward(qj, jnp.asarray(images), impl=jexact))
    got = engine.int8_forward(qp, torch.from_numpy(images), impl=pimpl)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-6)
    default = engine.int8_forward(qp, torch.from_numpy(images))
    assert not torch.equal(got, default)  # the hooks ran
    if not detections:
        return
    # JAX's engine eagerly: its jitted engine rounds some int8 activations
    # otherwise than its own eager forward (XLA fusion), Winograd or not.
    def jax_eager(q, images, conf, nms):
        preds = jengine.int8_forward(q, images, impl=jexact)
        return jengine.batched_nms(jengine.decode_predictions(preds, 7, 2, 20, conf), nms)

    jfn = _JaxEngine(jax_eager, qj)
    images, thr = comparable_batch(jfn, seed + 1, lambda s: _images(s, 2, size))
    want = jfn.predict_batch_arrays(images, thr, NMS_T)
    got = engine.make_int8_engine_fn(7, 2, 20, impl=pimpl)(qp, torch.from_numpy(images), thr,
                                                            NMS_T)
    assert_same_detections(got, want)
    assert 0 < int(np.asarray(want.valid).sum())


def test_engine_matches_jax_at_64_odd_head(small):
    """l1b0_conv2 and head_conv1 at 2x2 (JAX: the Pallas kernel), head_conv3
    and head_conv4 at 1x1 (the odd path; JAX: the XLA path)."""
    jexact, pimpl = _check_every_conv(small, SMALL_WINO, _images(30, 3, 64))
    _check_grid_and_detections(small, jexact, pimpl, 31, detections=False)


def test_engine_matches_jax_pallas_at_128_every_point(even):
    wino = pw.valid_points((2, 2, 2, 2))
    jexact, pimpl = _check_every_conv(even, wino, _images(32, 2, 128))
    _check_grid_and_detections(even, jexact, pimpl, 33)


def _engine(small, **kw):
    return YOLOInference(small["port"], "cpu", image_size=64, optimize="int8", **kw)


def test_wino_artifacts_serve_both_ways(small, tmp_path):
    qj = small["qj"]
    path = tmp_path / "jax_wino.npz"
    jexport.save_engine(path, qj, S=7, B=2, num_classes=20)
    jfn = _JaxEngine(jengine.make_int8_engine_fn(7, 2, 20, impl=jw.wino_impl_hooks(SMALL_WINO)),
                     qj)
    images, thr = comparable_batch(jfn, 40, lambda seed: _images(seed, 4, 64))
    eng = _engine(small, engine_artifact=str(path))
    assert pw.wino_points_of(eng._int8_state["q"]) == SMALL_WINO
    assert_same_detections(eng.predict_batch_arrays(images, thr, NMS_T),
                           jfn.predict_batch_arrays(images, thr, NMS_T))

    port = _engine(small, calibration=[small["calib"]], wino=SMALL_WINO)
    out = tmp_path / "port_wino.npz"
    port.save_engine(out)
    q_jax, _ = jexport.load_engine(out)
    assert jw.wino_points_of(q_jax) == SMALL_WINO
    q_port, _ = export.load_engine(out)
    assert_trees(q_port, jax.tree.map(np.asarray, q_jax))
    assert_trees(q_port, _host(port._int8_state["q"]))  # no derived keys (uk) written


def _saved(eng, path):
    eng.save_engine(path, force=True)
    return path


def test_yolo_inference_wino_calibrated_and_lazy(small, tmp_path):
    calib = small["calib"]
    eng = _engine(small, calibration=[calib], wino=SMALL_WINO)
    q = eng._int8_state["q"]
    assert pw.wino_points_of(q) == SMALL_WINO
    images = _images(41, 3, 64)
    got = eng.predict_batch_arrays(images, -1e9, NMS_T)
    hooks = pw.wino_impl_hooks(SMALL_WINO)
    want = engine.make_int8_engine_fn(7, 2, 20, impl=hooks)(q, torch.from_numpy(images), -1e9,
                                                            NMS_T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = engine.make_int8_engine_fn(7, 2, 20)(
        q, torch.from_numpy(images), -1e9, NMS_T)
    assert not torch.equal(got.scores, plain.scores)  # the Winograd convs ran

    lazy = _engine(small, wino=SMALL_WINO)
    again = lazy.predict_batch_arrays(calib, -1e9, NMS_T)  # calibrates on these 8 images
    assert_trees(export.load_engine(_saved(lazy, tmp_path / "lazy.npz"))[0], _host(q))
    assert torch.equal(again.scores, eng.predict_batch_arrays(calib, -1e9, NMS_T).scores)


def test_a_chain_hook_shadows_its_stage_conv2_s1_hooks(small):
    qp = small["qp"]
    images = torch.from_numpy(_images(42, 2, 64))
    calls = []

    def record(name, fn):
        def hook(*args):
            calls.append(name)
            return fn(*args)
        return hook

    impl = pw.wino_impl_hooks(["l1b0_conv2", "head_conv1"])
    impl["conv2_s1"] = {"l1b0": record("conv2_s1", impl["conv2_s1"]["l1b0"])}
    impl["head_conv1"] = record("head_conv1", impl["head_conv1"])
    impl["layer1"] = record("layer1", cuda_bottleneck.chain_int8)
    got = engine.int8_forward(qp, images, impl=impl)
    assert calls == ["layer1", "head_conv1"]
    want = engine.int8_forward(qp, images, impl={"head_conv1": impl["head_conv1"]})
    assert torch.equal(got, want)


def test_names_that_are_not_stride1_3x3_convs_raise(small):
    folded = to_torch(small["jfolded"])
    with pytest.raises(ValueError, match="valid names: l1b0_conv2, head_conv1"):
        quant.quantize_folded(folded, small["act_max"], wino=("l2b0_conv2",))
    with pytest.raises(ValueError, match="not stride-1 3x3 convs"):
        quant.calibrate_activations(folded, [torch.from_numpy(small["calib"][:1])],
                                    wino_points=("l1b1_conv2",))
    with pytest.raises(ValueError, match="not stride-1 3x3 convs"):
        _engine(small, wino=("head_conv2",))
    with pytest.raises(ValueError, match="requires optimize='int8'"):
        YOLOInference(small["port"], "cpu", image_size=64, wino=("head_conv1",))
