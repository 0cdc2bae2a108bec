"""The port's int8 serving engine held against the JAX package's.

A small ResNet YOLOv1 (stages (1, 1, 1, 1) at 64x64, seeded random BN, fc2
scaled so that scores are O(1); test_torch_inference.randomize) goes through
both packages: the port's weights come from ``state_dict_from_jax``, inputs
are made with numpy from seeds.

- Fold and its float forward within ``1e-4*max|ref| + 1e-5``; calibration in
  float32 at rtol 1e-4 (bfloat16 convolutions round differently in the two
  frameworks, so the bf16 calibration of ``build_int8_predict`` is not
  compared).
- Quantization on JAX's folded dict and maxima: every int8 weight bit for
  bit, the float32 constants at rtol 1e-6.
- The engine on JAX's q-params: the stem's and every block's int8 output bit
  for bit, the grid within ``1e-5*max|ref| + 1e-6`` (float32 FC sums in
  another order), detections equal.
- Engine artifacts in both directions, the calibration gate of
  ``save_engine``, and the predict CLI's int8 flags on the CPU.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu.serving import calibrate_activations as jcalibrate
from yolo_tpu.serving import engine as jengine
from yolo_tpu.serving import export as jexport
from yolo_tpu.serving import fold_flagship as jfold
from yolo_tpu.serving import folded_forward as jfolded_forward
from yolo_tpu.serving import quantize_folded as jquantize
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.inference import YOLOInference
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.serving import cuda_pool, cuda_stem, engine, export, fold, quant

from test_torch_cuda import POOL_CASES, pool_input
from test_torch_inference import assert_same_detections, comparable_batch, randomize

STAGES = (1, 1, 1, 1)
SIZE = 64
NMS_T = 0.4


def to_torch(tree):
    """A JAX/numpy tree -> torch tensors (bfloat16 through its bit pattern)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def assert_trees(got, want, exact=True, rtol=0.0, path=""):
    """Same structure; leaves equal (``exact``), or float leaves within rtol."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees(got[k], want[k], exact, rtol, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees(g, w, exact, rtol, f"{path}/{i}")
    else:
        g, w = to_numpy(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        if exact or w.dtype.kind in "iub" or w.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=path)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: the checkpoints and
    engine artifacts written here are tens to hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def flagship():
    jmodel = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    variables = randomize(init_model(jmodel, jax.random.PRNGKey(0), image_size=SIZE))
    port = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES, image_size=SIZE)
    port.load_state_dict(state_dict_from_jax(variables))
    calib = np.random.default_rng(1).normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)
    jfolded = jfold(variables)
    act_max = jcalibrate(jfolded, [jnp.asarray(calib)])
    return {"jmodel": jmodel, "variables": variables, "port": port, "calib": calib,
            "jfolded": jfolded, "act_max": act_max}


@pytest.fixture(scope="module")
def qparams(flagship):
    """JAX's q-params for each (stem_mode, fc1_mode), and the port's copy.

    quantize_folded sets the stem from stem_mode and fc1 from fc1_mode and
    nothing else from either, so two JAX calls give all four trees."""
    a = jquantize(flagship["jfolded"], flagship["act_max"], stem_mode="s2d", fc1_mode="int8")
    b = jquantize(flagship["jfolded"], flagship["act_max"], stem_mode="direct",
                  fc1_mode="bf16")
    out = {}
    for stem, fc1 in (("s2d", "int8"), ("s2d", "bf16"), ("direct", "int8"),
                      ("direct", "bf16")):
        qj = dict(a if stem == "s2d" else b)
        qj["head"] = {**qj["head"], "fc1": (a if fc1 == "int8" else b)["head"]["fc1"]}
        out[stem, fc1] = (qj, to_torch(qj))
    return out


def test_fold_and_folded_forward_match_jax(flagship):
    folded = fold.fold_flagship(flagship["port"].state_dict())
    ref = flagship["jfolded"]

    def close(got, want, path=""):
        if want is None:
            assert got is None
        elif isinstance(want, (dict, list)):
            items = want.items() if isinstance(want, dict) else enumerate(want)
            for k, v in items:
                close(got[k], v, f"{path}/{k}")
        else:
            w = np.asarray(want)
            assert got.shape == w.shape, path
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-5, err_msg=path)

    close(folded, ref)
    images = np.random.default_rng(2).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jfolded_forward)(ref, jnp.asarray(images)))
    got = fold.folded_forward(folded, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 7, 7, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def test_calibration_matches_jax(flagship):
    folded = to_torch(flagship["jfolded"])
    got = quant.calibrate_activations(folded, [torch.from_numpy(flagship["calib"])])
    want = flagship["act_max"]
    assert list(got) == quant.act_points(folded) and set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


@pytest.mark.parametrize("stem", ["s2d", "direct"])
@pytest.mark.parametrize("fc1", ["int8", "bf16"])
def test_quantize_folded_matches_jax(flagship, qparams, stem, fc1):
    qj, _ = qparams[stem, fc1]
    got = quant.quantize_folded(to_torch(flagship["jfolded"]), flagship["act_max"],
                                stem_mode=stem, fc1_mode=fc1)
    assert_trees(got, qj, exact=False, rtol=1e-6)
    # The port's q-params are JAX's bit for bit, constants included.
    assert_trees(got, qj, exact=True)


def _jax_stem(q, images):
    """engine.int8_forward's stem and max-pool, as the JAX engine runs them."""
    wq = q["stem"]["wq"]
    x = images if images.dtype != jnp.uint8 else jengine._normalize_if_uint8(images)
    if wq.shape[0] == 4:
        n, h, w, c = x.shape
        xs = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(
            n, h // 2, w // 2, 4 * c)
        acc = jax.lax.conv_general_dilated(
            jengine._quantize_input(xs, q["s_img"]), wq, (1, 1), [(2, 1), (2, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    else:
        acc = jengine._conv_i8(jengine._quantize_input(x, q["s_img"]), wq, stride=2, pad=3)
    return _jax_max_pool(jengine._requant(acc, q["stem"]["m"], q["stem"]["t"]))


def _jax_max_pool(x_q):
    """The JAX engine's 3x3/s2/p1 int8 max-pool after the stem."""
    return jax.lax.reduce_window(x_q, jnp.int8(-128), jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 ((0, 0), (1, 1), (1, 1), (0, 0)))


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool_wrapper_on_the_cpu_equals_jax_reduce_window(case):
    """``cuda_pool.max_pool_int8`` on a CPU tensor (its twin) against JAX's
    pool, on the cases its kernel is held to on the card."""
    x = pool_input(case)
    got = cuda_pool.max_pool_int8(x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_max_pool(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("stem", ["s2d", "direct"])
def test_int8_activations_match_jax_at_every_block(qparams, stem):
    qj, qp = qparams[stem, "int8"]
    u8 = np.random.default_rng(3).integers(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8)
    want = _jax_stem(qj, jnp.asarray(u8))
    if stem == "s2d":
        xs = cuda_stem.quant_s2d(torch.from_numpy(u8), qp["s_img"])
        got = engine.kernel_conv(xs, qp["stem"], 1, ((2, 1), (2, 1)), "relu")
    else:
        x_q = cuda_stem.quantize_input(engine._normalize_if_uint8(torch.from_numpy(u8)),
                                       qp["s_img"])
        got = engine.kernel_conv(x_q, qp["stem"], 2, 3, "relu")
    got = cuda_pool.max_pool_int8(got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg="stem")
    for si, (jblocks, pblocks) in enumerate(zip(qj["layers"], qp["layers"])):
        for bi, (jb, pb) in enumerate(zip(jblocks, pblocks)):
            stride = 2 if (si > 0 and bi == 0) else 1
            want = jengine._block_xla(want, jb, stride)
            got = engine._block(got, pb, stride)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"l{si + 1}b{bi}")
    for i, stride in ((1, 1), (2, 2), (3, 1), (4, 1)):
        jc = qj["head"][f"conv{i}"]
        want = jengine._requant(jengine._conv_i8(want, jc["wq"], stride, 1), jc["m"], jc["t"],
                                leaky=True)
        got = engine.kernel_conv(got, qp["head"][f"conv{i}"], stride, 1, "leaky")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"head{i}")


@pytest.mark.parametrize("stem", ["s2d", "direct"])
@pytest.mark.parametrize("fc1", ["int8", "bf16"])
def test_int8_grid_matches_jax(qparams, stem, fc1):
    qj, qp = qparams[stem, fc1]
    images = np.random.default_rng(4).normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jengine.int8_forward(qj, jnp.asarray(images)))
    got = engine.int8_forward(qp, torch.from_numpy(images))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("twins", [False, True], ids=["default", "twin overrides"])
def test_int8_forward_runs_the_stem_and_pool_wrappers_unless_overridden(qparams, monkeypatch,
                                                                        twins):
    """With no ``impl`` the engine's stem front and max-pool are the kernel
    wrappers (kernels on CUDA, twins on the CPU); the two keys override them."""
    _, qp = qparams["s2d", "int8"]
    calls = []
    twin_of = {cuda_stem: cuda_stem.quant_s2d_reference,
               cuda_pool: cuda_pool.max_pool_int8_reference}
    for module, name in ((cuda_stem, "quant_s2d"), (cuda_stem, "quant_s2d_reference"),
                         (cuda_pool, "max_pool_int8"), (cuda_pool, "max_pool_int8_reference")):
        def record(*args, _name=name, _twin=twin_of[module]):
            calls.append(_name)
            return _twin(*args)

        monkeypatch.setattr(module, name, record)
    impl = {"stem_front": cuda_stem.quant_s2d_reference,
            "max_pool": cuda_pool.max_pool_int8_reference} if twins else None
    u8 = np.random.default_rng(5).integers(0, 256, size=(1, SIZE, SIZE, 3), dtype=np.uint8)
    grid = engine.int8_forward(qp, torch.from_numpy(u8), impl=impl)
    want = ["quant_s2d_reference", "max_pool_int8_reference"] if twins else [
        "quant_s2d", "max_pool_int8"]
    assert calls == want and grid.shape == (1, 7, 7, 30)


class _JaxEngine:
    """The JAX int8 engine function behind predict_batch_arrays."""

    def __init__(self, fn, q):
        self.fn, self.q = fn, q

    def predict_batch_arrays(self, images, conf_threshold, nms_threshold):
        return self.fn(self.q, jnp.asarray(images), conf_threshold, nms_threshold)


@pytest.mark.parametrize("stem,fc1,wire", [("s2d", "int8", "uint8"), ("s2d", "bf16", "float32"),
                                           ("direct", "int8", "float32"),
                                           ("direct", "bf16", "uint8")])
def test_int8_detections_match_jax(qparams, stem, fc1, wire):
    qj, qp = qparams[stem, fc1]
    jfn = _JaxEngine(jengine.make_int8_engine_fn(7, 2, 20), qj)

    def make(seed):
        r = np.random.default_rng(seed)
        if wire == "uint8":
            return r.integers(0, 256, size=(4, SIZE, SIZE, 3), dtype=np.uint8)
        return r.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)

    images, thr = comparable_batch(jfn, 10, make)
    want = jfn.predict_batch_arrays(images, thr, NMS_T)
    port = engine.make_int8_engine_fn(7, 2, 20)
    got = port(qp, torch.from_numpy(images), thr, NMS_T)
    assert_same_detections(got, want)
    assert 0 < int(np.asarray(want.valid).sum())


# ------------------------------------------------------------------ artifacts
def _host(tree):
    """An engine's q-params as numpy, without the keys ``to_device`` derives."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items() if k not in engine.DERIVED_KEYS}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return None if tree is None else to_numpy(tree)


def _engine(flagship, **kw):
    return YOLOInference(flagship["port"], "cpu", image_size=SIZE, optimize="int8", **kw)


def test_jax_artifact_serves_in_the_port(flagship, qparams, tmp_path):
    qj, _ = qparams["s2d", "int8"]
    path = tmp_path / "jax_engine.npz"
    jexport.save_engine(path, qj, S=7, B=2, num_classes=20)
    jfn = _JaxEngine(jengine.make_int8_engine_fn(7, 2, 20), qj)
    make = lambda seed: np.random.default_rng(seed).integers(  # noqa: E731
        0, 256, size=(4, SIZE, SIZE, 3), dtype=np.uint8)
    images, thr = comparable_batch(jfn, 20, make)
    eng = _engine(flagship, engine_artifact=str(path))
    assert_same_detections(eng.predict_batch_arrays(images, thr, NMS_T),
                           jfn.predict_batch_arrays(images, thr, NMS_T))


def test_port_artifact_loads_in_jax(flagship, tmp_path):
    eng = _engine(flagship, calibration=[flagship["calib"]])
    path = tmp_path / "port_engine.npz"
    eng.save_engine(path)
    q_jax, meta = jexport.load_engine(path)
    assert (meta["S"], meta["B"], meta["num_classes"]) == (7, 2, 20)
    q_port, _ = export.load_engine(path)
    assert_trees(q_port, jax.tree.map(np.asarray, q_jax))
    # The artifact holds the engine's q-params, without its derived keys.
    assert_trees(q_port, _host(eng._int8_state["q"]))


def test_save_engine_requires_built_engine(flagship, tmp_path):
    with pytest.raises(RuntimeError, match="no built int8 engine"):
        _engine(flagship).save_engine(tmp_path / "never.npz")


def test_save_engine_calibration_gate(flagship, tmp_path):
    one = flagship["calib"][:1]
    eng = _engine(flagship)
    with pytest.warns(UserWarning, match="only 1 image"):
        eng.predict_batch_arrays(one, 0.05, NMS_T)  # lazy calibration
    with pytest.raises(RuntimeError, match="refusing to freeze"):
        eng.save_engine(tmp_path / "clipped.npz")
    eng.save_engine(tmp_path / "forced.npz", force=True)
    assert (tmp_path / "forced.npz").exists()

    eng2 = _engine(flagship, calibration=(b for b in [flagship["calib"]]))  # a generator
    assert eng2._int8_state["n_calib"] == YOLOInference.MIN_CALIB_IMAGES
    eng2.save_engine(tmp_path / "ok.npz")
    eng3 = _engine(flagship, engine_artifact=str(tmp_path / "ok.npz"))
    eng3.save_engine(tmp_path / "reexport.npz")  # a loaded artifact is exempt
    a, _ = export.load_engine(tmp_path / "ok.npz")
    b, _ = export.load_engine(tmp_path / "reexport.npz")
    assert_trees(a, _host(b))


def _write_images(folder, n, seed=7):
    folder.mkdir(exist_ok=True)
    r = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        paths.append(folder / f"img_{i}.jpg")
        Image.fromarray(r.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)).save(paths[-1])
    return [str(p) for p in paths]


def test_save_engine_gate_counts_real_images_not_padding(flagship, tmp_path):
    paths = _write_images(tmp_path / "three", 3)
    eng = _engine(flagship)
    with pytest.warns(UserWarning, match="only 3 image"):
        eng.predict_batch_files(paths, 0.05, NMS_T, batch_size=16)
    assert eng._int8_state["n_calib"] == 3
    assert "pending_valid" not in eng._int8_state
    with pytest.raises(RuntimeError, match="refusing to freeze"):
        eng.save_engine(tmp_path / "padded.npz")


def test_pending_valid_is_cleared_after_an_exception(flagship, tmp_path):
    good = _write_images(tmp_path / "good", 1)
    eng = _engine(flagship, calibration=[flagship["calib"]])
    with pytest.raises(FileNotFoundError):
        eng.predict_batch_files(good + [str(tmp_path / "missing.jpg")], 0.05, NMS_T,
                                batch_size=1)
    assert "pending_valid" not in eng._int8_state


def test_predict_cli_int8_on_the_cpu(flagship, tmp_path, capsys):
    from yolo_tpu_torch import predict

    ckpt = tmp_path / "small.pth"
    torch.save(flagship["port"].state_dict(), ckpt)
    _write_images(tmp_path / "images", 3)
    artifact = tmp_path / "engine.npz"
    base = ["--checkpoint", str(ckpt), "--image-dir", str(tmp_path / "images"),
            "--device", "cpu", "--conf-threshold=-1e9"]
    with pytest.warns(UserWarning, match="only 3 image"), pytest.raises(SystemExit,
                                                                        match="guidance"):
        predict.main([*base, "--output", str(tmp_path / "o1"), "--save-engine", str(artifact)])
    assert not artifact.exists()
    capsys.readouterr()
    with pytest.warns(UserWarning, match="only 3 image"):
        predict.main([*base, "--output", str(tmp_path / "o2"), "--int8", "--save-engine",
                      str(artifact), "--force-save-engine"])
    first = capsys.readouterr().out
    assert "int8 engine artifact saved" in first and artifact.exists()
    predict.main([*base, "--output", str(tmp_path / "o3"), "--engine", str(artifact)])
    second = capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "o3").iterdir()) == [
        f"img_{i}_pred.jpg" for i in range(3)]
    # The artifact serves the detections the calibrated engine served.
    strip = lambda out: [ln for ln in out.splitlines() if "saved" not in ln]  # noqa: E731
    assert strip(first) == strip(second)
