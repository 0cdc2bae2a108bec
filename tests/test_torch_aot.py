"""The port's AOT engine artifact held against its live engine and JAX's.

A small ResNet YOLOv1 (stages (1, 1, 1, 1) at 64x64, seeded random BN, fc2
scaled as ``test_torch_inference.randomize`` scales it) built into the
default int8 engine; both packages get the same q-params (the port's, as
numpy for JAX). The port's ``save_compiled_engine`` records the engine with
the stem front, every int8 conv and NMS as the custom ops of
``serving/library.py`` into a ``.pt2``; ``load_compiled_engine`` runs it.

- The loaded program equals the live engine bit for bit (same ops, same
  order).
- Against JAX's StableHLO artifact of the same q-params, on the same uint8
  images: ``valid`` and ``class_ids`` equal. Boxes and scores equal JAX's
  engine with its int8 forward run op by op (``test_torch_serving``'s
  reference) within the grid's float32 tolerance, ``1e-5*max|grid| +
  1e-6``. JAX's jitted engine, and so its artifact, rounds some int8
  activations otherwise than its own op-by-op forward (XLA:CPU fuses the
  requant's multiply and add), which moves a whole image's outputs by
  ~1e-3: every image where the port and JAX's artifact differ by more than
  that tolerance is one where JAX's artifact and its op-by-op forward do.
- The recorded graph calls the four ops (one ``conv_int8`` an int8 conv)
  and no convolution; each op passes ``torch.library.opcheck`` (the
  max-pool's at odd and tiny sizes).
- The refusals, and the serve CLI's ``--save-compiled`` / ``--compiled``.

Every artifact a test writes is deleted at its end.
"""

import json
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.ops.decode import decode_predictions as jdecode_predictions
from yolo_tpu.ops.nms import batched_nms as jbatched_nms
from yolo_tpu.serving import engine as jengine
from yolo_tpu.serving import export as jexport
from yolo_tpu_torch import serve
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.ops import cuda_nms
from yolo_tpu_torch.ops.decode import decode_predictions
from yolo_tpu_torch.serving import engine, export, library

from test_torch_inference import FC2_SCALE, comparable_batch
from test_torch_serving import _JaxEngine, to_numpy

STAGES = (1, 1, 1, 1)
SIZE = 64
NMS_T = 0.4
BATCH = 4
# The small engine's int8 convs: the stem, three a block and each stage's
# downsample, the four head convs and int8 fc1.
N_CONVS = 1 + 3 * sum(STAGES) + len(STAGES) + 4 + 1


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: an artifact is tens of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _small_model():
    """Seeded weights; random eval BN and fc2 as test_torch_inference.randomize
    sets them, so that scores are O(1) and NMS has overlaps to suppress."""
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE, generator=torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    with torch.no_grad():
        for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
            c = bn.num_features
            for t, v in ((bn.weight, r.uniform(0.5, 1.5, c)), (bn.bias, r.normal(0, 0.1, c)),
                         (bn.running_mean, r.normal(0, 0.1, c)),
                         (bn.running_var, r.uniform(0.5, 1.5, c))):
                t.copy_(torch.from_numpy(v.astype(np.float32)))
        fc2 = model.head.fc_layers[4]
        fc2.weight.mul_(FC2_SCALE)
        fc2.bias.mul_(FC2_SCALE)
        grid_bias = fc2.bias.view(7, 7, 30)
        grid_bias[..., [2, 3, 7, 8]] += 0.4
        grid_bias[..., 10:13] += 1.0
    return model


def _jax_tree(tree):
    """The port's q-params, without the keys ``to_device`` derives, for JAX."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items() if k not in engine.DERIVED_KEYS}
    if isinstance(tree, list):
        return [_jax_tree(v) for v in tree]
    return None if tree is None else jnp.asarray(to_numpy(tree))


@pytest.fixture(scope="module")
def aot(tmp_path_factory):
    """Both packages' AOT artifacts of one engine at batch 4, uint8 wire,
    with a threshold that keeps every score and IoU off its decision edge."""
    calib = np.random.default_rng(1).normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    live, q = engine.build_int8_predict(_small_model(), [torch.from_numpy(calib)])
    qj = _jax_tree(q)
    jfn = _JaxEngine(jengine.make_int8_engine_fn(7, 2, 20), qj)
    images, thr = comparable_batch(jfn, 30, lambda seed: np.random.default_rng(seed).integers(
        0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8))
    root = tmp_path_factory.mktemp("aot")
    paths = {"port": root / "engine.pt2", "jax": root / "jax_aot.npz",
             "plain": root / "engine.npz"}
    kw = dict(batch_size=BATCH, conf_threshold=thr, nms_threshold=NMS_T, image_size=SIZE)
    try:
        export.save_compiled_engine(paths["port"], q, 7, 2, 20, **kw)
        jexport.save_compiled_engine(paths["jax"], qj, 7, 2, 20, platforms=("cpu",), **kw)
        export.save_engine(paths["plain"], q, 7, 2, 20)
        yield {"paths": paths, "images": images, "thr": thr, "q": q, "qj": qj,
               "live": lambda x: live(q, torch.as_tensor(x), thr, NMS_T),
               "loaded": export.load_compiled_engine(paths["port"]),
               "jax_loaded": jexport.load_compiled_engine(paths["jax"])}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_artifact_equals_the_live_engine_bit_for_bit(aot):
    predict, _ = aot["loaded"]
    got = predict(torch.from_numpy(aot["images"]))
    want = aot["live"](aot["images"])
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(want.valid.sum()) > 0


def test_artifact_agrees_with_the_jax_aot_artifact(aot):
    images = aot["images"]
    predict, _ = aot["loaded"]
    got = predict(torch.from_numpy(images))
    jpredict, _ = aot["jax_loaded"]
    want = jpredict(images)
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.class_ids.numpy(), np.asarray(want.class_ids))

    # JAX's engine with its int8 forward op by op, then its decode and NMS.
    grid = jengine.int8_forward(aot["qj"], jnp.asarray(images))
    ref = jax.jit(lambda g: jbatched_nms(jdecode_predictions(g, 7, 2, 20, aot["thr"]), NMS_T))(
        grid)
    # The grid's tolerance (test_torch_serving: float32 FC sums in another
    # order), carried to the products and sums of the decode.
    atol = 1e-5 * float(np.abs(np.asarray(grid)).max()) + 1e-6
    for name in ("boxes", "scores"):
        port, jax_aot = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        op_by_op = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(port, op_by_op, rtol=0, atol=atol, err_msg=name)
        per_image = lambda a, b: np.abs(a - b).reshape(BATCH, -1).max(1)
        off_jax_aot = per_image(port, jax_aot) > atol
        jit_rounding = per_image(op_by_op, jax_aot) > atol
        np.testing.assert_array_equal(off_jax_aot, jit_rounding, err_msg=name)


def test_artifact_meta(aot):
    _, meta = aot["loaded"]
    _, jmeta = aot["jax_loaded"]
    shared = ("aot_format_version", "S", "B", "num_classes", "batch_size", "image_size",
              "conf_threshold", "nms_threshold", "dtype", "platforms")
    assert {k: meta[k] for k in shared} == {k: jmeta[k] for k in shared}
    assert meta["platforms"] == ["cpu"] and meta["dtype"] == "uint8"
    assert meta["torch_version"] == torch.__version__
    assert (meta["batch_size"], meta["image_size"], meta["conf_threshold"]) == (
        BATCH, SIZE, aot["thr"])


def test_artifact_graph_runs_the_three_ops(aot):
    exported = torch.export.load(aot["paths"]["port"])
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("yolo_tpu_torch.conv_int8.default") == N_CONVS
    assert targets.count("yolo_tpu_torch.quant_s2d.default") == 1
    assert targets.count("yolo_tpu_torch.max_pool_int8.default") == 1
    assert targets.count("yolo_tpu_torch.nms_keep.default") == 1
    assert not [t for t in targets if "conv" in t and not t.startswith("yolo_tpu_torch.")]
    # Each weight is held once, in the form the engine reads (fc2: float32).
    held = exported.state_dict
    assert "head/fc2/wf" in held and "head/fc2/w" not in held
    assert held["head/fc1/wq"].dtype == torch.int8


def _opcheck_cases():
    g = np.random.default_rng(0)

    def ints(*shape):
        return torch.from_numpy(g.integers(-127, 128, shape, dtype=np.int8))

    def floats(*shape):
        return torch.from_numpy(g.uniform(1e-3, 2e-3, shape).astype(np.float32))

    x, wq, m, t = ints(2, 5, 7, 16), ints(3, 3, 16, 8), floats(8), floats(8)
    grid = torch.from_numpy(g.normal(size=(2, 7, 7, 30)).astype(np.float32))
    return {
        "quant_s2d": (library.quant_s2d, (torch.from_numpy(
            g.integers(0, 256, (2, 8, 6, 3), dtype=np.uint8)), torch.tensor(0.02))),
        "conv_int8-residual": (library.conv_int8, (x, wq, m, t, None, ints(2, 3, 4, 8),
                                                   torch.tensor(0.5), 2, [2, 1, 2, 1],
                                                   "residual")),
        "conv_int8-float": (library.conv_int8, (x, wq, m, t, None, None, None, 1,
                                                [1, 1, 1, 1], "float")),
        "nms_keep": (library.nms_keep, cuda_nms.keep_args(
            decode_predictions(grid, 7, 2, 20, 0.0), NMS_T, 1e-6)),
        # opcheck holds the fake's shape to the real op's: odd and tiny sizes.
        "max_pool_int8-7x9": (library.max_pool_int8, (ints(2, 7, 9, 16),)),
        "max_pool_int8-2x3": (library.max_pool_int8, (ints(3, 2, 3, 16),)),
        "max_pool_int8-1x1": (library.max_pool_int8, (ints(1, 1, 1, 64),)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_op_passes_opcheck(case):
    op, args = _opcheck_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_default_and_aot_impl_carry_the_stem_front_and_max_pool():
    """``aot_impl`` overrides exactly the two stages ``int8_forward`` runs
    through the kernel wrappers by default, with the custom ops."""
    aot = library.aot_impl()
    assert set(aot) == {"stem_front", "max_pool"}
    assert aot["stem_front"] == torch.ops.yolo_tpu_torch.quant_s2d
    assert aot["max_pool"] == torch.ops.yolo_tpu_torch.max_pool_int8


def _meta_only(path, meta):
    """A zip holding only an AOT meta entry: the loader reads it first."""
    with zipfile.ZipFile(path, "w") as archive:
        archive.writestr(f"engine/extra/{export.AOT_META}", json.dumps(meta))
    return path


@pytest.mark.parametrize("case", ["plain npz", "jax stablehlo", "newer format",
                                  "other device", "pt2 as npz"])
def test_loaders_refuse(aot, tmp_path, case):
    paths = aot["paths"]
    if case == "plain npz":
        with pytest.raises(ValueError, match="not a yolo-tpu AOT engine artifact"):
            export.load_compiled_engine(paths["plain"])
    elif case == "jax stablehlo":
        with pytest.raises(ValueError, match=r"torch cannot\s+run.*--save-compiled"):
            export.load_compiled_engine(paths["jax"])
    elif case == "newer format":
        path = _meta_only(tmp_path / "newer.pt2", {"aot_format_version": 2,
                                                   "platforms": ["cpu"]})
        with pytest.raises(ValueError, match="format 2 is newer"):
            export.load_compiled_engine(path)
    elif case == "other device":
        with pytest.raises(ValueError, match=r"\['cpu'\], not for 'cuda'"):
            export.load_compiled_engine(paths["port"], "cuda")
    else:
        with pytest.raises(ValueError, match="is an AOT engine artifact"):
            export.load_engine(paths["port"])


@pytest.mark.parametrize("case", ["winograd", "platforms", "dtype"])
def test_save_refuses(aot, tmp_path, case):
    q, kw = aot["q"], {}
    if case == "winograd":
        head = q["head"]
        q = {**q, "head": {**head, "conv1": {**head["conv1"], "wino": True}}}
        match = r"Winograd convs \('head_conv1',\) have no custom op"
    elif case == "platforms":
        kw, match = {"platforms": ("tpu", "cpu")}, "holds the program for one device type"
    else:
        kw, match = {"dtype": np.int16}, "dtype must be uint8 or float32"
    with pytest.raises(ValueError, match=match):
        export.save_compiled_engine(tmp_path / "never.pt2", q, 7, 2, 20, batch_size=1,
                                    conf_threshold=0.5, nms_threshold=NMS_T,
                                    image_size=SIZE, **kw)
    assert not (tmp_path / "never.pt2").exists()


def test_serve_cli_saves_then_serves_the_artifact(aot, tmp_path, capsys):
    """--engine X.npz --save-compiled Y.pt2 writes the artifact at the largest
    bucket; --compiled Y.pt2 serves that one bucket with the baked
    thresholds, noting an explicit flag that differs."""
    thr, pt2 = aot["thr"], tmp_path / "served.pt2"
    args = serve.parse_args(["--engine", str(aot["paths"]["plain"]), "--device", "cpu",
                             "--image-size", str(SIZE), "--buckets", "1,2",
                             f"--conf-threshold={thr!r}", "--save-compiled", str(pt2)])
    assert args.nms_threshold is None
    _, buckets, _ = serve.build_predict(args)
    assert buckets == (1, 2)
    assert f"AOT engine artifact saved to {pt2}" in capsys.readouterr().out

    args = serve.parse_args(["--compiled", str(pt2), "--device", "cpu",
                             "--nms-threshold", "0.5", f"--conf-threshold={thr!r}"])
    predict, buckets, image_size = serve.build_predict(args)
    out = capsys.readouterr().out
    assert "note: --nms-threshold ignored — the AOT artifact bakes nms_threshold=0.4" in out
    assert "conf-threshold" not in out
    assert buckets == (2,) and image_size == SIZE
    images = aot["images"][:2]
    got, want = predict(torch.from_numpy(images)), aot["live"](images)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_serve_cli_refuses_a_float32_wire_artifact(aot, tmp_path):
    pt2 = tmp_path / "float.pt2"
    export.save_compiled_engine(pt2, aot["q"], 7, 2, 20, batch_size=1, conf_threshold=0.5,
                                nms_threshold=NMS_T, image_size=SIZE, dtype=np.float32)
    args = serve.parse_args(["--compiled", str(pt2), "--device", "cpu"])
    with pytest.raises(SystemExit, match="requires a uint8-wire AOT artifact"):
        serve.build_predict(args)
