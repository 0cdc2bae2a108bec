"""The int8 engine's stage-chain hooks held against the JAX package's.

A small ResNet YOLOv1 with two blocks per stage (so every stage has a chain:
layer1's two blocks with its downsample, and block 1 of layers 2-4) at
64x64, seeded random BN as in tests/test_torch_serving.py, quantized by the
JAX package; the port runs the same q-params.

- Every stage's int8 output, with ``impl["layer1".."layer4"]`` =
  ``chain_int8`` in the port and ``chain_pallas`` (interpret mode) in JAX,
  is equal bit for bit. JAX's interpret-mode chain runs on every stage here
  (layer3's 4x4 and layer4's 2x2 padded to 32 columns with ``real_w``), so
  no stage needs JAX's default engine as its reference instead.
- The grids agree within ``1e-5*max|ref| + 1e-6`` (the float32 FC tail sums
  in another order, as in tests/test_torch_serving.py), the port's chained
  grid equals its default grid bit for bit, and the detections are equal.
- Routing: the hook receives layer1's whole stage and ``blocks[1:]``
  elsewhere, and is skipped for a stage of only its transition block.
"""

from functools import partial

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
from yolo_tpu.serving import fold_flagship as jfold
from yolo_tpu.serving import quantize_folded as jquantize
from yolo_tpu.serving.pallas_int8 import chain_pallas
from yolo_tpu_torch.serving import cuda_bottleneck as cb
from yolo_tpu_torch.serving import engine

from test_torch_inference import assert_same_detections, comparable_batch, randomize
from test_torch_serving import _JaxEngine, to_torch

STAGES = (2, 2, 2, 2)
SIZE = 64
NMS_T = 0.4
LAYERS = [f"layer{i}" for i in range(1, 5)]


@pytest.fixture(scope="module")
def q():
    """JAX's q-params of the two-block flagship, and the port's copy."""
    jmodel = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    variables = randomize(init_model(jmodel, jax.random.PRNGKey(5), image_size=SIZE))
    calib = np.random.default_rng(11).normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)
    folded = jfold(variables)
    qj = jquantize(folded, jcalibrate(folded, [jnp.asarray(calib)]))
    return qj, to_torch(qj)


def _images(seed, n=3):
    return np.random.default_rng(seed).integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)


def test_stage_outputs_and_grid_match_jax(q):
    qj, qp = q
    images = _images(12)
    seen_j, seen_p = {}, {}

    def jax_hook(name):
        def fn(x, qblocks, real_w=None):
            out = chain_pallas(x, qblocks, real_w=real_w, interpret=True)
            seen_j[name] = np.asarray(out if real_w is None else out[:, :, :real_w])
            return out
        return fn

    def port_hook(name):
        def fn(x, qblocks):
            out = cb.chain_int8(x, qblocks)
            seen_p[name] = out.numpy()
            return out
        return fn

    want = np.asarray(jengine.int8_forward(qj, jnp.asarray(images),
                                           impl={n: jax_hook(n) for n in LAYERS}))
    impl = {**engine.default_impl(), **{n: port_hook(n) for n in LAYERS}}
    got = engine.int8_forward(qp, torch.from_numpy(images), impl=impl)
    assert list(seen_p) == list(seen_j) == LAYERS
    for name in LAYERS:
        np.testing.assert_array_equal(seen_p[name], seen_j[name], err_msg=name)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max() + 1e-6)
    default = engine.int8_forward(qp, torch.from_numpy(images), impl=engine.default_impl())
    assert torch.equal(got, default)


def test_chained_detections_match_jax(q):
    qj, qp = q
    jimpl = {n: partial(chain_pallas, interpret=True) for n in LAYERS}
    jfn = _JaxEngine(jengine.make_int8_engine_fn(7, 2, 20, impl=jimpl), qj)
    images, thr = comparable_batch(jfn, 13, lambda seed: _images(seed, 4))
    want = jfn.predict_batch_arrays(images, thr, NMS_T)
    impl = {**engine.default_impl(), **{n: cb.chain_int8 for n in LAYERS}}
    port = engine.make_int8_engine_fn(7, 2, 20, impl=impl)
    got = port(qp, torch.from_numpy(images), thr, NMS_T)
    assert_same_detections(got, want)
    assert 0 < int(np.asarray(want.valid).sum())


def test_stage_chain_routing(q):
    _, qp = q
    images = torch.from_numpy(_images(14, 2))
    calls = []

    def hook(name):
        def fn(x, qblocks):
            calls.append((name, tuple(x.shape), len(qblocks),
                          [qb["downsample"] is not None for qb in qblocks]))
            return cb.chain_int8_reference(x, qblocks)
        return fn

    impl = {**engine.default_impl(), **{n: hook(n) for n in LAYERS}}
    got = engine.int8_forward(qp, images, impl=impl)
    assert calls == [("layer1", (2, 16, 16, 64), 2, [True, False]),
                     ("layer2", (2, 8, 8, 512), 1, [False]),
                     ("layer3", (2, 4, 4, 1024), 1, [False]),
                     ("layer4", (2, 2, 2, 2048), 1, [False])]
    assert torch.equal(got, engine.int8_forward(qp, images, impl=engine.default_impl()))

    # Layers 2-4 cut to their transition blocks: the hook runs for layer1 only.
    calls.clear()
    cut = {**qp, "layers": [qp["layers"][0]] + [blocks[:1] for blocks in qp["layers"][1:]]}
    got = engine.int8_forward(cut, images, impl=impl)
    assert [c[0] for c in calls] == ["layer1"]
    assert torch.equal(got, engine.int8_forward(cut, images, impl=engine.default_impl()))
