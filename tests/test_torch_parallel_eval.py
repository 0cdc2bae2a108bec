"""The sharded evaluator and the sharded int8 engine on a (2, 1) gloo world.

Two CPU ranks (``torch_parallel_worker.task_eval``) against the test
process: ``evaluate_model(mesh=...)`` gives all 77 keys ``==`` the port's
single-process run on both paths (batches of 4, the last ragged: the
second data rank's last row is padding), and, fed JAX's own grids, ``==``
JAX's ``evaluate_model(mesh=...)`` on a (2, 1) mesh (inputs from
``test_torch_metrics``, which have no IoU or score on a threshold).
``make_sharded_int8_engine_fn`` on JAX's q-params: each rank's detections
equal the single-process engine's on its rows bit for bit, and the gathered
ones JAX's ``make_sharded_int8_engine_fn``'s within
``test_serving.py:544-580``'s bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
from test_torch_inference import comparable_batch, randomize
from test_torch_metrics import slice_batches
from test_torch_serving import NMS_T, _JaxEngine, to_torch
from yolo_tpu.data.transforms import device_normalize
from yolo_tpu.metrics import evaluate_model as j_evaluate_model
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu.parallel import make_mesh
from yolo_tpu.parallel.mesh import put_sharded
from yolo_tpu.serving import calibrate_activations as jcalibrate
from yolo_tpu.serving import engine as jengine
from yolo_tpu.serving import fold_flagship as jfold
from yolo_tpu.serving import quantize_folded as jquantize
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.metrics import evaluate_model

SIZE, C = 64, 20


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jmodel = JYOLOv1(num_classes=C, S=7, B=2, backbone=JResNet(stage_sizes=W.STAGES))
    variables = randomize(init_model(jmodel, jax.random.PRNGKey(0), image_size=SIZE))
    state_dict = state_dict_from_jax(variables)
    batches = slice_batches(SIZE, "uint8")
    apply = jax.jit(lambda x: jmodel.apply(variables, x, train=False))
    grids = []
    for images, _ in batches:  # JAX's grids of the padded batches
        padded = np.zeros((4, *images.shape[1:]), images.dtype)
        padded[:len(images)] = images
        grids.append(np.asarray(apply(device_normalize(jnp.asarray(padded)))))

    calib = np.random.default_rng(1).normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)
    qj = jquantize(jfold(variables), jcalibrate(jfold(variables), [jnp.asarray(calib)]))
    jfn = _JaxEngine(jengine.make_int8_engine_fn(7, 2, C), qj)

    def make(seed):
        return np.random.default_rng(seed).integers(0, 256, size=(4, SIZE, SIZE, 3),
                                                    dtype=np.uint8)

    images, thr = comparable_batch(jfn, 20, make)
    workdir = tmp_path_factory.mktemp("eval21")
    torch.save(dict(state_dict=state_dict, batches=batches, batch_size=4, grids=grids,
                    q=to_torch(qj), engine_images=images, thr=thr), workdir / "inputs.pt")
    handle = W.start("eval", 2, 1, workdir)
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    loader = W.ListLoader(batches, 4)
    ref = {"jax_keys": j_evaluate_model(jmodel, variables, loader, num_classes=C, S=7, B=2,
                                        verbose=False, mesh=mesh),
           "jax_dets": jengine.make_sharded_int8_engine_fn(mesh, 7, 2, C)(
               qj, put_sharded(mesh, images), thr, NMS_T)}
    torch.set_num_threads(1)
    port = W.tiny_model(state_dict)
    ref["keys"] = {p: evaluate_model(port, loader, verbose=False, device="cpu", precise=p)
                   for p in (True, False)}
    return W.finish(handle), ref


@pytest.mark.parametrize("precise", [True, False], ids=["precise", "fast"])
def test_sharded_evaluate_equals_one_process(world, precise):
    outs, ref = world
    want = ref["keys"][precise]
    assert len(want) == 77 and want["mAP50"] > 0
    for out in outs:
        assert out["keys"][precise] == want


def test_sharded_evaluate_on_jax_grids_equals_jax_meshed(world):
    outs, ref = world
    assert len(ref["jax_keys"]) == 77
    for out in outs:
        assert out["jax_grid_keys"] == ref["jax_keys"]


def test_sharded_int8_engine(world):
    outs, ref = world
    want = ref["jax_dets"]
    for out in outs:
        assert out["local_equal"]
        got = out["gathered"]
        valid = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), valid)
        np.testing.assert_array_equal(got.class_ids.numpy()[valid],
                                      np.asarray(want.class_ids)[valid])
        np.testing.assert_allclose(got.scores.numpy()[valid], np.asarray(want.scores)[valid],
                                   rtol=1e-5)
        np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(want.boxes)[valid],
                                   rtol=1e-4, atol=1e-6)
    assert 0 < int(np.asarray(want.valid).sum())
