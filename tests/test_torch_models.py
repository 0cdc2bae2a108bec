"""The port's ResNet YOLOv1 held against the JAX model on the same weights.

A JAX ``YOLOv1`` over ``ResNetBackbone(stage_sizes=(1, 1, 1, 1))`` is
initialised at 64x64 in float32, its BatchNorm parameters and statistics are
replaced by seeded random values (so BN arithmetic matters), and its
variables are converted with ``state_dict_from_jax``. Outputs on the same
seeded NHWC images must agree within ``atol = 1e-4 * max|ref| + 1e-5``: the
two sides round differently in BN (JAX computes ``(x - mean) * (rsqrt(var +
eps) * scale) + bias``, yolo_tpu/models/layers.py:259-262, torch folds it
into one scale and shift) and sum the convolutions in another order, so a
few float32 ulps per layer accumulate over the ~20 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.convert import convert_reference_state_dict
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu_torch.convert import model_layout, state_dict_from_jax
from yolo_tpu_torch.models import create_model, head_feature_size

STAGES = (1, 1, 1, 1)
SIZE = 64


def randomize_bn(variables, seed=0):
    """Seeded random BN scale/bias/mean/var, so eval BN is not the identity."""
    r = np.random.default_rng(seed)

    def walk(params, stats):
        for key, node in params.items():
            if key == "BatchNorm_0":
                c = node["scale"].shape[0]
                node["scale"] = r.uniform(0.5, 1.5, c).astype(np.float32)
                node["bias"] = r.normal(0, 0.1, c).astype(np.float32)
                stats[key]["mean"] = r.normal(0, 0.1, c).astype(np.float32)
                stats[key]["var"] = r.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(node, dict) and key in stats:
                walk(node, stats[key])

    variables = jax.tree.map(np.array, variables)
    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def jax_model():
    model = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    variables = init_model(model, jax.random.PRNGKey(0), image_size=SIZE)
    return model, randomize_bn(variables)


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, variables = jax_model
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


def test_forward_matches_jax(jax_model, port_model):
    model, variables = jax_model
    x = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (2, 7, 7, 30)
    atol = 1e-4 * np.abs(ref).max() + 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    # channels_last memory (the GPU layout) computes the same function.
    cl = port_model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got_cl = cl(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    port_model.to(memory_format=torch.contiguous_format)
    np.testing.assert_allclose(got_cl, ref, rtol=0, atol=atol)


def test_state_dict_round_trips_to_jax_variables(jax_model, port_model):
    _, variables = jax_model
    # The head map is 1x1 at 64x64; convert_reference_state_dict's S is the
    # side of that map (7 only at 448x448).
    back = convert_reference_state_dict(port_model.state_dict(), S=1)
    flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_parameter_names_are_the_reference_layout(port_model):
    names = set(port_model.state_dict())
    for key in ("backbone.extractor.0.weight", "backbone.extractor.1.running_var",
                "backbone.extractor.4.0.downsample.0.weight",
                "backbone.extractor.7.0.conv2.weight",
                "head.conv_layers.6.bias", "head.fc_layers.1.weight",
                "head.fc_layers.4.bias"):
        assert key in names, key
    assert model_layout(port_model.state_dict()) == {
        "backbone": "resnet", "stage_sizes": STAGES, "image_size": SIZE}
    assert head_feature_size(448, 4) == 7 and head_feature_size(SIZE, 4) == 1


def test_seeded_init_is_reproducible_and_torch_default():
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return create_model("resnet", 20, 7, 2, device="cpu", generator=g,
                            stage_sizes=STAGES, image_size=SIZE)

    a, b, c = build(3), build(3), build(4)
    wa, wb, wc = (m.head.conv_layers[0].weight.detach() for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    bound = 1.0 / np.sqrt(wa[0].numel())
    assert float(wa.abs().max()) <= bound and float(wa.abs().max()) > 0.9 * bound
    assert not a.training
    yolov1 = create_model("yolov1", device="cpu", image_size=SIZE)
    assert type(yolov1.backbone).__name__ == "YOLOv1Backbone"
    assert yolov1.head[1].in_features == 1024 and not yolov1.training
