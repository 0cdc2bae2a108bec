"""The dynamic-int8 ``quantized=True`` variant held against JAX's ``_Int8ConvCore``.

Per conv geometry of the two models (the 24-conv stack's convs with bias,
the ResNet's without, strides 1 and 2, 7x7 / 3x3 / 1x1), on seeded numpy
inputs and weights: JAX's ``Conv(quantized=True)`` runs eagerly with its
``lax.conv_general_dilated`` recorded, so its int8 operands and int32
accumulator are read from JAX's own call; the port's ``x_q``, ``w_q`` and
accumulator (``conv_int8`` in mode ``"acc"``) equal them exactly, and its
output is within 1 float32 ulp of JAX's (the same two roundings,
``float(acc) * m`` then ``+ bias``; an XLA fusion may contract them into
one FMA).

The models: the quantized ResNet (1, 1, 1, 1) and 24-conv YOLOv1 at 64x64 on
JAX's weights (seeded random BN for the ResNet) against JAX's quantized
models, jitted, within 1e-3 of max|ref|. Both sides quantize every conv's
input afresh, so a float32 difference upstream (BN's op order, XLA's
fusions) can move a value across a rounding boundary and one int8 level;
JAX's own jitted and eager forwards differ by 2.5e-4 of max|ref| on the
ResNet for that reason. Against the float32 model the grid stays under
JAX's own bar, max|d| / max|fp32| < 0.05 (tests/test_models.py:132-157).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_tpu.models.layers as jax_layers
from test_torch_cuda import DYNQ_CASES, dynq_input
from test_torch_models import randomize_bn
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.models.layers import Int8Conv2d, quantize_input
from yolo_tpu_torch.models.backbones import yolov1_conv_inputs
from yolo_tpu_torch.serving import cuda_dynq, cuda_int8
from yolo_tpu_torch.utils import kernels

STAGES, SIZE = (1, 1, 1, 1), 64


class _RecordingLax:
    """``jax.lax`` with ``conv_general_dilated``'s operands and result kept."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def conv_general_dilated(self, *args, **kwargs):
        out = jax.lax.conv_general_dilated(*args, **kwargs)
        self.calls.append(tuple(np.asarray(a) for a in (args[0], args[1], out)))
        return out


# (cin, cout, kernel, stride, padding, bias, input side)
GEOMETRIES = {
    "yolov1 stem 7x7/s2": (3, 64, 7, 2, 3, True, 24),
    "resnet stem 7x7/s2": (3, 64, 7, 2, 3, False, 24),
    "1x1 bias": (16, 32, 1, 1, 0, True, 8),
    "3x3 bias": (16, 32, 3, 1, 1, True, 9),
    "3x3/s2 bias": (32, 16, 3, 2, 1, True, 9),
    "1x1 no bias": (32, 16, 1, 1, 0, False, 8),
    "3x3/s2 no bias": (16, 16, 3, 2, 1, False, 10),
    "1x1/s2 no bias": (16, 64, 1, 2, 0, False, 8),
}


@pytest.mark.parametrize("name", GEOMETRIES)
def test_conv_matches_jax_int8_core(name, monkeypatch):
    cin, cout, k, s, p, bias, h = GEOMETRIES[name]
    r = np.random.default_rng(sorted(GEOMETRIES).index(name))
    x = (r.normal(size=(2, h, h, cin)) * 3).astype(np.float32)
    kernel = (r.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (r.normal(size=cout) * 0.1).astype(np.float32)
    rec = _RecordingLax()
    monkeypatch.setattr(jax_layers, "lax", rec)
    params = {"Conv_0": {"kernel": kernel, **({"bias": b} if bias else {})}}
    ref = np.asarray(jax_layers.Conv(cout, k, s, p, use_bias=bias, quantized=True).apply(
        {"params": params}, jnp.asarray(x)))
    (xq_ref, wq_ref, acc_ref), = rec.calls

    conv = Int8Conv2d(cin, cout, k, s, p, bias=bias).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = conv(xt).permute(0, 2, 3, 1).numpy()
        wq, s_w, wk, c127 = conv.quantized_weight()
        xq, _ = quantize_input(xt, c127)
        acc = cuda_int8.conv_int8(xq, wq, s_w, s_w, s, p, "acc")
    assert wk is None  # packed only for the kernel, on CUDA
    np.testing.assert_array_equal(xq.numpy(), xq_ref)
    np.testing.assert_array_equal(wq.numpy(), wq_ref)
    assert acc.dtype == torch.int32 and acc_ref.dtype == np.int32
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def test_weight_cache_follows_in_place_updates():
    conv = Int8Conv2d(8, 16, 3, 1, 1).eval()
    first = conv.quantized_weight()
    assert conv.quantized_weight()[0] is first[0]
    with torch.no_grad():
        conv.weight.mul_(-1)
    again = conv.quantized_weight()
    assert torch.equal(again[0], -first[0]) and torch.equal(again[1], first[1])


def test_inference_only_and_no_kernel_launch_on_the_cpu():
    conv = Int8Conv2d(8, 16, 3, 1, 1)
    with pytest.raises(RuntimeError, match="inference only"):
        conv.train()(torch.ones(1, 8, 5, 5))
    before = kernels.LAUNCHES["yolo_int8_conv"], kernels.LAUNCHES["yolo_dynq"]
    conv.eval()(torch.ones(1, 8, 5, 5))
    assert (kernels.LAUNCHES["yolo_int8_conv"], kernels.LAUNCHES["yolo_dynq"]) == before


def _dynq_numpy(x):
    """csrc/dyn_quant.cu's arithmetic restated in numpy float32: an exact max,
    IEEE divisions, rint's half to even."""
    a = x.permute(0, 2, 3, 1).float().numpy()
    s = np.maximum(np.abs(a).max() / np.float32(127), np.float32(1e-8))
    return np.clip(np.rint(a / s), -127, 127).astype(np.int8), s


@pytest.mark.parametrize("case", DYNQ_CASES)
def test_quantize_input_runs_the_plain_twin_on_the_cpu(case):
    """On CPU tensors ``quantize_input`` is the eager twin (no launch), and
    the twin is the kernel's arithmetic, on the edge cases the CUDA tests
    hold the kernel to."""
    x = dynq_input(case)
    c127 = torch.tensor(127.0)
    before = kernels.LAUNCHES["yolo_dynq"]
    xq, s_x = quantize_input(x, c127)
    assert kernels.LAUNCHES["yolo_dynq"] == before
    ref_q, ref_s = cuda_dynq.quantize_reference(x, c127)
    assert torch.equal(xq, ref_q) and torch.equal(s_x, ref_s)
    want_q, want_s = _dynq_numpy(x)
    assert s_x.dtype == torch.float32 and s_x.item() == want_s
    np.testing.assert_array_equal(xq.numpy(), want_q)


@pytest.mark.parametrize("n, grid", [(1, 1), (4096, 1), (4097, 2), (1024 * 49, 13),
                                     (64 * 1024 * 49, 528), (64 * 8329216, 528)])
def test_dynq_grid_follows_the_element_count(n, grid):
    assert cuda_dynq.blocks(n) == grid


def test_yolov1_conv_inputs():
    shapes = yolov1_conv_inputs(448)
    assert len(shapes) == 24 and shapes[0] == (3, 448, 448) and shapes[-1] == (1024, 7, 7)
    assert sum(c * h * w for c, h, w in shapes) == 8329216
    assert yolov1_conv_inputs(64)[-1] == (1024, 1, 1)


def _jax_models(backbone):
    if backbone == "resnet":
        return (JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES)),
                JYOLOv1(num_classes=20, S=7, B=2,
                        backbone=JResNet(stage_sizes=STAGES, quantized=True), quantized=True))
    return JYOLOv1(num_classes=20, S=7, B=2), JYOLOv1(num_classes=20, S=7, B=2, quantized=True)


@pytest.fixture(scope="module", params=["resnet", "yolov1"])
def models(request):
    backbone = request.param
    fp, quant = _jax_models(backbone)
    variables = init_model(fp, jax.random.PRNGKey(0), image_size=SIZE)
    variables = randomize_bn(variables) if backbone == "resnet" else jax.tree.map(
        np.asarray, variables)
    port = {q: create_model(backbone, 20, 7, 2, device="cpu", stage_sizes=STAGES,
                            image_size=SIZE, quantized=q) for q in (False, True)}
    for model in port.values():
        model.load_state_dict(state_dict_from_jax(variables))
    return backbone, fp, quant, variables, port


def test_quantized_model_matches_jax_and_stays_near_fp32(models):
    backbone, fp, quant, variables, port = models
    x = np.random.default_rng(3).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    ref_q = np.asarray(jax.jit(quant.apply)(variables, jnp.asarray(x)))
    ref_fp = np.asarray(jax.jit(fp.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got_q, got_fp = port[True](xt).numpy(), port[False](xt).numpy()
    assert got_q.shape == ref_q.shape == (2, 7, 7, 30)
    np.testing.assert_allclose(got_q, ref_q, rtol=0, atol=1e-3 * np.abs(ref_q).max())
    assert np.abs(got_q - got_fp).max() / np.abs(got_fp).max() < 0.05
    assert np.abs(ref_q - ref_fp).max() / np.abs(ref_fp).max() < 0.05
    n_int8 = sum(isinstance(m, Int8Conv2d) for m in port[True].modules())
    assert n_int8 == (1 + 4 * 3 + 4 + 4 if backbone == "resnet" else 24)


def test_same_state_dict_keys_as_fp32(models):
    backbone, _, quant, variables, port = models
    fp_sd, q_sd = port[False].state_dict(), port[True].state_dict()
    assert list(fp_sd) == list(q_sd)
    # JAX's quantized model has the float model's tree too.
    qvars = jax.eval_shape(lambda: init_model(quant, jax.random.PRNGKey(0), image_size=SIZE))
    assert jax.tree_util.tree_structure(qvars) == jax.tree_util.tree_structure(variables)
