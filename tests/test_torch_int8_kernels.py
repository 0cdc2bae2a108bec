"""The plain twins of the int8 serving kernels held against the JAX package.

- Kernel #6, the quantize + space-to-depth stem front (serving/cuda_stem.py):
  its twin against the Pallas kernel ``quant_s2d_int8`` in interpret mode
  (float input bit for bit; uint8 within 1 LSB, the JAX package's own bound
  for its uint8 kernel) and against the JAX engine's XLA path (normalize,
  s2d, ``_quantize_input``) bit for bit.
- Kernel #7, the int8 conv + requant (serving/cuda_int8.py): its twin
  against ``engine._conv_i8`` / ``lax.conv_general_dilated`` +
  ``engine._requant`` for every conv geometry of the engine and every
  epilogue, and against the Pallas ``transition_conv2_int8`` in interpret
  mode, bit for bit.

The CUDA kernels themselves are held against these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs are made with numpy from
seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from yolo_tpu.data.transforms import device_normalize as jnormalize
from yolo_tpu.serving.engine import _conv_i8, _quantize_input, _requant
from yolo_tpu.serving.pallas_int8 import transition_conv2_int8
from yolo_tpu.serving.pallas_stem import quant_s2d_int8
from yolo_tpu_torch.serving import cuda_int8, cuda_stem
from yolo_tpu_torch.utils import kernels


def _s2d(x):
    n, h, w, c = x.shape
    return (x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
            .reshape(n, h // 2, w // 2, 4 * c))


def _images(seed, shape, dtype):
    r = np.random.default_rng(seed)
    if dtype == "uint8":
        return r.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    return (r.normal(size=(*shape, 3)) * 3).astype(np.float32)


@pytest.mark.parametrize("n,h,w", [(2, 16, 16), (3, 8, 12), (4, 18, 10)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_stem_front_twin_matches_jax(n, h, w, dtype):
    images = _images(n * h * w, (n, h, w), dtype)
    s = np.float32(0.0123)
    got = cuda_stem.quant_s2d(torch.from_numpy(images), torch.tensor(s)).numpy()

    x = jnp.asarray(images)
    xla = _quantize_input(_s2d(jnormalize(x) if dtype == "uint8" else x), jnp.float32(s))
    np.testing.assert_array_equal(got, np.asarray(xla))

    pallas = np.asarray(quant_s2d_int8(x, jnp.float32(s), interpret=True))
    diff = np.abs(got.astype(np.int32) - pallas.astype(np.int32))
    # The Pallas kernel's uint8 path may round its in-kernel normalize
    # differently (tests/test_serving.py allows it 1 LSB); float is exact.
    assert diff.max() <= (1 if dtype == "uint8" else 0), diff.max()


def test_stem_front_wrapper_takes_the_twin_on_the_cpu():
    images = torch.from_numpy(_images(1, (2, 8, 8), "uint8"))
    before = kernels.LAUNCHES["yolo_quant_s2d"]
    out = cuda_stem.quant_s2d(images, torch.tensor(0.02))
    assert kernels.LAUNCHES["yolo_quant_s2d"] == before and out.shape == (2, 4, 4, 12)
    with pytest.raises(ValueError):
        cuda_stem.quant_s2d(images[:, :7], torch.tensor(0.02))  # odd H


# (N, H, W, Cin, Cout, K, stride, pad): the engine's int8 conv geometries.
GEOMETRIES = {
    "s2d_stem": (2, 16, 16, 12, 64, 4, 1, ((2, 1), (2, 1))),
    "direct_stem": (2, 32, 32, 3, 64, 7, 2, 3),
    "1x1": (2, 8, 8, 64, 256, 1, 1, 0),
    "1x1_s2": (2, 8, 8, 256, 512, 1, 2, 0),
    "3x3": (2, 8, 8, 64, 64, 3, 1, 1),
    "3x3_s2": (2, 8, 8, 128, 128, 3, 2, 1),
    "fc1": (3, 1, 1, 1024, 64, 1, 1, 0),
}


def _operands(seed, n, h, w, cin, cout, k):
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, size=(n, h, w, cin), dtype=np.int8)
    wq = r.integers(-127, 128, size=(k, k, cin, cout), dtype=np.int8)
    m = (r.uniform(0.5, 1.5, cout) / (40 * np.sqrt(k * k * cin))).astype(np.float32)
    t = r.uniform(-3, 3, cout).astype(np.float32)
    return x, wq, m, t


def _jax_epilogue(acc, m, t, mode, res, r):
    """The JAX engine's epilogue for each mode (engine.py:39-45, 195-200, 305)."""
    if mode == "acc":
        return acc
    if mode == "float":
        return acc.astype(jnp.float32) * m + t
    if mode == "none":  # the downsample branch, engine.py:195-196
        return jnp.clip(jnp.round(acc.astype(jnp.float32) * m + t), -127, 127).astype(jnp.int8)
    if mode == "residual":
        return _requant(acc, m, t, extra=res.astype(jnp.float32) * r)
    return _requant(acc, m, t, leaky=mode == "leaky")


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_int8_conv_twin_matches_jax(name):
    n, h, w, cin, cout, k, stride, pad = GEOMETRIES[name]
    x, wq, m, t = _operands(len(name), n, h, w, cin, cout, k)
    pads = [(pad, pad)] * 2 if isinstance(pad, int) else list(pad)
    acc = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), (stride, stride), pads,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    if isinstance(pad, int):  # the engine's own helper where the pad is symmetric
        np.testing.assert_array_equal(
            np.asarray(_conv_i8(jnp.asarray(x), jnp.asarray(wq), stride, pad)), np.asarray(acc))
    ho, wo = cuda_int8.out_size(h, w, k, k, stride, pad)
    res = np.random.default_rng(5).integers(-127, 128, size=(n, ho, wo, cout), dtype=np.int8)
    r = np.float32(0.85)
    for mode in cuda_int8.MODES:
        extra = {"res": torch.from_numpy(res), "r": torch.tensor(r)} if mode == "residual" \
            else {}
        got = cuda_int8.conv_int8(torch.from_numpy(x), torch.from_numpy(wq),
                                  torch.from_numpy(m), torch.from_numpy(t), stride, pad,
                                  mode, **extra)
        want = _jax_epilogue(acc, jnp.asarray(m), jnp.asarray(t), mode, jnp.asarray(res),
                             jnp.float32(r))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=mode)


def test_int8_conv_twin_matches_pallas_transition_conv2():
    """The TPU kernel this one replaces, at (2, 8, 8, 128), 3x3/s2/p1 + requant."""
    x, wq, m, t = _operands(40, 2, 8, 8, 128, 128, 3)
    want = transition_conv2_int8(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(m),
                                 jnp.asarray(t), interpret=True)
    got = cuda_int8.conv_int8(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(m),
                              torch.from_numpy(t), stride=2, pad=1, mode="relu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_weight_layout():
    wq = torch.from_numpy(_operands(3, 1, 1, 1, 3, 8, 7)[1])  # (7, 7, 3, 8), K = 147
    wk = cuda_int8.pack_weight(wq)
    assert wk.shape == (8, 192) and wk.is_contiguous()
    assert torch.equal(wk[:, :147], wq.permute(3, 0, 1, 2).reshape(8, 147))
    assert not wk[:, 147:].any()
    assert [cuda_int8.plan(m, c, k) for m, c, k in
            ((16, 4096, 50176), (50176 * 16, 64, 192), (12544 * 16, 256, 64),
             (784 * 16, 1024, 256))] == [(2, 8), (3, 1), (3, 1), (0, 1)]


def test_int8_conv_wrapper_takes_the_twin_on_the_cpu():
    x, wq, m, t = (torch.from_numpy(a) for a in _operands(2, 1, 4, 4, 16, 8, 1))
    before = kernels.LAUNCHES["yolo_int8_conv"]
    cuda_int8.conv_int8(x, wq, m, t)
    assert kernels.LAUNCHES["yolo_int8_conv"] == before
    with pytest.raises(ValueError):
        cuda_int8.conv_int8(x, wq, m, t, mode="gelu")
