"""The fused int8 bottleneck kernels' plain twins held against the JAX package.

- Kernel #8, one identity bottleneck per launch
  (serving/cuda_bottleneck.py::block_int8; TPU kernel
  ``_fused_identity_bottleneck_kernel``): its twin against ``block_pallas``
  in interpret mode, bit for bit, at JAX's own geometries
  (tests/test_serving.py) and over two chained blocks at W = 12, which the
  JAX side pads to 32 columns and runs with ``real_w`` while the port runs
  it unpadded.
- Kernel #9, a stage's stride-1 blocks per launch (``chain_int8``; TPU
  kernel ``_chain_kernel``): its twin against ``chain_pallas`` in interpret
  mode, bit for bit, with and without a first block that carries a
  downsample (Cin != C), at W = 12 (padded on the JAX side) and W = 16.

The wrappers run the twins on CPU tensors; the CUDA kernels are held
against the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).
Inputs and q-params are made with numpy from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.serving.engine import _block_xla
from yolo_tpu.serving.pallas_int8 import block_pallas, chain_pallas
from yolo_tpu_torch.serving import cuda_bottleneck as cb
from yolo_tpu_torch.serving.engine import to_device
from yolo_tpu_torch.utils import kernels

from test_torch_cuda import random_qblock


def _jax(qb):
    """A numpy q-params block as the JAX package holds it."""
    return {k: None if v is None else
            {kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else
            jnp.asarray(v) for k, v in qb.items()}


def _x(seed, shape):
    return np.random.default_rng(seed).integers(-127, 128, size=shape, dtype=np.int8)


def _pad_w(x, width, value):
    """JAX's layout for a W % 8 != 0 stage: columns padded to ``width``."""
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, width - x.shape[2]), (0, 0)),
                   constant_values=value)


@pytest.mark.parametrize("H,W,C,P,TH", [(8, 8, 16, 8, 4), (12, 40, 32, 16, 6)])
def test_block_twin_matches_pallas(H, W, C, P, TH):
    qb = random_qblock(H * W, C, C, P)
    x = _x(1, (2, H, W, C))
    want = block_pallas(jnp.asarray(x), _jax(qb), tile_rows=TH, interpret=True)
    got = cb.block_int8_reference(torch.from_numpy(x), to_device(qb, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_twin_matches_pallas_on_a_padded_width():
    H, W, C, P = 12, 12, 16, 8
    qb1, qb2 = random_qblock(2, C, C, P), random_qblock(3, C, C, P)
    x = _x(4, (2, H, W, C))
    want = block_pallas(_pad_w(x, 32, 13), _jax(qb1), tile_rows=6, interpret=True, real_w=W)
    want = block_pallas(want, _jax(qb2), tile_rows=6, interpret=True, real_w=W)[:, :, :W]
    got = torch.from_numpy(x)
    for qb in (qb1, qb2):
        got = cb.block_int8_reference(got, to_device(qb, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ... and the JAX package's XLA block agrees with both.
    xla = _block_xla(_block_xla(jnp.asarray(x), _jax(qb1), 1), _jax(qb2), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


@pytest.mark.parametrize("W", [12, 16])
@pytest.mark.parametrize("ds", [False, True], ids=["identity", "downsample"])
def test_chain_twin_matches_pallas(W, ds):
    H, C, P = 12, 16, 8
    cin = 8 if ds else C
    qbs = [random_qblock(20 + b, cin if b == 0 else C, C, P, ds=ds and b == 0)
           for b in range(3)]
    x = _x(W, (2, H, W, cin))
    if W % 8:
        want = chain_pallas(_pad_w(x, 32, 7), [_jax(qb) for qb in qbs], real_w=W,
                            interpret=True)[:, :, :W]
    else:
        want = chain_pallas(jnp.asarray(x), [_jax(qb) for qb in qbs], interpret=True)
    got = cb.chain_int8_reference(torch.from_numpy(x), [to_device(qb, "cpu") for qb in qbs])
    assert got.shape == (2, H, W, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_take_the_twins_on_the_cpu():
    qbs = [to_device(random_qblock(30 + b, 16, 16, 8), "cpu") for b in range(2)]
    x = torch.from_numpy(_x(5, (1, 9, 7, 16)))
    before = kernels.LAUNCHES["yolo_int8_bottleneck"], kernels.LAUNCHES["yolo_int8_chain"]
    assert torch.equal(cb.block_int8(x, qbs[0]), cb.block_int8_reference(x, qbs[0]))
    assert torch.equal(cb.chain_int8(x, qbs), cb.chain_int8_reference(x, qbs))
    assert (kernels.LAUNCHES["yolo_int8_bottleneck"], kernels.LAUNCHES["yolo_int8_chain"]) == before


def test_unsupported_shapes_raise():
    ds = to_device(random_qblock(40, 8, 16, 8, ds=True), "cpu")
    ident = to_device(random_qblock(41, 16, 16, 8), "cpu")
    x8, x16 = (torch.from_numpy(_x(6, (1, 6, 6, c))) for c in (8, 16))
    with pytest.raises(ValueError, match="identity blocks"):
        cb.block_int8(x8, ds)
    with pytest.raises(ValueError, match="only the first"):
        cb.chain_int8(x16, [ident, ds])
    with pytest.raises(ValueError, match="Cin == C"):
        cb.chain_int8(x8, [ident])
    with pytest.raises(ValueError, match="int8"):
        cb.chain_int8(x16.float(), [ident])
    with pytest.raises(ValueError, match="1 to 8 blocks"):
        cb.chain_int8(x16, [ident] * 9)
    # What the CUDA kernels take: channels in multiples of 64.
    with pytest.raises(ValueError, match="multiples of 64"):
        cb.check_kernel(x16, 16, 8)
    cb.check_kernel(torch.zeros((1, 6, 6, 64), dtype=torch.int8), 256, 64)


def test_tiles_and_work():
    # The kernels' tile at each stage of the full-width engine at batch 16
    # (tests/test_torch_bottleneck_plan.py holds plan() in full).
    stages = ((112, 64, 256, 64, True), (56, 512, 512, 128, False),
              (28, 1024, 1024, 256, False), (14, 2048, 2048, 512, False))
    tiles = [cb.plan(16, h, h, cin, c, p, ds=ds) for h, cin, c, p, ds in stages]
    assert [(t.th, t.tw) for t in tiles] == [(8, 16), (8, 8), (8, 16), (8, 8)]
    # layer1 at 448x448: 3 blocks (the first with its 64 -> 256 downsample), per image.
    ops, n_bytes = cb.work(1, 112, 112, 64, 256, 64, 3, True)
    px = 112 * 112
    assert ops == 2 * px * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256
                            + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256))
    assert n_bytes > px * (64 + 256)
