"""The Winograd conv's two-kernel decomposition and the int8 dot's routing,
held on the CPU against the functions they compute.

On the card a Winograd conv (``serving/cuda_wino.py``) is a tap pass that
writes the requantized taps of every ceil(H/2) x ceil(W/2) tile into a (16,
Mt, C) int8 scratch, then a tap GEMM that runs one int8 dot a tap and adds
each dequantized tap into four running float32 sums Y_p, ascending t from
the first nonzero term. :func:`wino_gemm_np` restates that decomposition in
numpy with every float32 step rounded on its own; it must equal the twin
``winograd.conv3x3_wino_rq`` bit for bit at the engine's six stride-1 3x3
geometries (batch 1 and 2, full width), at odd and non-square images, and
at the JAX package's own Winograd cases (tests/test_serving.py), where it
stays within 1 of JAX's XLA path (which XLA:CPU now and then contracts,
see tests/test_torch_winograd.py). ``cuda_wino.plan`` must give a valid
tile for every engine geometry at batch 1, 16 and 256.

The int8 dot of ``experiments/mosaic_int8_dot.py`` runs on the card as the
int8 conv's kernel: a 1x1 conv over an (M, 1, 1, K) view with the
``"none"`` epilogue and t = 0. ``int8_dot_reference`` must equal
``cuda_int8.conv_int8_reference`` on that view bit for bit in the
harness's five cases. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import random_qwino
from yolo_tpu.serving import winograd as jw
from yolo_tpu_torch.experiments import mosaic_int8_dot as md
from yolo_tpu_torch.serving import cuda_int8, cuda_wino
from yolo_tpu_torch.serving import winograd as pw

# (name, H = W, C, K, leaky): the distinct stride-1 3x3 convs of the
# full-width engine (chip_smoke.py's WINO_CONVS).
ENGINE = [("layer1_conv2", 112, 64, 64, False), ("layer2_conv2", 56, 128, 128, False),
          ("layer3_conv2", 28, 256, 256, False), ("layer4_conv2", 14, 512, 512, False),
          ("head_conv1", 14, 2048, 1024, True), ("head_conv3", 7, 1024, 1024, True)]


def wino_gemm_np(x_q, qw, leaky):
    """The tap pass into a (16, Mt, C) int8 buffer (tiles ceil(H/2) x
    ceil(W/2) an image, zero off the image), then a tap at a time: the exact
    int dot (float64), m_t = f32(acc) * mw[t], added into each Y_p that tap t
    feeds (or starting it), then bias, activation, round half to even, clip,
    and each tile's 2x2 outputs cropped to H x W. (N, H, W, C) int8 ->
    (N, H, W, K) int8."""
    n, h, w, c = x_q.shape
    th, tw = (h + 1) // 2, (w + 1) // 2
    dinv = np.asarray(qw["dinv"], np.float32).reshape(16)
    uq = np.asarray(qw["uq"])
    mw = np.asarray(qw["mw"], np.float32).reshape(16, -1)
    bias = np.asarray(qw["t"], np.float32)
    k = uq.shape[-1]
    xp = np.zeros((n, 2 * th + 2, 2 * tw + 2, c), np.int32)
    xp[:, 1:h + 1, 1:w + 1] = x_q
    d = [[xp[:, u:u + 2 * th:2, v:v + 2 * tw:2] for v in range(4)] for u in range(4)]
    b_t = jw.B_T.astype(np.int32)
    vq = np.empty((16, n * th * tw, c), np.int8)
    for t in range(16):
        a, b = divmod(t, 4)
        v_t = sum(b_t[a, u] * b_t[b, v] * d[u][v] for u in range(4) for v in range(4))
        vq[t] = np.clip(np.round(v_t.astype(np.float32) * dinv[t]), -127, 127).reshape(-1, c)
    a2 = np.einsum("ra,sb->rsab", jw.A_T, jw.A_T).reshape(4, 16)
    y = [None] * 4
    for t in range(16):
        acc = vq[t].astype(np.float64) @ uq[t].astype(np.float64)  # exact: |acc| < 2**31
        m = acc.astype(np.float32) * mw[t]
        for p in range(4):
            if a2[p, t] != 0:
                term = m if a2[p, t] > 0 else -m
                y[p] = term if y[p] is None else y[p] + term
    out = np.zeros((n, 2 * th, 2 * tw, k), np.int8)
    for p in range(4):
        yp = y[p] + bias
        yp = np.where(yp > 0, yp, np.float32(0.1) * yp) if leaky else np.maximum(yp, np.float32(0))
        out[:, p // 2::2, p % 2::2] = np.clip(np.round(yp), -127, 127).reshape(n, th, tw, k)
    return out[:, :h, :w]


def _twin(x_q, qw, leaky):
    tree = {key: torch.from_numpy(np.asarray(v)) for key, v in qw.items()}
    return pw.conv3x3_wino_rq(torch.from_numpy(x_q), {"wino": tree}, leaky).numpy()


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("geo", ENGINE, ids=lambda g: g[0])
def test_decomposition_equals_twin_at_engine_geometries(geo, batch):
    _, h, c, k, leaky = geo
    qw = random_qwino(h + c + batch, c, k)
    x_q = np.random.default_rng(batch + h).integers(-127, 128, (batch, h, h, c), dtype=np.int8)
    got = wino_gemm_np(x_q, qw, leaky)
    assert got.shape == (batch, h, h, k)
    np.testing.assert_array_equal(got, _twin(x_q, qw, leaky))


# (N, H, W): one tile, odd and non-square images (the kernel's tiles are
# ceil(H/2) x ceil(W/2), the twin's a square of the larger side, cropped).
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 7, 9), (3, 13, 11), (1, 5, 16), (2, 9, 4)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("leaky", [True, False], ids=["leaky", "relu"])
def test_decomposition_equals_twin_at_odd_shapes(shape, leaky):
    qw = random_qwino(sum(shape), 64, 128)
    x_q = np.random.default_rng(sum(shape) + 1).integers(-127, 128, (*shape, 64), dtype=np.int8)
    np.testing.assert_array_equal(wino_gemm_np(x_q, qw, leaky), _twin(x_q, qw, leaky))


# JAX's Winograd cases, tests/test_serving.py: (seed, N, H, C, K, leaky,
# s_in, s_out) of test_winograd_int8_conv_tracks_direct_int8 and the two of
# test_pallas_wino_matches_xla_wino_interpret.
JAX_CASES = [(1, 4, 14, 64, 32, True, 0.05, 0.08), (3, 4, 8, 128, 256, True, 0.04, 0.07),
             (3, 4, 14, 64, 128, False, 0.04, 0.07)]


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: f"{c[2]}x{c[2]}-{c[3]}to{c[4]}")
def test_decomposition_at_jax_cases(case):
    seed, n, h, c, k, leaky, s_in, s_out = case
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (n, h, h, c)).astype(np.int8)
    w = jnp.asarray(rng.normal(size=(3, 3, c, k)) * 0.1, jnp.float32)
    b = jnp.asarray(rng.normal(size=(k,)) * 0.5, jnp.float32)
    x_f = jnp.asarray(x_q).astype(jnp.float32) * s_in
    qw_jax = jw.wino_quantize(w, b, s_in, s_out, jw.tap_maxima(x_f))
    qw = {key: np.asarray(v) for key, v in qw_jax.items()}
    got = wino_gemm_np(x_q, qw, leaky)
    np.testing.assert_array_equal(got, _twin(x_q, qw, leaky))
    jax_out = np.asarray(jw.conv3x3_wino_rq(jnp.asarray(x_q), {"wino": qw_jax}, leaky=leaky))
    diff = np.abs(jax_out.astype(np.int32) - got.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), int((diff > 0).sum()))


@pytest.mark.parametrize("batch", [1, 16, 256])
@pytest.mark.parametrize("geo", ENGINE, ids=lambda g: g[0])
def test_wino_plan_gives_a_valid_tile(geo, batch):
    _, h, c, k, _ = geo
    tile = cuda_wino.plan(batch, h, h, c, k)
    assert tile in range(len(cuda_wino.TILES))
    bm, bn = cuda_wino.TILES[tile]
    _, mt, _ = cuda_wino.scratch_shape(batch, h, h, c)
    assert mt == batch * ((h + 1) // 2) ** 2 and bm in (64, 128)
    assert bn == cuda_wino.ALIGN and k % bn == 0
    # The kernel's 32-bit offsets within a tap of the scratch.
    assert mt * c < 2**31


def test_wino_plan_by_shape():
    assert cuda_wino.plan(16, 14, 14, 2048, 1024) == 0  # head_conv1: 112 units
    assert cuda_wino.plan(16, 7, 7, 1024, 1024) == 1    # head_conv3: 32 -> 64 units
    assert cuda_wino.plan(16, 14, 14, 512, 512) == 1    # layer4: 56 -> 104 units
    assert cuda_wino.plan(16, 28, 28, 256, 256) == 0    # layer3: 100 units
    assert cuda_wino.plan(16, 112, 112, 64, 64) == 0    # layer1: 392 units
    assert cuda_wino.plan(1, 14, 14, 2048, 1024) == 1   # head_conv1 at batch 1: 49 rows, 16 units
    assert cuda_wino.scratch_shape(3, 13, 11, 64) == (16, 3 * 7 * 6, 64)


@pytest.mark.parametrize("M", [1, 67, 300])
@pytest.mark.parametrize("case", md.CASES, ids=lambda c: c[0])
def test_int8_dot_twin_is_the_conv_twin_on_a_1x1_view(case, M):
    _, K, N = case
    r = np.random.default_rng(K + N + M)
    a = torch.from_numpy(r.integers(-127, 128, size=(M, K), dtype=np.int8))
    w = torch.from_numpy(r.integers(-127, 128, size=(K, N), dtype=np.int8))
    m = torch.from_numpy((r.uniform(0.5, 1.5, N) * (2e-2 / np.sqrt(K))).astype(np.float32))
    want = md.int8_dot_reference(a, w, m)
    if M > 1:
        assert 0 < int((want.abs() == 127).sum()) < want.numel()  # both clips and the interior
    got = cuda_int8.conv_int8_reference(a.view(M, 1, 1, K), w.view(1, 1, K, N), m,
                                        torch.zeros(N), 1, 0, "none")
    assert got.shape == (M, 1, 1, N)
    assert torch.equal(got.view(M, N), want)
