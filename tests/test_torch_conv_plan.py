"""The launch plans of the two wgmma conv kernels, on the CPU.

``cuda_int8.plan`` picks the int8 conv's output tile and K splits by shape
(pure Python), and ``launch_buffers`` allocates what the kernel writes: it
is checked here for every conv of the full-width engine at batch 1, 16, 64
and 256, with the geometry list built by ``chip_smoke.engine_convs``. The
bf16 conv's stats workspace holds one partial per 64-row slab of the
output. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from yolo_tpu_torch.experiments import conv_bn_fuse_bench as cb
from yolo_tpu_torch.serving import cuda_int8

REPO = Path(__file__).resolve().parents[1]


def _engine_convs(n):
    spec = importlib.util.spec_from_file_location("chip_smoke_convs", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.engine_convs(n)


@pytest.mark.parametrize("batch", [1, 16, 64, 256])
def test_plan_covers_every_engine_conv(batch):
    convs = _engine_convs(batch)
    assert len(convs) == 58
    for name, (n, h, w, cin), cout, k, stride, pad, mode in convs:
        ho, wo = cuda_int8.out_size(h, w, k, k, stride, pad)
        m_rows, depth = n * ho * wo, k * k * cin
        tile, splits = cuda_int8.plan(m_rows, cout, depth)
        bm, bn = cuda_int8.TILES[tile]
        stages = cuda_int8.k_stages(depth)
        assert stages * cuda_int8.STAGE_BYTES >= cuda_int8.pack_weight(
            torch.zeros((k, k, cin, 2), dtype=torch.int8)).shape[1], name
        assert -(-m_rows // bm) * bm >= m_rows and -(-cout // bn) * bn >= cout, name
        short = stages <= 2 and cout <= 512
        assert ((bm, bn) == (64, 64)) if short else (bn == (64 if cout <= 64 else 128)), name
        assert splits >= 1 and stages % splits == 0, name
        assert splits == 1 or stages // splits >= cuda_int8.MIN_SPLIT_STAGES, name
        units = -(-m_rows // bm) * -(-cout // bn)
        # Splitting only fills idle SMs: never past the resident blocks.
        assert splits == 1 or units * splits <= 2 * cuda_int8._SMS, name
        out, ws, tile2, splits2 = cuda_int8.launch_buffers((n, h, w, cin), cout, k, k, stride,
                                                           pad, mode, "cpu")
        assert (tile2, splits2) == (tile, splits)
        assert tuple(out.shape) == (n, ho, wo, cout)
        assert out.dtype == {"float": torch.float32}.get(mode, torch.int8)
        if splits == 1:
            assert ws is None and cuda_int8.workspace_shape(m_rows, cout, 1) is None
        else:
            assert ws.dtype == torch.int32 and tuple(ws.shape) == (splits, m_rows, cout)
        if name == "fc1" and batch <= 64:
            assert splits > 1, (batch, splits)


def test_plan_picks_tiles_by_shape():
    # K of one or two stages (the stem, layer1's 1x1 convs): 64x64; layer1's
    # 3x3 conv2 at batch 16: 128x64; layer3's conv3 (Cout 1024): 128x128;
    # head.conv1 at batch 16 has 200 tiles of 128x128.
    assert cuda_int8.plan(16 * 112 * 112, 64, 256) == (3, 1)
    assert cuda_int8.plan(16 * 112 * 112, 256, 64) == (3, 1)
    assert cuda_int8.plan(16 * 224 * 224, 64, 192) == (3, 1)
    assert cuda_int8.plan(16 * 112 * 112, 64, 9 * 64) == (1, 1)
    assert cuda_int8.plan(16 * 28 * 28, 1024, 256) == (0, 1)
    assert cuda_int8.plan(16 * 14 * 14, 1024, 9 * 2048) == (0, 1)
    # fc1 at batch 16: 64x128 tiles, K = 392 stages in 8 splits of 49.
    assert cuda_int8.plan(16, 4096, 50176) == (2, 8)
    assert cuda_int8.workspace_shape(16, 4096, 8) == (8, 16, 4096)
    assert cuda_int8.k_stages(50176) == 392 and cuda_int8.k_stages(147) == 2


@pytest.mark.parametrize("shape", [(2, 28, 28, 256), (128, 28, 28, 256), (1, 13, 13, 512),
                                   (3, 7, 7, 136), (1, 1, 1, 8)])
def test_bf16_stats_workspace_has_one_partial_per_slab(shape):
    n, h, w, k = shape
    g, two, kk = cb.stats_workspace_shape(n, h, w, k)
    assert (two, kk) == (2, k)
    assert cb.BM == 64  # one consumer warpgroup's rows of the kernel's 128-row tile
    assert (g - 1) * cb.BM < n * h * w <= g * cb.BM
