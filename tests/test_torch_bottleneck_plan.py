"""``cuda_bottleneck.plan``: the output tile of the fused-bottleneck kernels
(the int8 block and stage chain, the bf16 fused bottleneck), pure Python,
on the CPU. It must cover the image, fill its 64-row wgmma blocks with
little padding, fit shared memory with at least three ring stages, and pick
at each engine stage the tile that the chip run timed fastest
(``chip_smoke.py`` phases 14 and 23 time every tile of ``TILES``)."""

import pytest

from yolo_tpu_torch.serving import cuda_bottleneck as cb

# (stage, H = W, Cin, C, P, first block carries the downsample): the
# full-width engine's chains (chip_smoke.CHAINS).
STAGES = [("layer1", 112, 64, 256, 64, True), ("layer2", 56, 512, 512, 128, False),
          ("layer3", 28, 1024, 1024, 256, False), ("layer4", 14, 2048, 2048, 512, False)]
BATCHES = [1, 2, 16, 256]
# The bf16 harness (experiments/fused_block_pallas.py): layer1 at batch 64
# and chip_smoke phase 23's batch 2 / 64 at 112 and 13.
BF16 = [(2, 112), (64, 112), (2, 13), (64, 13)]

# Device ms of the chain kernel at each engine stage, batch 16, and of the
# bf16 bottleneck at the harness's layer1 (batch 64), with every tile plan()
# weighs forced: chip_smoke.py phases 14 and 23 on an "NVIDIA H100 80GB
# HBM3, 700.00 W" (PERF.md §6). plan() must pick the fastest tile, or
# one within SPREAD of it (the run-to-run spread of these times).
TIMED = {
    "layer1": {(8, 16): 0.5582, (16, 8): 0.5573, (14, 7): 0.7271, (8, 8): 0.7798, (7, 7): 1.0181},
    "layer2": {(8, 16): 0.3894, (16, 8): 0.3886, (14, 7): 0.3887, (8, 8): 0.3747, (7, 7): 0.4907},
    "layer3": {(8, 16): 0.4823, (16, 8): 0.4875, (14, 7): 0.4915, (8, 8): 0.6045, (7, 7): 0.6089},
    "layer4": {(8, 8): 0.4060, (7, 7): 0.4074},
}
TIMED_BF16 = {(8, 16): 0.7891, (16, 8): 0.7838, (14, 7): 0.9800, (8, 8): 1.0618, (7, 7): 1.3863}
SPREAD = 0.02


def _fast_enough(tile, timed):
    return timed[tile] <= (1 + SPREAD) * min(timed.values())


def _check(pl, n, h, w, p, e):
    assert pl.th * -(-h // pl.th) >= h and pl.tw * -(-w // pl.tw) >= w
    assert pl.tiles == n * -(-h // pl.th) * -(-w // pl.tw)
    halo, rows = (pl.th + 2) * (pl.tw + 2), pl.th * pl.tw
    assert halo <= 64 * pl.m1_blocks <= 64 * cb.MAX_ROW_BLOCKS
    assert rows <= 64 * pl.m2_blocks <= 64 * cb.MAX_ROW_BLOCKS
    # little padding: under one block's worth, and at least 3/4 of the rows used
    assert 64 * pl.m1_blocks - halo < 64 and 64 * pl.m2_blocks - rows < 64
    assert rows / (64 * pl.m2_blocks) >= 0.75
    assert cb.MIN_STAGES <= pl.stages <= cb.MAX_STAGES
    assert pl.smem <= cb.SMEM == 232448
    # the layout's own arithmetic: the ring, y1, y2, the offset table, the barriers
    ldy = p * e + 16
    assert pl.smem == (1024 + halo * ldy + 64 * pl.m2_blocks * ldy + pl.m1_blocks * 512 * 4
                       + pl.stages * ((64 * pl.m1_blocks + cb.B_ROWS) * cb.STAGE_K + 16))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("stage", STAGES, ids=lambda s: s[0])
def test_plan_at_every_engine_stage(stage, batch):
    name, h, cin, c, p, ds = stage
    pl = cb.plan(batch, h, h, cin, c, p, e=1, ds=ds)
    assert (pl.th, pl.tw) in cb.TILES
    _check(pl, batch, h, h, p, 1)
    if batch == 16:
        assert _fast_enough((pl.th, pl.tw), TIMED[name])


@pytest.mark.parametrize("n,h", BF16, ids=lambda v: str(v))
def test_plan_for_the_bf16_harness(n, h):
    pl = cb.plan(n, h, h, 256, 256, 64, e=2)
    _check(pl, n, h, h, 64, 2)
    if (n, h) == (64, 112):
        assert _fast_enough((pl.th, pl.tw), TIMED_BF16)


@pytest.mark.parametrize("tile", cb.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("p,e", [(64, 1), (128, 1), (256, 1), (64, 2), (16, 2)])
def test_every_tile_lays_out_at_narrow_widths(tile, p, e):
    pl = cb.layout(3, 13, 13, 64, 64, p, e, *tile)
    _check(pl, 3, 13, 13, p, e)


def test_layout_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="blocks of 64"):
        cb.layout(1, 32, 32, 64, 64, 64, 1, 16, 16)  # 324 halo rows
    with pytest.raises(ValueError, match="ring stages"):
        cb.layout(1, 14, 14, 2048, 2048, 512, 1, 8, 16)  # y1, y2 of P = 512 at 8 x 16
    # layer4 has no room for the larger tiles: plan() falls back to the smaller ones
    assert (cb.plan(16, 14, 14, 2048, 2048, 512).th, cb.plan(16, 14, 14, 2048, 2048, 512).tw) \
        in ((8, 8), (7, 7))


def test_items_per_warpgroup_stay_within_two():
    """A product's items, (row block, column half), at most 2 a warpgroup."""
    for blocks in range(1, cb.MAX_ROW_BLOCKS + 1):
        for cols in (16, 64, 128, 192, 256, 2048):
            assert blocks * cb._halves(cols, blocks) <= 4


def test_cost_prefers_fewer_waves_of_the_same_work():
    a = cb.layout(16, 28, 28, 1024, 1024, 256, 1, 7, 7)
    b = cb.layout(1, 28, 28, 1024, 1024, 256, 1, 7, 7)
    assert cb.cost(a, 1024, 1024, 256, 1) > cb.cost(b, 1024, 1024, 256, 1)
