"""The yardstick's arithmetic against hand-computed geometries and totals."""

import pytest

from portbench import harness
from portbench.counts.conv import Conv, least_seconds, work


def _config(name):
    return harness.read_json(harness.HERE / "configs" / f"{name}.json")["model"]


def _counts(name):
    return harness.load_file(harness.HERE / "counts" / f"{name}.py")


def test_work_of_one_conv_by_hand():
    # layer1's first 1x1 conv at batch 16: 112x112x64 -> 64.
    c = Conv("l1b0.conv1", 112, 112, 64, 64, 1, 1, 0)
    ops, nbytes = work(c, 16)
    assert ops == 2 * 16 * 112 * 112 * 64 * 64
    assert nbytes == 16 * 112 * 112 * 64 + 64 * 64 + 8 * 64 + 16 * 112 * 112 * 64
    # a residual 1x1 writes int8 and reads the residual; "float" writes 4 bytes
    r = Conv("x", 7, 7, 512, 2048, 1, 1, 0, "residual")
    assert work(r, 2)[1] == 2 * 49 * 512 + 512 * 2048 + 8 * 2048 + 2 * 2 * 49 * 2048
    f = Conv("fc1", 1, 1, 50176, 4096, 1, 1, 0, "float")
    assert work(f, 1) == (2 * 50176 * 4096, 50176 + 50176 * 4096 + 8 * 4096 + 4 * 4096)
    # fc1 at batch 1 reads 205 MB of weights: bound by bytes
    assert least_seconds(f, 1) == pytest.approx(work(f, 1)[1] / 3.35e12)


def test_stride_and_padding_geometry():
    assert Conv("stem", 448, 448, 3, 64, 7, 2, 3).out_hw == (224, 224)
    assert Conv("h2", 14, 14, 1024, 1024, 3, 2, 1).out_hw == (7, 7)
    assert Conv("c", 56, 56, 128, 128, 3, 2, 1).out_hw == (28, 28)


def test_resnet50_yolov1_counts():
    cfg = _config("resnet50-yolov1")
    convs = _counts("resnet50-yolov1").int8_convs(cfg, "int8")
    assert len(convs) == 58  # the engine's 58 int8 conv launches a batch
    by = {c.name: c for c in convs}
    assert by["stem"].macs() == 224 * 224 * 64 * 7 * 7 * 3
    assert by["l2b0.conv2"].macs() == 56 * 56 * 128 * 9 * 128  # stride on the 3x3 (v1.5)
    assert by["head.conv2"].macs() == 7 * 7 * 1024 * 9 * 1024
    assert by["head.fc1"].cin == 50176
    ops = _counts("resnet50-yolov1").ops_per_image(cfg, "int8")
    assert ops["fp32"] == 2 * 4096 * 1470
    assert sum(ops.values()) / 1e9 == pytest.approx(43.29, abs=0.01)


def test_yolov1_24conv_total_is_40_5_gflop():
    cfg = _config("yolov1-24conv")
    m = _counts("yolov1-24conv")
    assert len(m.int8_convs(cfg, "dyn8")) == 24
    assert m.feature_side(cfg) == 7
    total = sum(m.ops_per_image(cfg, "dyn8").values())
    assert total / 1e9 == pytest.approx(40.57, abs=0.01)  # the model's 40.5 GFLOP an image


def test_parameter_counts_of_both_configurations():
    from portbench import weights

    for name in ("resnet50-yolov1", "yolov1-24conv"):
        cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
        ref = harness.load_file(harness.HERE / "references" / f"{name}.py")
        assert weights.n_parameters(ref.param_spec(cfg["model"])) == cfg["parameters"]
