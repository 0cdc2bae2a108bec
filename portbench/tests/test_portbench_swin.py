"""The Swin-B cell at a test size on the CPU: a tiny Swin (embed 32, depths
(2, 2, 2, 2), heads (1, 2, 4, 8), window 7) at 64x64 runs end to end
through the train driver and its check and comes out correct; the float8
control and the half-batch and unchanged-step faults come out not correct;
the counts against a hand count of one block and the published totals."""

import math

import pytest
import torch

from portbench import control, harness, weights
from portbench.tests import tiny

CELL = "swinb-train-bf16-b64"
TINY = {"embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8]}


def _counts():
    return harness.load_file(harness.HERE / "counts" / "swin-b-yolov1.py")


def _config():
    return harness.read_json(harness.HERE / "configs" / "swin-b-yolov1.json")


@pytest.fixture
def tiny_swin(monkeypatch):
    """``create_model("swin_b", ...)`` builds the tiny Swin under the same head."""
    import yolo_tpu_torch.models as models
    from yolo_tpu_torch.models import SwinBackbone, YOLOv1

    def create_model(backbone, num_classes, S, B, *, device, image_size, quantized=False):
        assert backbone == "swin_b" and not quantized
        bb = SwinBackbone(TINY["embed_dim"], TINY["depths"], TINY["num_heads"], 7,
                          device=device)
        return YOLOv1(num_classes, S, B, bb, device=device, image_size=image_size)

    monkeypatch.setattr(models, "create_model", create_model)


def _run(**kwargs):
    run = tiny.run(CELL, **kwargs)
    run.overrides.update(TINY)
    return run


def test_cell_runs_and_is_correct(tiny_swin):
    for seed in (tiny.SEED, 2 ** 33 + 1):
        run = _run(seed=seed)
        harness.execute(run)
        assert run.setup_s is not None and run.setup_s > 0
        assert math.isfinite(run.metrics["train_images_per_s"])
        assert run.window_counts["steps"] > 0 and run.failed == 0
        assert set(run.checks) == set(run.cell["limits"])
        assert harness.is_correct(run), run.checks


def test_float8_control_is_not_correct(tiny_swin):
    run = _run()
    numbers = control.control_run(run)
    assert any(v > run.limit(k) for k, v in numbers.items()), numbers


def _unchanged(step):
    def wrapped(images, targets):
        return {"total": torch.zeros(())}

    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, control.half_batch])
def test_training_faults_are_not_correct(tiny_swin, fault):
    run = _run(hooks={"wrap_step": fault})
    harness.execute(run)
    assert not harness.is_correct(run), run.checks


def test_counts_of_one_block_by_hand():
    cfg = _config()["model"]
    m = _counts()
    st = m.stages(cfg)
    assert [(s.h, s.c, s.heads, s.depth) for s in st] == [
        (112, 128, 4, 2), (56, 256, 8, 2), (28, 512, 16, 18), (14, 1024, 32, 2)]
    # a stage-3 block on one image: 784 tokens of 512 channels, 16 windows of 49
    macs = m.block_macs(cfg, st[2])
    assert macs == {"qkv": 784 * 512 * 1536, "attention": 2 * 784 * 49 * 512,
                    "proj": 784 * 512 * 512, "mlp": 2 * 784 * 512 * 2048}
    work = m.window_attention(cfg, 64)
    assert len(work) == 24
    w = work[4]  # the first stage-3 block at batch 64
    t = 64 * 784
    assert w.ops_fwd == 4 * t * 49 * 512 and w.ops_bwd == 10 * t * 49 * 512
    mask = 16 * 16 * 49 * 49 * 2
    assert w.bytes_fwd == 4 * t * 512 * 2 + t * 16 * 4 + mask
    assert w.bytes_bwd == 8 * t * 512 * 2 + t * 16 * 4 + 2 * mask
    # bound by bytes: 24.5 operations a byte, under the H100's ridge
    assert m.attention_least_seconds(cfg, 64) == pytest.approx(
        sum(x.bytes_fwd + x.bytes_bwd for x in work) / 3.35e12)


def test_counts_total_is_130_3_gflop():
    cfg = _config()["model"]
    m = _counts()
    total = m.ops_per_image(cfg, "train")["bf16"]
    assert total / 1e9 == pytest.approx(130.34, abs=0.01)  # backbone 123.4 + head 6.9
    head = 2 * (sum(c.macs() for c in m.head_convs(cfg)) + 4096 * 1470)
    assert head / 1e9 == pytest.approx(6.90, abs=0.01)
    attention = sum(s.depth * m.block_macs(cfg, s)["attention"] for s in m.stages(cfg))
    assert 2 * attention / (total - head) == pytest.approx(0.0198, abs=1e-4)  # 2.0% of the MACs
    with pytest.raises(ValueError):
        m.ops_per_image(cfg, "int8")


def test_parameter_count_and_names():
    cfg = _config()
    ref = harness.load_file(harness.HERE / "references" / "swin-b-yolov1.py")
    spec = ref.param_spec(cfg["model"])
    assert weights.n_parameters(spec) == cfg["parameters"] == 336043638
    from yolo_tpu_torch.models import create_model

    model = create_model("swin_b", device="meta", generator=torch.Generator())
    assert [n for n, *_ in spec] == list(model.state_dict())
    assert [s for _, s, *_ in spec] == [tuple(t.shape) for t in model.state_dict().values()]


@pytest.mark.parametrize("size", [64, 160])
def test_fused_attention_core_is_the_written_out_one(size):
    """The fused call that the training steps run computes the written-out
    core: the backbone (float32; at 160x160 every stage pads its map), whose
    gradients no LeakyReLU kink of the head turns at a float32 rounding."""
    from portbench.references.detect import exact_float32

    ref = harness.load_file(harness.HERE / "references" / "swin-b-yolov1.py")
    cfg = dict(_config()["model"], image_size=size, **TINY)
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(size))
    sd = weights.make(ref.param_spec(cfg), 5, "cpu")
    outs, grads = [], []
    for fused in (False, True):
        params = {n: v.clone().requires_grad_(True) for n, v in sd.items()
                  if n.startswith("backbone.")}
        with exact_float32():
            out = ref._Model(cfg, params, fused=fused).backbone(x)
        out.backward(torch.randn(out.shape, generator=torch.Generator().manual_seed(1)))
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in params.items()})
    assert float((outs[1] - outs[0]).norm() / outs[0].norm()) < 1e-5
    for n, g in grads[0].items():
        assert float((grads[1][n] - g).norm() / g.norm().clamp(min=1e-30)) < 1e-5, n
    with pytest.raises(ValueError):
        ref._Model(cfg, sd, control=True, fused=True)


def test_loss_and_float8_are_the_resnet_references():
    import inspect

    swin = harness.load_file(harness.HERE / "references" / "swin-b-yolov1.py")
    r50 = harness.load_file(harness.HERE / "references" / "resnet50-yolov1.py")
    for name in ("_iou", "yolo_loss", "_fp8"):
        assert inspect.getsource(getattr(swin, name)) == inspect.getsource(getattr(r50, name))
