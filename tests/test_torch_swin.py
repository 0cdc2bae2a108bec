"""The Swin backbone (``models/backbones.py``, ``models/layers.py``) against
the plain reference ``portbench/references/swin-b-yolov1.py`` on seeded
random weights, on the CPU in float32: a tiny Swin (embed 32, depths
(2, 2, 2, 2), heads (1, 2, 4, 8), window 7) at 224x224 under the YOLOv1
head, and its backbone at 160x160, where every stage pads its map. Also the
shift mask and relative-position index against Swin's own construction,
the state dict against ``param_spec``, the published Swin-B on the meta
device, the refusals, the spans and the padding counter, and a train step
through ``Trainer``."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from yolo_tpu_torch.models import SwinBackbone, YOLOv1, create_model
from yolo_tpu_torch.models.layers import relative_position_index, shift_mask, window_partition
from yolo_tpu_torch.training.optim import make_optimizer
from yolo_tpu_torch.training.trainer import Trainer
from yolo_tpu_torch.utils import tracing

REF = harness.load_file(harness.HERE / "references" / "swin-b-yolov1.py")
EMBED, DEPTHS, HEADS = 32, (2, 2, 2, 2), (1, 2, 4, 8)


def _cfg(size):
    return dict(embed_dim=EMBED, depths=list(DEPTHS), num_heads=list(HEADS), window_size=7,
                mlp_ratio=4, patch_size=4, image_size=size, S=7, B=2, num_classes=20,
                head_channels=1024, fc_hidden=4096, dropout=0.5)


def _model(size):
    bb = SwinBackbone(EMBED, DEPTHS, HEADS, 7, device="cpu")
    model = YOLOv1(20, 7, 2, bb, device="cpu", image_size=size)
    sd = weights.make(REF.param_spec(_cfg(size)), 7, "cpu")
    model.load_state_dict(sd, strict=True)
    return model.eval(), sd


def _close(got, want, what):
    gap = float(((got - want).norm() / want.norm().clamp(min=1e-30)).detach())
    assert gap < 1e-5, (what, gap)  # float32 rounding of the same sums in another order


@pytest.mark.parametrize("size,part", [(224, "model"), (160, "backbone"), (160, "fused")])
def test_forward_and_gradients_match_the_reference(size, part):
    """``fused``: the whole model against the reference with the attention
    core its training steps run (one fused call), at a padded size."""
    model, sd = _model(size)
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(size))
    params = {n: v.clone().requires_grad_(True) for n, v in sd.items()}
    if part != "backbone":
        got, want = model(x), REF.forward(_cfg(size), params, x, fused=part == "fused")
    else:
        got, want = model.backbone(x), REF.backbone_forward(_cfg(size), params, x)
        assert got.shape == (2, 8 * EMBED, 5, 5)
    _close(got, want, "forward")
    g = torch.randn_like(got, generator=torch.Generator().manual_seed(1))
    got.backward(g)
    want.backward(g)
    used = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    assert len(used) == (len(params) if part != "backbone" else
                         sum(n.startswith("backbone.") for n in params))
    for name, p in used:
        _close(p.grad, params[name].grad, name)


def _official_index(ws):
    """Swin's WindowAttention: relative_position_index."""
    coords_h, coords_w = torch.arange(ws), torch.arange(ws)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += ws - 1
    relative_coords[:, :, 1] += ws - 1
    relative_coords[:, :, 0] *= 2 * ws - 1
    return relative_coords.sum(-1)


def _official_mask(H, W, ws, shift):
    """Swin's detection BasicLayer.forward: the attention mask on the padded map."""
    Hp = int(np.ceil(H / ws)) * ws
    Wp = int(np.ceil(W / ws)) * ws
    img_mask = torch.zeros((1, Hp, Wp, 1))
    h_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    w_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    x = img_mask.view(1, Hp // ws, ws, Wp // ws, ws, 1)
    mask_windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, 1)
    mask_windows = mask_windows.view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                          float(0.0))


@pytest.mark.parametrize("ws", [7, 4])
def test_relative_position_index_and_shift_mask_are_swins(ws):
    assert torch.equal(relative_position_index(ws), _official_index(ws))
    assert torch.equal(REF.relative_index(ws), _official_index(ws))
    for h, w in ((56, 56), (14, 14), (7, 7), (40, 26), (5, 5)):
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        want = _official_mask(h, w, ws, ws // 2)
        assert torch.equal(shift_mask(hp, wp, ws, ws // 2), want), (h, w)
        assert torch.equal(REF.region_mask(hp, wp, ws, ws // 2), want), (h, w)
    x = torch.arange(2 * 14 * 21 * 3).reshape(2, 14, 21, 3)
    windows = window_partition(x, 7)
    assert windows.shape == (12, 49, 3) and torch.equal(windows[7, 8], x[1, 1, 8])


def test_state_dict_is_param_spec_and_holds_parameters_only():
    model, _ = _model(224)
    spec = REF.param_spec(_cfg(224))
    assert [(n, s) for n, s, *_ in spec] == [(n, tuple(t.shape))
                                             for n, t in model.state_dict().items()]
    assert len(model.state_dict()) == len(list(model.parameters()))
    assert all(b.numel() == 0 or not b.is_floating_point() or "mask" in n
               for n, b in model.named_buffers())


def test_swin_b_preset_on_the_meta_device():
    model = create_model("swin_b", device="meta", generator=torch.Generator())
    assert sum(p.numel() for p in model.parameters()) == 336_043_638
    assert sum(p.numel() for p in model.backbone.parameters()) == 86_743_224
    bb = model.backbone
    assert isinstance(bb, SwinBackbone) and bb.out_channels == 1024 and bb.depths == (2, 2, 18, 2)
    assert [s.blocks[0].attn.num_heads for s in bb.layers] == [4, 8, 16, 32]
    assert model.head.fc_layers[1].in_features == 1024 * 7 * 7
    assert model(torch.empty(2, 3, 448, 448, device="meta")).shape == (2, 7, 7, 30)


@pytest.mark.parametrize("kwargs", [dict(quantized=True), dict(fused_bn=True),
                                    dict(fused_bn="full"), dict(remat=True),
                                    dict(remat="stage")])
def test_int8_fused_bn_and_remat_are_refused(kwargs):
    with pytest.raises(ValueError):
        create_model("swin_b", device="meta", **kwargs)


def test_spans_and_the_padding_counter():
    model, _ = _model(160)
    bb = model.backbone
    x = torch.randn(2, 3, 160, 160)
    tracing.take()
    tracing.enable()
    try:
        with torch.no_grad():
            bb(x)
    finally:
        tracing.disable()
    spans = tracing.take().spans
    block = ["swin.wmsa", "swin.mlp", "swin.swmsa", "swin.mlp"]
    want = ["swin.embed"] + (block + ["swin.merge"]) * 3 + block + ["swin.norm_out"]
    assert [s.name for s in spans] == want
    assert all(s.parent is None and s.device_ms is None for s in spans)
    # 40x40 -> 42x42, 20x20 -> 21x21, 10x10 -> 14x14, 5x5 -> 7x7, two blocks a stage
    assert bb.count_padding(2, 40, 40, bb.depths) == 2 * 2 * (164 + 41 + 96 + 24)
    # one block a stage: 13x13 pads 27 for its window and 27 for its merge; 7x7 none,
    # then 15 for its merge; 4x4 pads 33, its merge none; 2x2 pads 45
    assert SwinBackbone.count_padding(1, 13, 13, (1, 1, 1, 1)) == 27 + 27 + 15 + 33 + 45
    assert SwinBackbone.count_padding(64, 112, 112, (2, 2, 18, 2)) == 0
    with torch.no_grad():
        bb(x)
    assert tracing.take().spans == []


def test_train_step_trains_it_through_trainer():
    size = 64
    model, sd = _model(size)
    opt, schedule = make_optimizer(model, lr=1e-3)
    trainer = Trainer(model, opt, schedule, device="cpu", clip_norm=10.0)
    r = np.random.default_rng(3)
    images = r.integers(0, 256, size=(2, size, size, 3), dtype=np.uint8)
    targets = np.zeros((2, 7, 7, 30), np.float32)
    targets[:, 3, 3, :5] = (0.5, 0.5, 0.3, 0.4, 1.0)
    targets[:, 3, 3, 10 + 4] = 1.0
    loss = trainer.train_step(images, targets)["total"]
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and not torch.equal(p.detach(), sd[name]), name


def test_span_shares_reads_the_swin_spans():
    from yolo_tpu_torch.experiments import span_shares
    from yolo_tpu_torch.utils.tracing import Span

    ms, t0, t1 = 1_000_000, 1_000_000_000, 2_000_000_000  # a 1-s window

    def span(name, start, device_ms):
        return Span(name, 0, None, 1, t0 + start * ms, t0 + (start + 1) * ms, device_ms, False)

    spans = [span("swin.wmsa", 0, 50.0), span("swin.mlp", 1, 30.0), span("swin.swmsa", 2, 60.0),
             span("swin.mlp", 3, 40.0), span("swin.merge", 4, 5.0)]
    out = span_shares.shares(spans, t0, t1)
    assert out["swin_attn_share.train"] == pytest.approx(11.0)
    assert out["swin_mlp_share.train"] == pytest.approx(7.0)
    assert span_shares.shares(spans[4:], t0, t1)["swin_attn_share.train"] is None
