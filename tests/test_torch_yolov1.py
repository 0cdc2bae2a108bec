"""The port's 24-conv YOLOv1 (``YOLOv1Backbone`` + ``SimpleHead``) against JAX's.

JAX's default ``YOLOv1`` (the 24-conv backbone, full widths: JAX gives it no
width knob) is initialised at 64x64 in float32, where the backbone's map is
1x1 and fc1 is 1024 -> 4096; its variables go to the port through
``state_dict_from_jax``. On the same seeded NHWC images:

- the backbone, the head and the whole model in eval mode agree within
  ``1e-4 * max|ref|`` (the two frameworks sum the convolutions in other
  orders; measured ~5e-7 of max|ref|);
- one train step (loss and every gradient, on JAX's dropout mask read from
  ``capture_intermediates``) agrees as the ResNet's unfused step does
  (tests/test_torch_training.py): the loss parts to rtol 1e-4 and each
  gradient within 1e-4 of its tensor's largest element; the model has no BN,
  so no float32 cancellation widens it;
- JAX's ``convert_reference_state_dict(port_sd, backbone="yolov1")`` gives
  JAX's variables exactly, and ``state_dict_from_jax`` inverts it.

Then the files and CLIs: a JAX 24-conv ``.ckpt`` with Adam state resumes
into the port (weights, moments and step exactly) and ``train --backbone
yolov1`` trains on from it for an epoch; ``evaluate`` and ``predict
--backbone yolov1`` run on a synthetic VOC tree of centred dogs with a
model whose fc2 bias finds them; the refusals; JAX's backbone dispatch.
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from test_torch_evaluate_cli import BOX, DOG, centered_voc_tree
from test_torch_training import STASH
from yolo_tpu.convert import convert_reference_state_dict
from yolo_tpu.data.voc import encode_target as jax_encode_target
from yolo_tpu.models import SimpleHead as JSimpleHead
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import YOLOv1Backbone as JYOLOv1Backbone
from yolo_tpu.models import init_model
from yolo_tpu.training import Trainer as JTrainer
from yolo_tpu.training.checkpoints import save_checkpoint as jax_save_checkpoint
from yolo_tpu.training.optim import make_optimizer as jax_make_optimizer
from yolo_tpu.training.trainer import TrainState, _prep_images
from yolo_tpu_torch import evaluate, predict, train
from yolo_tpu_torch.convert import model_layout, params_state_dict_from_jax, state_dict_from_jax
from yolo_tpu_torch.data import DataLoader, create_voc_datasets, encode_target
from yolo_tpu_torch.metrics import evaluate_model
from yolo_tpu_torch.models import (Backbone, DetectionHead, SimpleHead, YOLOv1,
                                   YOLOv1Backbone, create_model)
from yolo_tpu_torch.models.backbones import yolov1_conv_indices
from yolo_tpu_torch.training.checkpoints import load_model, resume
from yolo_tpu_torch.training.optim import make_optimizer
from yolo_tpu_torch.training.trainer import LOSS_KEYS, Trainer

SIZE, BATCH = 64, 2


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: the checkpoints and
    engine artifacts written here are tens to hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def variables():
    model = JYOLOv1(num_classes=20, S=7, B=2)
    return jax.tree.map(np.array, init_model(model, jax.random.PRNGKey(0), image_size=SIZE))


def _port(variables):
    model = create_model("yolov1", 20, 7, 2, device="cpu", image_size=SIZE)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


@pytest.fixture(scope="module")
def port_model(variables):
    return _port(variables)


def _images(seed=1):
    return np.random.default_rng(seed).normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("part", ["backbone", "head", "model"])
def test_eval_forward_matches_jax(variables, port_model, part):
    x = _images()
    params = variables["params"]
    feats = np.asarray(JYOLOv1Backbone().apply({"params": params["backbone"]}, jnp.asarray(x)))
    with torch.no_grad():
        if part == "backbone":
            ref = feats
            got = port_model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
            got = got.permute(0, 2, 3, 1).numpy()
            assert got.shape == (BATCH, 1, 1, 1024)
        elif part == "head":
            ref = np.asarray(JSimpleHead().apply({"params": params["detection_head"]},
                                                 jnp.asarray(feats)))
            got = port_model.head(torch.from_numpy(feats).permute(0, 3, 1, 2)).numpy()
            assert got.shape == (BATCH, 7 * 7 * 30)
        else:
            ref = np.asarray(jax.jit(JYOLOv1().apply)(variables, jnp.asarray(x)))
            got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
            assert got.shape == (BATCH, 7, 7, 30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_reference_layout_round_trips_through_jax_converter(variables, port_model):
    sd = port_model.state_dict()
    assert [k for k in sd if k.endswith(".weight")] == (
        [f"backbone.features.{i}.weight" for i in yolov1_conv_indices()]
        + ["head.1.weight", "head.4.weight"])
    assert len(yolov1_conv_indices()) == 24 and sd["head.1.weight"].shape == (4096, 1024)
    # The head map is 1x1 at 64x64; the converter's S is that side.
    back = convert_reference_state_dict(sd, backbone="yolov1", S=1)
    assert back["batch_stats"] == {}
    flat_ref = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(flat_ref) == len(flat_back) == 2 * 24 + 4
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    again = state_dict_from_jax(back)
    assert list(again) == list(sd)
    assert all(torch.equal(again[k], v) for k, v in sd.items())
    assert model_layout(sd) == {"backbone": "yolov1", "image_size": SIZE}


def _batch():
    r = np.random.default_rng(0)
    images = r.integers(0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    targets = []
    for _ in range(BATCH):
        boxes = r.uniform(0.2, 0.8, size=(3, 4)).astype(np.float32)
        boxes[:, 2:] *= 0.5
        cls = r.integers(0, 20, size=3).tolist()
        t = encode_target(boxes, cls)
        np.testing.assert_array_equal(t, jax_encode_target(boxes, cls))
        targets.append(t)
    return images, np.stack(targets)


def test_train_step_matches_jax_trainer(variables):
    images, targets = _batch()
    jmodel = JYOLOv1(num_classes=20, S=7, B=2)
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def dropped(v, x):
        _, mut = jmodel.apply(v, _prep_images(x, jnp.float32), train=True,
                              rngs={"dropout": jax.random.split(rng)[1]},
                              mutable=["intermediates"],
                              capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        return mut["intermediates"]["detection_head"]["Dropout_0"]["__call__"][0]

    mask = np.asarray(dropped(variables, jnp.asarray(images))) != 0
    assert 0.3 < mask.mean() < 0.7
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats={}, opt_state=STASH.init(variables["params"]), rng=rng)
    new_state, jparts = JTrainer(jmodel, STASH)._train_step(
        state, jnp.asarray(images), jnp.asarray(targets))
    jgrads = params_state_dict_from_jax(jax.tree.map(np.asarray, new_state.opt_state))

    model = _port(variables)
    model.head[3].fixed_mask = torch.from_numpy(mask)
    trainer = Trainer(model, *make_optimizer(model), device="cpu", clip_norm=math.inf)
    parts = trainer.train_step(images, targets)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_jax_ckpt_resumes_then_train_cli_trains_on(variables, tmp_path, capsys):
    from test_torch_data import make_voc_tree

    tx = jax_make_optimizer(1e-4, 5e-4, milestones_steps=[], decay_factor=0.1)
    params = variables["params"]
    r = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: r.normal(size=p.shape).astype(np.float32), params)
    _, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    state = TrainState(step=jnp.asarray(1, jnp.int32), params=params, batch_stats={},
                       opt_state=opt_state, rng=jax.random.PRNGKey(0))
    ckpt = tmp_path / "jax24.ckpt"
    jax_save_checkpoint(ckpt, 1, state, {"total": 1.0}, {"total": 2.0})
    del grads, state

    model = create_model("yolov1", 20, 7, 2, device="cpu", image_size=SIZE)
    optimizer, schedule = make_optimizer(model, 1e-4, 5e-4)
    assert resume(ckpt, model, optimizer, schedule)["epoch"] == 1
    want = state_dict_from_jax(variables)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    adam = opt_state[2]  # chain: clip, add_decayed_weights, scale_by_adam, lr
    mu = params_state_dict_from_jax(jax.tree.map(np.asarray, adam.mu))
    nu = params_state_dict_from_jax(jax.tree.map(np.asarray, adam.nu))
    for name, p in model.named_parameters():
        s = optimizer.state[p]
        assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])
        assert float(s["step"]) == 1.0
    assert load_model(ckpt)[1] == {"backbone": "yolov1", "image_size": SIZE}
    del model, optimizer, mu, nu, opt_state

    make_voc_tree(tmp_path / "voc", n_images=4)
    ck = tmp_path / "ck"
    try:
        train.main(["--data-root", str(tmp_path / "voc"), "--device", "cpu", "--backbone",
                    "yolov1", "--image-size", str(SIZE), "--batch-size", "2",
                    "--num-workers", "0", "--checkpoint-dir", str(ck), "--no-tensorboard",
                    "--epochs", "2", "--resume", str(ckpt)])
        assert "Resumed from epoch 1, starting at 2 (optimizer step 1)" in \
            capsys.readouterr().out
        latest = torch.load(ck / "yolo_latest.pth", map_location="cpu", weights_only=True)
        assert latest["epoch"] == 2 and "head.4.bias" in latest["model_state_dict"]
        steps = {float(s["step"]) for s in latest["optimizer_state_dict"]["state"].values()}
        assert steps == {4.0}  # 1 from JAX + 3 of the epoch
    finally:
        shutil.rmtree(ck, ignore_errors=True)


def _detecting_model():
    """A seeded 24-conv model whose grid is its fc2 bias: a dog box of side
    BOX in both slots of the middle cell."""
    model = create_model("yolov1", 20, 7, 2, device="cpu", image_size=SIZE,
                         generator=torch.Generator().manual_seed(1))
    bias = torch.zeros(7, 7, 30)
    bias[3, 3, 0:10] = torch.tensor([0.5, 0.5, BOX, BOX, 1.0] * 2)
    bias[3, 3, 10 + DOG] = 1.0
    with torch.no_grad():
        model.head[4].weight.zero_()
        model.head[4].bias.copy_(bias.reshape(-1))
    return model


@pytest.fixture(scope="module")
def detecting(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolov1_cli")
    centered_voc_tree(root / "voc")
    model = _detecting_model()
    ckpt = root / "yolo24.pth"
    torch.save({"epoch": 2, "model_state_dict": model.state_dict()}, ckpt)
    yield root, ckpt, model
    ckpt.unlink()


def test_evaluate_cli_matches_evaluate_model(detecting, capsys):
    root, ckpt, model = detecting
    got = evaluate.main(["--checkpoint", str(ckpt), "--data-root", str(root / "voc"),
                         "--backbone", "yolov1", "--device", "cpu", "--batch-size", "2",
                         "--num-workers", "0"])
    assert "Evaluation dataset: 5 images" in capsys.readouterr().out
    dataset = create_voc_datasets([("2007", "test")], root=root / "voc",
                                  target_size=(SIZE, SIZE), augment=False,
                                  normalize_host=False)
    loader = DataLoader(dataset, batch_size=2, shuffle=False, num_workers=0, drop_last=False)
    assert got == evaluate_model(model, loader, verbose=False, device="cpu")
    assert got[f"AP50_class_{DOG}"] == pytest.approx(1.0, abs=1e-6)


def test_predict_cli_finds_the_dogs(detecting, tmp_path, capsys):
    root, ckpt, _ = detecting
    images = root / "voc" / "VOCdevkit" / "VOC2007" / "JPEGImages"
    predict.main(["--checkpoint", str(ckpt), "--image-dir", str(images), "--backbone",
                  "yolov1", "--device", "cpu", "--output", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert out.count("dog: 100.00%") == 5 and "Processed 5 images, 5 detections" in out
    assert len(list((tmp_path / "out").iterdir())) == 5


@pytest.mark.parametrize("argv, message", [
    (["--int8"], "--int8 supports the resnet flagship only"),
    (["--backbone", "resnet"], "holds a yolov1 model"),
])
def test_predict_refusals(detecting, argv, message):
    root, ckpt, _ = detecting
    image = next((root / "voc" / "VOCdevkit" / "VOC2007" / "JPEGImages").iterdir())
    args = ["--checkpoint", str(ckpt), "--image", str(image), "--device", "cpu",
            "--backbone", "yolov1", *argv]
    with pytest.raises(SystemExit) as exc:
        predict.main(args)
    assert message in str(exc.value)


@pytest.mark.parametrize("argv, message", [
    (["evaluate", "--int8", "--calib-data", "2012:train"], "resnet flagship only"),
    (["train", "--remat"], "need --backbone resnet"),
])
def test_cli_refusals(tmp_path, argv, message):
    cli, *flags = argv
    base = (["--checkpoint", str(tmp_path / "x.pth")] if cli == "evaluate"
            else ["--data-root", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        {"evaluate": evaluate, "train": train}[cli].main(
            [*base, "--device", "cpu", "--backbone", "yolov1", *flags])
    assert message in str(exc.value)


class _Custom(Backbone):
    def forward(self, x):
        return x.new_zeros((x.shape[0], 2048, 2, 2))


def test_backbone_dispatch():
    with pytest.raises(NotImplementedError):
        Backbone()(torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="custom backbone"):
        YOLOv1(backbone=_Custom(), device="cpu")
    default = YOLOv1(device="cpu", image_size=SIZE)
    assert isinstance(default.backbone, YOLOv1Backbone)
    assert isinstance(default.head, SimpleHead) and default.head.num_classes == 20
    head = DetectionHead(2048, 20, 7, 2, feature_size=1, device="cpu")
    custom = YOLOv1(backbone=_Custom(), head=head, device="cpu")
    with torch.no_grad():
        assert custom(torch.zeros(1, 3, 64, 64)).shape == (1, 7, 7, 30)
    with pytest.raises(ValueError, match="resnet backbone only"):
        create_model("yolov1", device="cpu", remat="block")
    with pytest.raises(ValueError, match="Unknown backbone"):
        create_model("vgg", device="cpu")
    # The head's 2-D output is reshaped to the grid.
    model = create_model("yolov1", 3, 2, 2, device="cpu", image_size=SIZE)
    with torch.no_grad():
        assert model.head(torch.zeros(1, 1024, 1, 1)).shape == (1, 2 * 2 * 13)
        assert model(torch.zeros(1, 3, SIZE, SIZE)).shape == (1, 2, 2, 13)
