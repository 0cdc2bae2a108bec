"""The port's training path against JAX's: one train step, the optimizer, resume.

The step: ResNet (1, 1, 1, 1) + DetectionHead at 64x64, float32, the same
weights (JAX variables with seeded random BN, carried by
``state_dict_from_jax``), the same uint8 batch and targets from
``encode_target``, and the same dropout mask: JAX's is read from
``capture_intermediates`` (the Dropout output is 0 exactly where it dropped)
and handed to the port's ``Dropout.fixed_mask``. JAX's ``Trainer`` runs with
an optax transform that keeps the raw gradients as its state, so the
gradients compared are JAX's own step's; the port's Trainer runs with
clipping off (an infinite norm) for the same reason.

Tolerances: the two sides run different convolution algorithms (XLA:CPU vs
oneDNN) and sum in other orders, so float32 differences of a few ulps per
layer accumulate through ~20 layers and a backward: the loss and its parts
agree to rtol 1e-4, the running means to 1e-4, and the running variances
after the exact F1 factor M/(M-1) to 1e-4. Gradients, per tensor, relative
to its largest element:
- ``"full"``: 1e-4 (both sides differentiate BN by the same closed form;
  measured up to 1.9e-5);
- unfused: 5e-2. flax differentiates ``var = E[x^2] - E[x]^2`` term by term,
  which cancels where a channel's mean is large against its spread, and
  torch's BN backward works from ``x - mean``. Measured on this batch:
  layer2's gradients differ by up to 2.2e-2, while the port's float32
  gradients agree with its own float64 run to 8e-6, so the gap is JAX's
  rounding; the test holds the port to its float64 run at 1e-4 as well.
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from test_torch_models import randomize_bn
from yolo_tpu.data.voc import encode_target as jax_encode_target
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu.training import Trainer as JTrainer
from yolo_tpu.training.checkpoints import save_checkpoint as jax_save_checkpoint
from yolo_tpu.training.optim import make_optimizer as jax_make_optimizer
from yolo_tpu.training.optim import multistep_lr
from yolo_tpu.training.trainer import TrainState, _prep_images
from yolo_tpu_torch.convert import params_state_dict_from_jax, state_dict_from_jax
from yolo_tpu_torch.data import DataLoader, encode_target
from yolo_tpu_torch.data.transforms import device_normalize
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.ops.loss import yolo_loss
from yolo_tpu_torch.training.checkpoints import resume, save_checkpoint
from yolo_tpu_torch.training.optim import make_optimizer
from yolo_tpu_torch.training.trainer import LOSS_KEYS, Trainer

STAGES, SIZE, BATCH = (1, 1, 1, 1), 64, 2

# Keeps the raw gradients as its state and updates nothing.
STASH = optax.GradientTransformation(
    init=lambda p: jax.tree.map(jnp.zeros_like, p),
    update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
)


def _batch(seed=0, n=BATCH):
    r = np.random.default_rng(seed)
    images = r.integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)
    targets = []
    for _ in range(n):
        boxes = r.uniform(0.2, 0.8, size=(3, 4)).astype(np.float32)
        boxes[:, 2:] *= 0.5
        cls = r.integers(0, 20, size=3).tolist()
        t = encode_target(boxes, cls)
        np.testing.assert_array_equal(t, jax_encode_target(boxes, cls))
        targets.append(t)
    return images, np.stack(targets)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied at the test's end: the checkpoints written
    here are hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def variables():
    model = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    return randomize_bn(init_model(model, jax.random.PRNGKey(0), image_size=SIZE), seed=1)


@pytest.fixture(scope="module")
def dropout_mask(variables):
    """JAX's head dropout mask for the step's rng, from capture_intermediates."""
    model = JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES))
    images, _ = _batch()
    rng = jax.random.split(jax.random.PRNGKey(5))[1]  # Trainer.train_step's dropout_rng

    @jax.jit
    def capture(v, x):
        _, mut = model.apply(v, _prep_images(x, jnp.float32), train=True, rngs={"dropout": rng},
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        return mut["intermediates"]["detection_head"]["Dropout_0"]["__call__"][0]

    dropped = np.asarray(capture(variables, jnp.asarray(images)))
    mask = dropped != 0
    assert 0.3 < mask.mean() < 0.7
    return mask


def _port(variables, fused_bn=False, **kw):
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE, fused_bn=fused_bn)
    model.load_state_dict(state_dict_from_jax(variables))
    optimizer, schedule = make_optimizer(model, **kw)
    return model, optimizer, schedule


@pytest.mark.parametrize("fused", [False, "full"])
def test_train_step_matches_jax_trainer(variables, dropout_mask, fused):
    images, targets = _batch()
    jmodel = JYOLOv1(num_classes=20, S=7, B=2,
                     backbone=JResNet(stage_sizes=STAGES, fused_bn=fused))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=STASH.init(variables["params"]), rng=jax.random.PRNGKey(5))
    new_state, jparts = JTrainer(jmodel, STASH)._train_step(
        state, jnp.asarray(images), jnp.asarray(targets))
    jgrads = params_state_dict_from_jax(jax.tree.map(np.asarray, new_state.opt_state))
    jstats = state_dict_from_jax({"params": variables["params"],
                                  "batch_stats": jax.tree.map(np.asarray,
                                                              new_state.batch_stats)})

    model, optimizer, schedule = _port(variables, fused)
    model.head.fc_layers[3].fixed_mask = torch.from_numpy(dropout_mask)
    rows = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda mod, inp, out, name=name: rows.__setitem__(
                name, inp[0].numel() // inp[0].shape[1]))
    trainer = Trainer(model, optimizer, schedule, device="cpu", clip_norm=math.inf)
    parts = trainer.train_step(images, targets)

    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    tol = 1e-4 if fused else 5e-2
    for k, g in grads.items():
        want = jgrads[k].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol * np.abs(want).max(),
                                   err_msg=k)
    if not fused:
        _assert_matches_float64(variables, dropout_mask, images, targets, grads)
    sd = model.state_dict()
    assert len(rows) == 1 + 4 * 4  # stem + 4 blocks of bn1/bn2/bn3/downsample
    for name, m in rows.items():
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(),
                                   jstats[f"{name}.running_mean"].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        old = state_dict_from_jax(variables)[f"{name}.running_var"].numpy()
        want = 0.9 * old + (jstats[f"{name}.running_var"].numpy() - 0.9 * old) \
            * m / (m - 1)
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), want,
                                   rtol=1e-4, err_msg=name)
    assert trainer.step == 1


def _assert_matches_float64(variables, mask, images, targets, grads):
    """The unfused port's float32 gradients against its own float64 run."""
    model = _port(variables)[0].double().train()
    model.head.fc_layers[3].fixed_mask = torch.from_numpy(mask)
    x = device_normalize(torch.from_numpy(images)).permute(0, 3, 1, 2).double()
    total, _ = yolo_loss(model(x), torch.from_numpy(targets).double())
    total.backward()
    for k, p in model.named_parameters():
        want = p.grad.numpy()
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_optimizer_matches_optax_chain():
    """clip + L2 + Adam + the step schedule against yolo_tpu's optax chain,
    fed the same gradients for 6 steps across a milestone at step 3; some
    gradients have a global norm above the clip limit of 10."""
    r = np.random.default_rng(0)
    shapes = {"conv": (8, 4, 3, 3), "bn": (8,), "fc": (16, 32), "bias": (16,)}
    init = {k: r.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(0, 3.0 if step % 2 else 0.05, s)).astype(np.float32)
              for k, s in shapes.items()} for step in range(6)]

    tx = jax_make_optimizer(1e-3, 5e-4, milestones_steps=[3], decay_factor=0.1)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    schedule_ref = multistep_lr(1e-3, [3], 0.1)

    module = torch.nn.Module()
    module.backbone = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    optimizer, schedule = make_optimizer(module, 1e-3, 5e-4, milestones_steps=[3],
                                         decay_factor=0.1)
    params = dict(module.named_parameters())
    for step, g in enumerate(grads):
        assert schedule.get_last_lr()[0] == pytest.approx(float(schedule_ref(step)), rel=1e-6)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in g.items():
            params[k].grad = torch.from_numpy(v.copy())
        torch.nn.utils.clip_grad_norm_(list(params.values()), 10.0)
        optimizer.step()
        schedule.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step} {k}")
    assert [schedule.lr_lambdas[0](s) for s in (2, 3, 4)] == [1.0, 0.1, 0.1]


def test_freeze_backbone_keeps_weights_and_updates_bn_stats(variables):
    model, optimizer, schedule = _port(variables, lr=1e-3, freeze_backbone=True)
    assert all(not p.requires_grad for p in model.backbone.parameters())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    Trainer(model, optimizer, schedule, device="cpu").train_step(*_batch())
    after = model.state_dict()
    for name, p in model.named_parameters():
        same = torch.equal(after[name], before[name])
        assert same == name.startswith("backbone."), name
    assert not torch.equal(after["backbone.extractor.1.running_mean"],
                           before["backbone.extractor.1.running_mean"])
    assert int(after["backbone.extractor.1.num_batches_tracked"]) == 1


def test_pth_save_and_resume_round_trip(variables, tmp_path):
    model, optimizer, schedule = _port(variables, milestones_steps=[1])
    trainer = Trainer(model, optimizer, schedule, device="cpu")
    trainer.train_step(*_batch(1))
    save_checkpoint(tmp_path / "yolo_latest.pth", 4, model, optimizer, schedule,
                    {"total": 1.5}, {"total": 2.5})

    model2, optimizer2, schedule2 = _port(variables, milestones_steps=[1])
    meta = resume(tmp_path / "yolo_latest.pth", model2, optimizer2, schedule2)
    assert meta == {"epoch": 4, "train_loss": 1.5, "val_loss": 2.5}
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    for p, p2 in zip(model.parameters(), model2.parameters()):
        s, s2 = optimizer.state[p], optimizer2.state[p2]
        assert torch.equal(s["exp_avg"], s2["exp_avg"]) and float(s2["step"]) == 1.0
    assert schedule2.last_epoch == 1 and optimizer2.param_groups[0]["lr"] == pytest.approx(1e-5)

    # One more step from each side, on the same dropout mask, lands in the same place.
    mask = torch.rand((BATCH, 4096), generator=torch.Generator().manual_seed(0)) < 0.5
    for m, opt, sch in ((model, optimizer, schedule), (model2, optimizer2, schedule2)):
        m.head.fc_layers[3].fixed_mask = mask
        Trainer(m, opt, sch, device="cpu").train_step(*_batch(2))
    for (k, v), v2 in zip(model.state_dict().items(), model2.state_dict().values()):
        torch.testing.assert_close(v2, v, rtol=1e-6, atol=1e-7, msg=k)


def test_resume_from_jax_ckpt_with_adam_state(variables, tmp_path):
    tx = jax_make_optimizer(1e-4, 5e-4, milestones_steps=[1], decay_factor=0.1)
    params = variables["params"]
    opt_state = tx.init(params)
    r = np.random.default_rng(4)
    fake_grads = jax.tree.map(lambda p: r.normal(size=p.shape).astype(np.float32), params)
    _, opt_state = jax.jit(tx.update)(fake_grads, opt_state, params)
    state = TrainState(step=jnp.asarray(1, jnp.int32), params=params,
                       batch_stats=variables["batch_stats"], opt_state=opt_state,
                       rng=jax.random.PRNGKey(0))
    jax_save_checkpoint(tmp_path / "yolo_latest.ckpt", 3, state, {"total": 1.0}, {"total": 2.0})

    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES, image_size=SIZE)
    optimizer, schedule = make_optimizer(model, 1e-4, 5e-4, milestones_steps=[1])
    meta = resume(tmp_path / "yolo_latest.ckpt", model, optimizer, schedule)
    assert meta["epoch"] == 3 and meta["val_loss"] == 2.0

    want = state_dict_from_jax(variables)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    adam = opt_state[2]  # chain: clip, add_decayed_weights, scale_by_adam, lr
    mu = params_state_dict_from_jax(jax.tree.map(np.asarray, adam.mu))
    nu = params_state_dict_from_jax(jax.tree.map(np.asarray, adam.nu))
    for name, p in model.named_parameters():
        s = optimizer.state[p]
        assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])
        assert float(s["step"]) == 1.0
    assert schedule.last_epoch == 1
    assert optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)


class _Samples:
    def __init__(self, images, targets):
        self.images, self.targets = images, targets

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.targets[i]


def test_validate_pads_and_masks_a_ragged_final_batch(variables):
    model, optimizer, schedule = _port(variables)
    trainer = Trainer(model, optimizer, schedule, device="cpu")
    images, targets = _batch(3, n=3)
    loader = DataLoader(_Samples(images, targets), batch_size=2, num_workers=0,
                        drop_last=False)
    got = trainer.validate(loader)
    first = trainer.eval_step(images[:2], targets[:2])
    last = trainer.eval_step(images[2:], targets[2:])
    for k in LOSS_KEYS:
        want = (float(first[k]) + float(last[k])) / 2
        assert got[k] == pytest.approx(want, rel=1e-5), k
    # compute_map adds the evaluator's keys (the precise path at confidence
    # 0.01 and NMS 0.4, the ragged batch masked) to the same losses.
    from yolo_tpu_torch.metrics import evaluate_model

    with_map = trainer.validate(loader, compute_map=True)
    assert {k: with_map[k] for k in LOSS_KEYS} == got
    ref = evaluate_model(model, loader, conf_threshold=0.01, nms_threshold=0.4,
                         verbose=False, device="cpu")
    keys = ("mAP50:95", "mAP50", "mAP75", "precision", "recall", "mAP50:95_small",
            "mAP50:95_medium", "mAP50:95_large")
    assert set(with_map) == set(LOSS_KEYS) | set(keys)
    assert {k: with_map[k] for k in keys} == {k: ref[k] for k in keys}
