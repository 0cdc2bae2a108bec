"""JAX references of the parallel CPU tests, computed in the test process.

The model is the port tests' tiny ResNet: ``ResNetBackbone(stage_sizes=(1, 1,
1, 1))`` + ``DetectionHead`` at 64x64, JAX variables with seeded random BN
carried to the port by ``state_dict_from_jax``. JAX's meshes are made on
conftest's 8 virtual CPU devices (``make_mesh(..., devices=jax.devices()[:n])``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import linen as nn

from test_torch_models import randomize_bn
from torch_parallel_worker import SIZE, STAGES
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu.parallel import make_mesh
from yolo_tpu.training import Trainer as JTrainer
from yolo_tpu.training.trainer import TrainState, _prep_images
from yolo_tpu_torch.convert import state_dict_from_jax
from yolo_tpu_torch.data import encode_target

RNG_SEED = 5  # the TrainState's rng (a fresh key each time: the step donates it)


def jmodel(fused=False):
    return JYOLOv1(num_classes=20, S=7, B=2, backbone=JResNet(stage_sizes=STAGES, fused_bn=fused))


@functools.lru_cache(maxsize=None)
def variables():
    return randomize_bn(init_model(jmodel(), jax.random.PRNGKey(0), image_size=SIZE), seed=1)


def port_state_dict():
    return {k: v.clone() for k, v in state_dict_from_jax(variables()).items()}


def batch(seed: int, n: int):
    """Seeded uint8 images and ``encode_target`` grids of 3 boxes each."""
    r = np.random.default_rng(seed)
    images = r.integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)
    targets = []
    for _ in range(n):
        boxes = r.uniform(0.2, 0.8, size=(3, 4)).astype(np.float32)
        boxes[:, 2:] *= 0.5
        targets.append(encode_target(boxes, r.integers(0, 20, size=3).tolist()))
    return images, np.stack(targets)


def dropout_masks(images, steps: int):
    """JAX's global head-dropout masks of ``steps`` Trainer steps from
    :data:`RNG_SEED`, read with ``capture_intermediates`` (the Dropout output is
    0 exactly where it dropped)."""
    model = jmodel()

    @jax.jit
    def capture(v, x, rng):
        _, mut = model.apply(v, _prep_images(x, jnp.float32), train=True, rngs={"dropout": rng},
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        return mut["intermediates"]["detection_head"]["Dropout_0"]["__call__"][0]

    masks, rng = [], jax.random.PRNGKey(RNG_SEED)
    for _ in range(steps):
        rng, drop = jax.random.split(rng)
        masks.append(np.asarray(capture(variables(), jnp.asarray(images), drop)) != 0)
    return masks


def record_global_norm() -> optax.GradientTransformation:
    """An identity transformation whose state is its input's global norm:
    the pre-clip gradient norm of the last step, read from the opt state."""
    return optax.GradientTransformation(
        lambda params: jnp.zeros((), jnp.float32),
        lambda updates, state, params=None: (updates, optax.global_norm(updates)))


def meshed_steps(images, targets, n_data: int, n_model: int, fused, lr: float, steps: int,
                 clip_norm: float):
    """JAX's meshed Trainer with ``clip_by_global_norm`` + SGD: (total loss a
    step, pre-clip global gradient norm a step, the final torch state dict)."""
    tx = optax.chain(record_global_norm(), optax.clip_by_global_norm(clip_norm),
                     optax.sgd(lr))
    v = variables()
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    trainer = JTrainer(jmodel(fused), tx, mesh=mesh)
    state = trainer.shard_state(TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), rng=jax.random.PRNGKey(RNG_SEED)))
    x, y = trainer.put_batch(images, targets)
    losses, norms = [], []
    for _ in range(steps):
        state, parts = trainer._train_step(state, x, y)
        losses.append(float(parts["total"]))
        norms.append(float(state.opt_state[0]))
    final = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return losses, norms, state_dict_from_jax(final)


# ------------------------------------------------------- meshed training
# SGD at lr 0.1 after a clip that binds (the gradient norms are 20-90): each
# step moves the parameters by 0.1 in L2, well above the float32 rounding of
# the parameters themselves, so each parameter's change over the steps is
# held to a relative bound (:func:`step_errors`).
N, STEPS, LR = 4, 3, 0.1
STEP_RTOL, LEAF_STEP_RTOL = 1e-3, 2e-2


def jax_ckpt(path):
    """A JAX ``.ckpt`` of the tiny model with Adam moments from one update on
    seeded gradients (step 1, epoch 3); returns (mu, nu) as torch state dicts."""
    from yolo_tpu.training.checkpoints import save_checkpoint as jax_save_checkpoint
    from yolo_tpu.training.optim import make_optimizer as jax_make_optimizer
    from yolo_tpu_torch.convert import params_state_dict_from_jax

    tx = jax_make_optimizer(1e-4, 5e-4, milestones_steps=[1], decay_factor=0.1)
    params = variables()["params"]
    r = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: r.normal(size=p.shape).astype(np.float32), params)
    _, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    state = TrainState(step=jnp.asarray(1, jnp.int32), params=params,
                       batch_stats=variables()["batch_stats"], opt_state=opt_state,
                       rng=jax.random.PRNGKey(0))
    jax_save_checkpoint(path, 3, state, {"total": 1.0}, {"total": 2.0})
    adam = opt_state[2]  # chain: clip, add_decayed_weights, scale_by_adam, lr
    return (params_state_dict_from_jax(jax.tree.map(np.asarray, adam.mu)),
            params_state_dict_from_jax(jax.tree.map(np.asarray, adam.nu)))


def train_world(workdir, n_data: int, n_model: int, jax_mode, val: bool = False,
                ckpt: bool = False):
    """One gloo world of the port's meshed Trainer and its references.

    Every run steps with SGD after clipping on the global norm. Adam's
    first updates are about ``lr * sign(g)``: float-noise differences of
    near-zero gradient elements (a different convolution algorithm, another
    summation order) would become lr-sized parameter differences, so the
    meshed steps are compared through SGD, and the Adam recipe itself
    against optax by ``test_torch_training``. Runs: 0 = ``jax_mode``, clip
    limit 1 (it binds: the norms are 20-90), held against JAX's meshed
    Trainer; 1, 2 = fused_bn False (limit 10, lr / 10) and "full" (limit
    1), both moving the parameters by lr in L2 a step, held
    against the port's own single-process steps on the global batch
    (``val``: the ragged validation passes after run 1). ``ckpt``: the
    world also resumes :func:`jax_ckpt`. Returns a dict of everything
    compared.
    """
    import torch

    import torch_parallel_worker as W

    images, targets = batch(0, N)
    masks = dropout_masks(images, STEPS)
    runs = [dict(mode=jax_mode, optimizer="sgd", lr=LR, clip_norm=1.0),
            dict(mode=False, optimizer="sgd", lr=LR / 10, clip_norm=10.0),
            dict(mode="full", optimizer="sgd", lr=LR, clip_norm=1.0)]
    if val:
        vi, vt = batch(1, 13)  # JAX test_trainer's ragged case: 8 + 5 on an 8-batch loader
        runs[1]["val"] = [W.ListLoader([(vi[:8], vt[:8]), (vi[8:], vt[8:])], 8),
                          W.ListLoader([(vi[:12], vt[:12]), (vi[12:], vt[12:])], 12)]
    cfg = dict(state_dict=port_state_dict(), images=images, targets=targets, masks=masks,
               runs=runs)
    moments = None
    if ckpt:
        moments = jax_ckpt(workdir / "yolo_latest.ckpt")
        cfg["ckpt"] = workdir / "yolo_latest.ckpt"
    torch.save(cfg, workdir / "inputs.pt")
    handle = W.start("train", n_data, n_model, workdir)
    jax_losses, jax_norms, jax_state = meshed_steps(images, targets, n_data, n_model, jax_mode,
                                         LR, STEPS, 1.0)
    torch.set_num_threads(1)
    solo = []
    for run in runs[1:]:
        # Under a data axis of several ranks every train-mode BN is synchronized "full".
        model = W.tiny_model(cfg["state_dict"], "full" if n_data > 1 else run["mode"])
        trainer = W.make_trainer(model, None, run["optimizer"], run["lr"], run["clip_norm"])
        losses, norms = W.run_steps(trainer, cfg)
        solo.append(dict(losses=losses, norms=norms, state=model.state_dict(),
                         val=[trainer.validate(loader) for loader in run.get("val", ())]))
    outs = W.finish(handle)
    if ckpt:
        (workdir / "yolo_latest.ckpt").unlink()
    return dict(cfg=cfg, outs=outs, jax_losses=jax_losses, jax_norms=jax_norms,
                jax_state=jax_state, solo=solo,
                n_data=n_data, n_model=n_model, moments=moments)


def global_losses(world, run: int):
    """The global batch's total loss a step: the mean of the data ranks' losses."""
    outs = world["outs"][::world["n_model"]]
    return [float(np.mean([o["runs"][run]["losses"][i]["total"] for o in outs]))
            for i in range(STEPS)]


def step_errors(got, want, start):
    """How far ``got``'s parameter changes from ``start`` are from ``want``'s:
    (the relative L2 error of all the changes as one vector, {name: that of
    each parameter's}). BN buffers are left out."""
    errors, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        if not w.dtype.is_floating_point or "running_" in k:
            continue
        err = (got[k].double() - w.double()).square().sum().item()
        size = (w.double() - start[k].double()).square().sum().item()
        errors[k] = (err / size) ** 0.5
        num, den = num + err, den + size
    return (num / den) ** 0.5, errors


def assert_steps_match(got, want, start):
    """Every parameter's change within :data:`LEAF_STEP_RTOL` of the
    reference's in relative L2, and all of them together within
    :data:`STEP_RTOL`. (A parameter's own bound is wider: the few scale and
    shift elements of a late BN move with the ReLU decisions that a rounding
    flips from one summation order to another, up to 0.9% in 3 steps here.)"""
    total, errors = step_errors(got, want, start)
    assert total <= STEP_RTOL, total
    worst = max(errors, key=errors.get)
    assert errors[worst] <= LEAF_STEP_RTOL, (worst, errors[worst])


def assert_matches_jax(world):
    """JAX test_trainer.py:62-92's bounds: loss rtol 2e-4 (and the pre-clip
    global gradient norm too, every step), params rtol 2e-3 / atol 1e-4;
    and each parameter's change over the steps against JAX's
    (:func:`assert_steps_match`), which the params' bound alone would not
    see."""
    np.testing.assert_allclose(global_losses(world, 0), world["jax_losses"], rtol=2e-4)
    for o in world["outs"]:
        np.testing.assert_allclose(o["runs"][0]["norms"], world["jax_norms"], rtol=2e-4)
    state = world["outs"][0]["runs"][0]["state"]
    for k, want in world["jax_state"].items():
        if "running_" in k or "num_batches" in k:
            continue  # flax keeps the biased variance (ROADMAP F1)
        np.testing.assert_allclose(state[k].numpy(), want.numpy(), rtol=2e-3, atol=1e-4,
                                   err_msg=k)
    assert_steps_match(state, world["jax_state"], world["cfg"]["state_dict"])


def assert_matches_one_process(world, run: int):
    """Loss rtol 1e-5 every step; every param and BN buffer rtol 1e-5 /
    atol 1e-6 after the steps; the first step's global gradient norm rtol
    1e-5 and every step's 1e-4 on every rank; each parameter's change over
    the steps (:func:`assert_steps_match`). (Gradients are not compared
    element for element: the global statistics round otherwise than one
    process's, and on this batch that flips the ReLU decision of a few
    activations within a rounding of 0, which moves some stem and layer1
    gradients by 0.3% in relative L2, as torch's own float32 BN differs from
    its float64 BN there.)"""
    got, want = world["outs"][0]["runs"][run], world["solo"][run - 1]
    np.testing.assert_allclose(global_losses(world, run),
                               [p["total"] for p in want["losses"]], rtol=1e-5)
    for o in world["outs"]:
        np.testing.assert_allclose(o["runs"][run]["norms"][0], want["norms"][0], rtol=1e-5)
        np.testing.assert_allclose(o["runs"][run]["norms"], want["norms"], rtol=1e-4)
    assert_steps_match(got["state"], want["state"], world["cfg"]["state_dict"])
    assert sorted(got["state"]) == sorted(want["state"])
    for k, v in want["state"].items():
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            assert bool((got["state"][k] == v).all()), k
    bn_layers = 17  # the stem's and the one bottleneck a stage's 4
    n_data = world["n_data"]
    for o in world["outs"]:
        assert o["runs"][run]["all_reduces"] == (2 * bn_layers * STEPS if n_data > 1 else 0)


def assert_mesh_layout(world):
    """Coordinates and group sizes as JAX's reshape(n_data, n_model); batch
    rows equal to JAX's ``batch_sharding`` shards; shard shapes of JAX's
    ``param_shardings`` spec; the gathered state bit for bit."""
    from yolo_tpu.parallel import param_shardings, put_sharded

    n_data, n_model = world["n_data"], world["n_model"]
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    rows = np.arange(8 * 3).reshape(8, 3)
    shards = {s.device.id: np.asarray(s.data) for s in put_sharded(mesh, rows).addressable_shards}
    specs = param_shardings(mesh, variables()["params"])
    head = variables()["params"]["detection_head"]
    for rank, o in enumerate(world["outs"]):
        info = o["mesh"]
        assert info["coords"] == (rank // n_model, n_data, rank % n_model, n_model)
        assert info["groups"] == (n_data, n_model, n_data)
        np.testing.assert_array_equal(info["rows"], shards[jax.devices()[rank].id])
        for fc, idx in (("fc1", 1), ("fc2", 4)):
            kernel = head[fc]["Dense_0"]["kernel"]
            k_shape = specs["detection_head"][fc]["Dense_0"]["kernel"].shard_shape(kernel.shape)
            bias = head[fc]["Dense_0"]["bias"]
            b_shape = specs["detection_head"][fc]["Dense_0"]["bias"].shard_shape(bias.shape)
            assert info["shapes"][f"head.fc_layers.{idx}.weight"] == k_shape[::-1]
            assert info["shapes"][f"head.fc_layers.{idx}.bias"] == b_shape
        assert info["full_equal"]


def assert_validation(world):
    """The ragged validation passes equal the single-process ones within JAX
    test_trainer.py:215-236's rtol 2e-4 / atol 1e-6, on every rank."""
    want = world["solo"][0]["val"]
    assert want
    for o in world["outs"]:
        for got, ref in zip(o["runs"][1]["val"], want):
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=1e-6, err_msg=k)
