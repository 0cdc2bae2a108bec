"""Recomputation (``remat="block" | "stage"``) of the ResNet backbone.

One train step of a ResNet (1, 1, 1, 1) at 64x64 (the Trainer's loss, its
backward) with ``remat`` "block" and "stage", each with ``fused_bn`` False,
"stats" and "full", against the same step with ``remat="none"``: the loss,
every gradient, every BN ``running_mean`` / ``running_var`` and
``num_batches_tracked`` equal bit for bit on the CPU, and
``num_batches_tracked`` is 1. The recomputed forward re-runs train-mode BN,
which must not update the statistics a second time (flax writes
``batch_stats`` once); it does re-run the fused-BN forward, so its stats
(and, in "full", normalize) twins run once more for each of the 16 BNs
inside the blocks, and the backward ones once each.

Then the model against JAX's remat models (tests/test_models.py:160-183):
the forward and the gradients of ``sum(out**2)`` in eval mode on the same
weights (seeded random BN) within 1e-4 of each tensor's largest element,
as for the float model (tests/test_torch_models.py): the two frameworks sum
convolutions in other orders. Last, ``train --remat`` and ``--remat stage``
for one epoch each.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import make_voc_tree
from test_torch_models import randomize_bn
from test_torch_training import _batch
from yolo_tpu.models import ResNetBackbone as JResNet
from yolo_tpu.models import YOLOv1 as JYOLOv1
from yolo_tpu.models import init_model
from yolo_tpu_torch import train
from yolo_tpu_torch.convert import params_state_dict_from_jax, state_dict_from_jax
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.ops import fused_bn
from yolo_tpu_torch.training.optim import make_optimizer
from yolo_tpu_torch.training.trainer import Trainer

STAGES, SIZE = (1, 1, 1, 1), 64
N_BN = 1 + 4 * 4  # the stem, then bn1-bn3 and the downsample's BN of 4 blocks
TWINS = ("bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx")


def _step(remat, fused, monkeypatch):
    calls = dict.fromkeys(TWINS, 0)
    for name in TWINS:
        def counted(*args, _fn=getattr(fused_bn, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(fused_bn, name, counted)
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE, fused_bn=fused, remat=remat,
                         generator=torch.Generator().manual_seed(0))
    model.head.fc_layers[3].fixed_mask = torch.arange(2 * 4096).reshape(2, 4096) % 3 != 0
    trainer = Trainer(model, *make_optimizer(model), device="cpu")
    model.train()
    total, _ = trainer._loss(*_batch())
    total.backward()
    monkeypatch.undo()
    grads = {k: p.grad for k, p in model.named_parameters()}
    buffers = {k: v for k, v in model.state_dict().items()
               if "running" in k or "num_batches" in k}
    return total.detach(), grads, buffers, calls


@pytest.mark.parametrize("fused", [False, "stats", "full"])
def test_remat_step_equals_plain_step_bit_for_bit(fused, monkeypatch):
    base = _step("none", fused, monkeypatch)
    expect = {"bn_stats": N_BN, "bn_normalize": N_BN, "bn_bwd_reduce": N_BN,
              "bn_bwd_dx": N_BN} if fused == "full" else dict.fromkeys(TWINS, 0)
    if fused == "stats":
        expect["bn_stats"] = N_BN
    assert base[3] == expect
    for remat in ("block", "stage"):
        total, grads, buffers, calls = _step(remat, fused, monkeypatch)
        assert torch.equal(total, base[0]), remat
        for k, g in base[1].items():
            assert torch.equal(grads[k], g), (remat, k)
        assert len(buffers) == 3 * N_BN
        for k, v in base[2].items():
            assert torch.equal(buffers[k], v), (remat, k)
            if "num_batches" in k:
                assert int(buffers[k]) == 1, (remat, k)
        # The recomputed forward re-runs every fused BN inside the blocks.
        rerun = {k: v + (N_BN - 1 if v and k in ("bn_stats", "bn_normalize") else 0)
                 for k, v in expect.items()}
        assert calls == rerun, (remat, calls)


@pytest.fixture(scope="module")
def variables():
    model = JYOLOv1(num_classes=3, S=2, B=2, backbone=JResNet(stage_sizes=STAGES))
    return randomize_bn(init_model(model, jax.random.PRNGKey(0), image_size=SIZE), seed=2)


@pytest.mark.parametrize("remat", ["block", "stage"])
def test_forward_and_gradients_match_jax_remat_model(variables, remat):
    jmodel = JYOLOv1(num_classes=3, S=2, B=2,
                     backbone=JResNet(stage_sizes=STAGES, remat=True if remat == "block"
                                      else remat))
    x = np.random.default_rng(5).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)

    def loss(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=False)
        return jnp.sum(out ** 2), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    jgrads = params_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))

    model = create_model("resnet", 3, 2, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE, remat=remat)
    model.load_state_dict(state_dict_from_jax(variables))
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    (out ** 2).sum().backward()
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_train_cli_remat_block_then_stage(tmp_path, capsys):
    """``--remat`` (block) for epoch 1, then ``--remat stage --resume true``
    for epoch 2: the BN statistics counted one update a step (3 a epoch)."""
    make_voc_tree(tmp_path / "voc", n_images=4)
    args = ["--data-root", str(tmp_path / "voc"), "--device", "cpu", "--image-size", "64",
            "--batch-size", "2", "--num-workers", "0", "--checkpoint-dir",
            str(tmp_path / "ck"), "--no-tensorboard"]
    try:
        train.main([*args, "--epochs", "1", "--remat"])
        sd = torch.load(tmp_path / "ck" / "yolo_latest.pth", map_location="cpu",
                        weights_only=True)["model_state_dict"]
        tracked = {int(v) for k, v in sd.items() if k.endswith("num_batches_tracked")}
        assert tracked == {3}
        train.main([*args, "--epochs", "2", "--remat", "stage", "--resume", "true"])
        assert "Resumed from epoch 1, starting at 2" in capsys.readouterr().out
        sd = torch.load(tmp_path / "ck" / "yolo_latest.pth", map_location="cpu",
                        weights_only=True)["model_state_dict"]
        tracked = {int(v) for k, v in sd.items() if k.endswith("num_batches_tracked")}
        assert tracked == {6}
    finally:
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)  # ~2 GB of checkpoints
