"""Snapshots and checkpoints under a mesh, and the evaluate CLI under torchrun.

A (2, 2) gloo world (``torch_parallel_worker.task_snapshot``) trains the tiny
ResNet a step with Adam, writes DCP snapshots (the fc1/fc2 shards as
DTensors) and the gathered ``yolo_latest.pth``, then restores the latest
snapshot into a trainer of other weights: params, BN buffers, Adam state,
the schedule, the Dropout generator and the metrics come back bit for bit,
and the restored run's next step equals the original's. The ``.pth`` loads
in ``load_model`` with the single-process layout, and ``evaluate
--mesh-data 2`` under torchrun on it reports what one process reports.
"""

import shutil

import pytest
import torch

import torch_parallel_jax as J
import torch_parallel_worker as W
from test_torch_data import make_voc_tree
from test_torch_parallel_cli import torchrun
from yolo_tpu_torch import evaluate
from yolo_tpu_torch.training.checkpoints import load_model


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("snap22")
    images, targets = J.batch(0, 8)
    torch.save(dict(state_dict=J.port_state_dict(), images=images, targets=targets),
               workdir / "inputs.pt")
    return W.spawn("snapshot", 2, 2, workdir), workdir


def test_snapshot_restores_bit_for_bit(world):
    outs, workdir = world
    for out in outs:
        assert out["step"] == 4 and out["schedule"] == 2
        assert out["metrics"] == {"train_loss": 0.0, "val_loss": 1.5, "best_val_loss": 0.0,
                                  "best_map": 0.25}
        assert out["restored_equal"] and out["second_step_equal"]
    assert sorted(p.name for p in (workdir / "ck" / "dcp").iterdir()) == ["2", "3", "4"]
    shutil.rmtree(workdir / "ck" / "dcp")  # ~1.7 GB


def test_meshed_pth_loads_in_the_single_process_layout(world):
    outs, workdir = world
    state_dict, layout, meta = load_model(workdir / "ck" / "yolo_latest.pth")
    assert layout == {"backbone": "resnet", "image_size": W.SIZE, "stage_sizes": W.STAGES}
    assert meta["epoch"] == 1
    saved = outs[0]["saved"]
    assert sorted(state_dict) == sorted(saved)
    assert all(torch.equal(state_dict[k], v) for k, v in saved.items())
    assert state_dict["head.fc_layers.1.weight"].shape == (4096, 1024)
    W.tiny_model(state_dict)  # loads strictly


def test_evaluate_mesh_data_under_torchrun(world, tmp_path):
    _, workdir = world
    make_voc_tree(tmp_path / "voc", n_images=5)
    ckpt = workdir / "ck" / "yolo_latest.pth"
    args = ["--checkpoint", str(ckpt), "--data-root", str(tmp_path / "voc"), "--year", "2012",
            "--image-set", "trainval", "--batch-size", "4", "--num-workers", "0",
            "--device", "cpu"]
    evaluate.main(args)
    want = (ckpt.parent / "evaluation_results.txt").read_text()
    (ckpt.parent / "evaluation_results.txt").unlink()
    out = torchrun("yolo_tpu_torch.evaluate", *args, "--mesh-data", "2")
    assert "Evaluation mesh" in out
    assert (ckpt.parent / "evaluation_results.txt").read_text() == want
    shutil.rmtree(workdir / "ck")  # the .pth, ~0.6 GB
