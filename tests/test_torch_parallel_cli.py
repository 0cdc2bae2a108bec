"""The train CLI under torchrun on two CPU ranks (gloo), and the mesh
messages.

``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
yolo_tpu_torch.train --device cpu --mesh-data 2 --orbax-checkpoints`` at
64x64 on a synthetic VOC tree writes the gathered ``.pth`` files and a DCP
snapshot; ``--resume orbax`` carries the step, the schedule and the best
loss on. (The evaluate CLI under torchrun is in
``test_torch_parallel_state.py``, on the tiny ResNet.) In process: a mesh
that does not fill the world and a batch that does not divide by the data
axis exit with JAX's messages before anything is built.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_data import make_voc_tree
from yolo_tpu_torch import evaluate, train

REPO = Path(__file__).resolve().parents[1]


def torchrun(module: str, *args: str, nproc: int = 2) -> str:
    """Run ``module`` on ``nproc`` CPU ranks; its output (raises on failure)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(nproc), "-m", module, *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return run.stdout + run.stderr


@pytest.fixture
def run_dir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path / "ck", ignore_errors=True)  # ~3 GB of checkpoints and snapshots


def test_train_mesh_data_with_snapshots_then_resume_orbax(run_dir):
    make_voc_tree(run_dir / "voc", n_images=3)
    args = ["--data-root", str(run_dir / "voc"), "--device", "cpu", "--image-size", "64",
            "--batch-size", "2", "--num-workers", "0", "--checkpoint-dir", str(run_dir / "ck"),
            "--no-tensorboard", "--mesh-data", "2", "--orbax-checkpoints",
            "--freeze-backbone"]  # fewer Adam moments to write
    out = torchrun("yolo_tpu_torch.train", *args, "--epochs", "1")
    ck = run_dir / "ck"
    assert out.count("Epoch 1/1") == 1  # only the first rank prints
    assert sorted(p.name for p in ck.iterdir()) == ["dcp", "yolo_best.pth", "yolo_latest.pth"]
    assert sorted(p.name for p in (ck / "dcp").iterdir()) == ["1"]
    latest = torch.load(ck / "yolo_latest.pth", map_location="cpu", weights_only=True)
    # train = 2007 trainval (3) + 2012 train (2) = 5 images -> 2 a data rank -> 2 steps of 1;
    # val = 2012 val, 1 image: the second data rank's row is padding.
    assert latest["epoch"] == 1 and latest["scheduler_state_dict"]["last_epoch"] == 2
    (ck / "yolo_best.pth").unlink()  # ~0.8 GB each: keep the tmp dir small
    (ck / "yolo_latest.pth").unlink()

    out = torchrun("yolo_tpu_torch.train", *args, "--epochs", "2", "--resume", "orbax")
    assert "Resumed from DCP snapshot 1, starting at 2 (optimizer step 2)" in out
    assert sorted(p.name for p in (ck / "dcp").iterdir()) == ["1", "2"]
    latest = torch.load(ck / "yolo_latest.pth", map_location="cpu", weights_only=True)
    assert latest["epoch"] == 2 and latest["scheduler_state_dict"]["last_epoch"] == 4
    steps = {float(s["step"]) for s in latest["optimizer_state_dict"]["state"].values()}
    assert steps == {4.0}


@pytest.mark.parametrize("cli, flags, message", [
    (train, ["--mesh-data", "2"], r"mesh 2x1 != 1 devices"),
    (train, ["--mesh-model", "2"], r"mesh 0x2 != 1 devices"),
    (train, ["--mesh-data", "2", "--batch-size", "3"], r"--batch-size 3 must be divisible"),
    (evaluate, ["--mesh-model", "2"], r"mesh 1x2 != 1 devices"),
    (evaluate, ["--mesh-data", "4", "--batch-size", "6"], r"--batch-size 6 must be divisible"),
])
def test_mesh_messages(tmp_path, cli, flags, message):
    first = ["--data-root", str(tmp_path)] if cli is train else [
        "--checkpoint", str(tmp_path / "none.pth")]
    with pytest.raises(SystemExit, match=message):
        cli.main([*first, "--device", "cpu", *flags])
    assert not torch.distributed.is_initialized()
