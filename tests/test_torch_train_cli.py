"""``python -m yolo_tpu_torch.train`` end to end on the CPU, on a synthetic VOC tree.

One epoch at 64x64, batch 2, writes ``yolo_latest.pth`` and ``yolo_best.pth``
with the reference's keys; ``--resume true --epochs 2`` starts at epoch 2
with the optimizer step carried over; ``--compute-map`` adds the mAP keys to
the validation pass and keeps ``yolo_best_map.pth``; the flags that are not
ported yet exit with a message before anything is built.
"""

import shutil

import pytest
import torch

from test_torch_data import make_voc_tree
from test_torch_evaluate_cli import centered_voc_tree, detecting_model
from yolo_tpu_torch import train


@pytest.fixture
def run_dir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path / "ck", ignore_errors=True)  # ~1 GB of checkpoints


def _args(root, *extra):
    return ["--data-root", str(root / "voc"), "--device", "cpu", "--image-size", "64",
            "--batch-size", "2", "--num-workers", "0", "--checkpoint-dir", str(root / "ck"),
            "--log-dir", str(root / "runs"), "--experiment-name", "cli", *extra]


def test_train_one_epoch_then_resume(run_dir, capsys):
    make_voc_tree(run_dir / "voc", n_images=4)
    # train = 2007 trainval (4) + 2012 train (3) = 7 images -> 3 steps of 2.
    train.main(_args(run_dir, "--epochs", "1"))
    ck = run_dir / "ck"
    assert sorted(p.name for p in ck.iterdir()) == ["yolo_best.pth", "yolo_latest.pth"]
    latest = torch.load(ck / "yolo_latest.pth", map_location="cpu", weights_only=True)
    assert {"epoch", "model_state_dict", "optimizer_state_dict", "scheduler_state_dict",
            "train_loss", "val_loss"} <= set(latest)
    assert latest["epoch"] == 1 and latest["scheduler_state_dict"]["last_epoch"] == 3
    assert "backbone.extractor.1.running_var" in latest["model_state_dict"]
    best = torch.load(ck / "yolo_best.pth", map_location="cpu", weights_only=True)
    assert "scheduler_state_dict" not in best and best["val_loss"] == latest["val_loss"]
    assert (run_dir / "runs" / "cli" / "metrics.jsonl").is_file()

    out = train.main(_args(run_dir, "--epochs", "2", "--resume", "true"))
    assert "Resumed from epoch 1, starting at 2 (optimizer step 3)" in capsys.readouterr().out
    latest = torch.load(ck / "yolo_latest.pth", map_location="cpu", weights_only=True)
    assert latest["epoch"] == 2 and latest["scheduler_state_dict"]["last_epoch"] == 6
    steps = {float(s["step"]) for s in latest["optimizer_state_dict"]["state"].values()}
    assert steps == {6.0}
    assert set(out) >= {"best_val_loss", "final_train_loss"}


def test_compute_map_writes_best_map_checkpoint(run_dir, capsys):
    """One epoch with ``--compute-map --map-frequency 1`` at 64x64, resumed
    from a full-depth model that detects the tree's centred dogs (fc2
    weights zero, its bias a dog box in the middle cell; Adam at lr 0, so
    the steps leave the weights as they are): the validation pass prints
    the mAP keys, and mAP50:95 > 0 writes ``yolo_best_map.pth``."""
    from yolo_tpu_torch.training.checkpoints import save_checkpoint
    from yolo_tpu_torch.training.optim import make_optimizer

    centered_voc_tree(run_dir / "voc", n_images=4)
    model = detecting_model(stage_sizes=(3, 4, 6, 3), image_size=64)
    optimizer, schedule = make_optimizer(model, lr=0.0)
    start = run_dir / "start.pth"
    save_checkpoint(start, 0, model, optimizer, schedule, {"total": 0.0}, {"total": 1e9})
    del model, optimizer, schedule
    out = train.main(_args(run_dir, "--epochs", "1", "--resume", str(start), "--compute-map",
                           "--map-frequency", "1"))
    printed = capsys.readouterr().out
    assert "Computing mAP metrics" in printed and "mAP@0.5:0.95" in printed
    ck = run_dir / "ck"
    assert sorted(p.name for p in ck.iterdir()) == ["yolo_best.pth", "yolo_best_map.pth",
                                                    "yolo_latest.pth"]
    best = torch.load(ck / "yolo_best_map.pth", map_location="cpu", weights_only=True)
    assert best["epoch"] == 1 and best["mAP50:95"] > 0 and best["mAP50"] == pytest.approx(
        1 / 20, abs=1e-6)
    assert out["best_mAP50:95"] == best["mAP50:95"]
    start.unlink()


@pytest.mark.parametrize("flags", [
    ["--mesh-data", "2"], ["--mesh-model", "2"], ["--remote"], ["--orbax-checkpoints"],
    ["--resume", "orbax"], ["--download-data"],
])
def test_unported_flags_exit_with_a_message(tmp_path, flags):
    with pytest.raises(SystemExit) as exc:
        train.main(["--data-root", str(tmp_path), "--device", "cpu", *flags])
    assert "not yet ported" in str(exc.value) or "needs a network" in str(exc.value)


def test_cuda_device_is_required_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--data-root", str(tmp_path)])
