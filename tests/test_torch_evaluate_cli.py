"""``python -m yolo_tpu_torch.evaluate`` and the evaluator's tools on the CPU.

The CLI runs on a synthetic VOC tree whose images each hold one dog in the
middle, with a small ResNet checkpoint (stages (1, 1, 1, 1) at 64x64) whose
fc2 weights are zero and whose fc2 bias puts a dog box of the same size in
the middle cell: the grid is the bias whatever the image, so the model
detects every dog and the report is not all zeros. The CLI's keys must
equal an in-process ``evaluate_model`` on the same data, on both paths;
the int8 engine (calibrated on ``--calib-data``, or loaded with
``--engine``) must give the same keys, since fc2 ignores its input. Then
the refusals, and ``overfit_check``, ``quant_accuracy`` and ``bench_eval``
at a tiny size with ``--device cpu``.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_data import OBJ, XML
from yolo_tpu_torch import bench_eval, evaluate, overfit_check, quant_accuracy
from yolo_tpu_torch.data import VOC_CLASSES, DataLoader, create_voc_datasets
from yolo_tpu_torch.metrics import evaluate_model
from yolo_tpu_torch.models import create_model

STAGES, SIZE = (1, 1, 1, 1), 64
DOG = VOC_CLASSES.index("dog")
BOX = 0.3  # the dog's width and height, a fraction of the image


def centered_voc_tree(root: Path, n_images: int = 5, seed: int = 0) -> Path:
    """VOC2007 and VOC2012 trees whose every image holds one dog of side BOX
    at its centre; splits trainval (all), train (the first n // 2 + 1), val
    (the rest) and test (all)."""
    r = np.random.default_rng(seed)
    for year in ("2007", "2012"):
        voc = root / "VOCdevkit" / f"VOC{year}"
        for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
            (voc / sub).mkdir(parents=True, exist_ok=True)
        ids = [f"{year}_{k:06d}" for k in range(n_images)]
        for img_id in ids:
            w, h = 200, 160
            Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                voc / "JPEGImages" / f"{img_id}.jpg")
            obj = OBJ.format(name="dog", x0=int(w * (0.5 - BOX / 2)), y0=int(h * (0.5 - BOX / 2)),
                             x1=int(w * (0.5 + BOX / 2)), y1=int(h * (0.5 + BOX / 2)))
            (voc / "Annotations" / f"{img_id}.xml").write_text(XML.format(w=w, h=h, objects=obj))
        main = voc / "ImageSets" / "Main"
        for split, part in (("trainval", ids), ("test", ids),
                            ("train", ids[: n_images // 2 + 1]),
                            ("val", ids[n_images // 2 + 1:])):
            (main / f"{split}.txt").write_text("\n".join(part) + "\n")
    return root


def detecting_model(stage_sizes=STAGES, image_size=SIZE):
    """A seeded port model whose grid is its fc2 bias: a dog box of side BOX
    with confidence 1 in both slots of the middle cell, nothing elsewhere."""
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=stage_sizes,
                         image_size=image_size, generator=torch.Generator().manual_seed(0))
    fc2 = model.head.fc_layers[4]
    bias = torch.zeros(7, 7, 30)
    bias[3, 3, 0:10] = torch.tensor([0.5, 0.5, BOX, BOX, 1.0] * 2)
    bias[3, 3, 10 + DOG] = 1.0
    with torch.no_grad():
        fc2.weight.zero_()
        fc2.bias.copy_(bias.reshape(-1))
    return model


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    centered_voc_tree(root / "voc")
    ckpt = root / "ck" / "yolo_detecting.pth"
    ckpt.parent.mkdir()
    model = detecting_model()
    torch.save({"epoch": 3, "model_state_dict": model.state_dict()}, ckpt)
    yield root, ckpt, model
    shutil.rmtree(root, ignore_errors=True)  # the checkpoint and engine are ~300 MB


def _cli(root, ckpt, *extra):
    return evaluate.main(["--checkpoint", str(ckpt), "--data-root", str(root / "voc"),
                          "--device", "cpu", "--batch-size", "2", "--num-workers", "0",
                          *extra])


def _in_process(root, model, precise):
    dataset = create_voc_datasets([("2007", "test")], root=root / "voc",
                                  target_size=(SIZE, SIZE), augment=False, normalize_host=False)
    loader = DataLoader(dataset, batch_size=2, shuffle=False, num_workers=0, drop_last=False)
    return evaluate_model(model, loader, verbose=False, device="cpu", precise=precise)


@pytest.mark.parametrize("fast", [False, True], ids=["precise", "fast"])
def test_fp32_report_matches_evaluate_model(setup, fast, capsys):
    root, ckpt, model = setup
    got = _cli(root, ckpt, *(["--fast-eval"] if fast else []))
    out = capsys.readouterr().out
    assert "Evaluation dataset: 5 images" in out and "epoch: 3" in out
    assert ("Precise eval path active" in out) != fast
    report = (ckpt.parent / "evaluation_results.txt").read_text()
    assert "Overall metrics" in report and "dog" in report
    assert len(got) == 77 and got == _in_process(root, model, precise=not fast)
    assert got[f"AP50_class_{DOG}"] == pytest.approx(1.0, abs=1e-6) and got["recall"] > 0.99
    assert got["num_large_objects"] == 5


def test_int8_calibrated_on_calib_data_then_engine_artifact(setup, capsys):
    from yolo_tpu_torch.inference import YOLOInference

    root, ckpt, model = setup
    fp32 = _cli(root, ckpt)
    int8 = _cli(root, ckpt, "--int8", "--calib-data", "2012:train")
    assert "calibrated on 3 images of --calib-data 2012:train" in capsys.readouterr().out
    assert int8 == fp32
    artifact = ckpt.parent / "engine.npz"
    calib = [np.random.default_rng(1).normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)]
    YOLOInference(model, "cpu", image_size=SIZE, optimize="int8",
                  calibration=calib).save_engine(artifact)
    assert _cli(root, ckpt, "--engine", str(artifact)) == fp32


@pytest.mark.parametrize("flags, message", [
    (["--int8"], "--calib-data"),
    (["--download-data"], "needs a network"),
])
def test_refusals_exit_with_a_message(tmp_path, flags, message):
    with pytest.raises(SystemExit) as exc:
        evaluate.main(["--checkpoint", str(tmp_path / "none.pth"), "--device", "cpu", *flags])
    assert message in str(exc.value)


def test_cuda_device_is_required_by_default(setup, monkeypatch):
    root, ckpt, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        evaluate.main(["--checkpoint", str(ckpt), "--data-root", str(root / "voc")])


@pytest.mark.parametrize("tool, argv, verdict", [
    (overfit_check, ["--steps", "2", "--batch", "2", "--size", "64", "--log-every", "1"],
     "CONVERGENCE:"),
    (quant_accuracy, ["--steps", "2", "--batch", "2", "--size", "64", "--chain",
                      "--wino", "head_conv1"], "QUANT ACCURACY:"),
], ids=["overfit_check", "quant_accuracy"])
def test_gates_run_on_the_cpu(tool, argv, verdict, capsys):
    """Two steps cannot converge: the gates run end to end and say FAIL."""
    assert tool.main([*argv, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"{verdict} FAIL" in out and "mAP50" in out


@pytest.mark.parametrize("flags", [[], ["--precise", "--int8"]], ids=["fast", "precise-int8"])
def test_bench_eval_runs_on_the_cpu(flags, capsys):
    out = bench_eval.main(["--device", "cpu", "--batch", "2", "--batches", "2",
                           "--image-size", "64", *flags])
    assert out["img_s"] > 0 and out["compute_s"] >= 0 and out["idle"] is None
    assert "img/s" in capsys.readouterr().out
