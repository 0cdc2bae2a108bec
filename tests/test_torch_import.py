"""The port imports without JAX, and its files never import JAX or yolo_tpu.

``yolo_tpu/__init__.py`` pulls in flax, optax and jax, so a port module that
imported any ``yolo_tpu.*`` would drag JAX along. Triton, where a later
kernel uses it, is imported inside the launching function only, so that the
CPU suite can import every module.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "yolo_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN_ANYWHERE = ("jax", "jaxlib", "flax", "optax", "yolo_tpu")
FORBIDDEN_AT_TOP = ("triton",)


def _run(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_with_jax_blocked():
    proc = _run(
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'yolo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import yolo_tpu_torch, yolo_tpu_torch.inference, yolo_tpu_torch.ops.cuda_nms\n"
        "import yolo_tpu_torch.predict, yolo_tpu_torch.convert, yolo_tpu_torch.models\n"
        "import yolo_tpu_torch.training.checkpoints, yolo_tpu_torch.utils.kernels\n"
        "import yolo_tpu_torch.ops.loss, yolo_tpu_torch.ops.fused_bn, yolo_tpu_torch.data\n"
        "import yolo_tpu_torch.data.loader, yolo_tpu_torch.data.transforms\n"
        "import yolo_tpu_torch.training.optim, yolo_tpu_torch.training.trainer\n"
        "import yolo_tpu_torch.training.logging, yolo_tpu_torch.train\n"
        "import yolo_tpu_torch.bench_train, yolo_tpu_torch.serving\n"
        "import yolo_tpu_torch.serving.cuda_stem, yolo_tpu_torch.serving.cuda_int8\n"
        "import yolo_tpu_torch.serving.engine, yolo_tpu_torch.serving.export\n"
        "import yolo_tpu_torch.serving.fold, yolo_tpu_torch.serving.quant\n"
        "import yolo_tpu_torch.serving.cuda_bottleneck, yolo_tpu_torch.bench_int8\n"
        "import yolo_tpu_torch.utils.timing, yolo_tpu_torch.serving.winograd\n"
        "import yolo_tpu_torch.serving.cuda_wino, yolo_tpu_torch.experiments.wino_ablate\n"
        "import yolo_tpu_torch.experiments.opt_update_microbench\n"
        "import yolo_tpu_torch.experiments.mosaic_int8_dot\n"
        "import yolo_tpu_torch.experiments.conv_bn_fuse_bench\n"
        "import yolo_tpu_torch.experiments.fused_block_pallas\n"
        "import yolo_tpu_torch.ops.matching, yolo_tpu_torch.metrics, yolo_tpu_torch.evaluate\n"
        "import yolo_tpu_torch.overfit_check, yolo_tpu_torch.quant_accuracy\n"
        "import yolo_tpu_torch.bench_eval\n"
        "assert 'triton' not in sys.modules\n"
        "assert yolo_tpu_torch.YOLOInference is yolo_tpu_torch.inference.YOLOInference\n"
        "print('OK')\n"
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-3000:]


def test_package_import_is_lazy():
    proc = _run(
        "import sys, yolo_tpu_torch\n"
        "print(sorted(m for m in ('PIL', 'pydantic', 'triton', 'torch', 'jax')"
        " if m in sys.modules))\n"
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


# Names of the JAX root's __all__ that the port has not ported yet: the
# 24-conv backbone (with its Backbone alias).
NOT_YET_PORTED = {"Backbone", "YOLOv1Backbone"}


def _jax_root_all() -> list:
    """``yolo_tpu.__all__``, read from the source (importing it imports jax)."""
    tree = ast.parse((REPO / "yolo_tpu" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(target, "id", None) == "__all__" for target in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError("yolo_tpu/__init__.py has no __all__")


def test_root_exports_every_ported_jax_root_name():
    names = sorted(set(_jax_root_all()) - NOT_YET_PORTED)
    assert {"YOLOLoss", "yolo_loss", "VOCDetectionYOLO", "CombinedVOCDataset",
            "create_voc_datasets"} <= set(names)
    proc = _run(
        "import sys\n"
        "from yolo_tpu_torch import (YOLOLoss, yolo_loss, VOCDetectionYOLO,\n"
        "                            CombinedVOCDataset, create_voc_datasets)\n"
        "import yolo_tpu_torch\n"
        f"names = {names!r}\n"
        "missing = [n for n in names if n not in yolo_tpu_torch.__all__]\n"
        "unresolved = [n for n in names if getattr(yolo_tpu_torch, n, None) is None]\n"
        f"early = sorted(set(yolo_tpu_torch.__all__) & set({sorted(NOT_YET_PORTED)!r}))\n"
        "assert YOLOLoss is yolo_tpu_torch.ops.loss.YOLOLoss\n"
        "assert yolo_tpu_torch.mAPMetric is yolo_tpu_torch.metrics.map.mAPMetric\n"
        "assert create_voc_datasets is yolo_tpu_torch.data.voc.create_voc_datasets\n"
        "print(missing, unresolved, early, 'jax' in sys.modules, 'yolo_tpu' in sys.modules)\n"
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[] [] [] False False"


def _imports(tree, top_level_only):
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports(path):
    tree = ast.parse(path.read_text())
    for name in _imports(tree, top_level_only=False):
        assert name.split(".")[0] not in FORBIDDEN_ANYWHERE, f"{path}: imports {name}"
    for name in _imports(tree, top_level_only=True):
        assert name.split(".")[0] not in FORBIDDEN_AT_TOP, f"{path}: imports {name} at top"


def test_kernel_build_flags():
    from yolo_tpu_torch.utils import kernels

    assert (PORT / "csrc" / "nms.cu").is_file()
    assert [p.name for p in kernels.sources()] == [
        "adam_update.cu", "bf16_bottleneck.cu", "bf16_conv_stats.cu", "fused_bn.cu",
        "int8_bottleneck.cu", "int8_conv.cu", "int8_wino.cu", "nms.cu",
        "quant_s2d.cu", "bf16_common.cuh", "int8_common.cuh", "sm90_bottleneck_tile.cuh",
        "sm90_conv_core.cuh"]
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert kernels.library_path().parent.parent == kernels.BUILD_ROOT
