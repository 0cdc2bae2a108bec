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
        "import yolo_tpu_torch.serving, yolo_tpu_torch.utils.tracing\n"
        "import yolo_tpu_torch.serving.cuda_stem, yolo_tpu_torch.serving.cuda_int8\n"
        "import yolo_tpu_torch.serving.engine, yolo_tpu_torch.serving.export\n"
        "import yolo_tpu_torch.serving.fold, yolo_tpu_torch.serving.quant\n"
        "import yolo_tpu_torch.serving.cuda_bottleneck\n"
        "import yolo_tpu_torch.utils.timing, yolo_tpu_torch.serving.winograd\n"
        "import yolo_tpu_torch.serving.cuda_wino, yolo_tpu_torch.experiments.wino_ablate\n"
        "import yolo_tpu_torch.experiments.opt_update_microbench\n"
        "import yolo_tpu_torch.experiments.mosaic_int8_dot\n"
        "import yolo_tpu_torch.experiments.conv_bn_fuse_bench\n"
        "import yolo_tpu_torch.experiments.fused_block_pallas\n"
        "import yolo_tpu_torch.ops.matching, yolo_tpu_torch.metrics, yolo_tpu_torch.evaluate\n"
        "import yolo_tpu_torch.overfit_check, yolo_tpu_torch.quant_accuracy\n"
        "import yolo_tpu_torch.serve\n"
        "import yolo_tpu_torch.serving.graphs, yolo_tpu_torch.serving.batcher\n"
        "import yolo_tpu_torch.serving.server\n"
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


# Names of the JAX root's __all__ that the port has not ported yet: none.
NOT_YET_PORTED = set()


def _jax_all(init: Path) -> list:
    """A JAX package's ``__all__``, read from the source (importing it imports jax)."""
    tree = ast.parse(init.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(target, "id", None) == "__all__" for target in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{init} has no __all__")


def _jax_root_all() -> list:
    return _jax_all(REPO / "yolo_tpu" / "__init__.py")


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


# Names of the JAX subpackages' __all__ that the port does not export, each
# with the reason.
NOT_PORTED = {
    "ops": {"pallas_nms": "ops.nms runs csrc/nms.cu"},
    "models": {"init_model": "flax init; create_model initializes"},
    "training": {"TrainState": "flax's state pytree; the Trainer holds the module and "
                               "optimizer"},
    "parallel": {name: "NamedSharding helpers; DDP and DeviceMesh replace them"
                 for name in ("batch_sharding", "param_shardings", "put_sharded",
                              "replicated", "state_shardings")},
}
SUBPACKAGES = ("training", "utils", "ops", "serving", "models", "parallel")


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_subpackage_exports_every_ported_jax_name(package):
    """``yolo_tpu_torch.<package>`` exports its JAX counterpart's ``__all__``
    but for the names in NOT_PORTED, which it does not export."""
    import importlib

    names = _jax_all(REPO / "yolo_tpu" / package / "__init__.py")
    skipped = NOT_PORTED.get(package, {})
    assert set(skipped) <= set(names), sorted(set(skipped) - set(names))
    port = importlib.import_module(f"yolo_tpu_torch.{package}")
    ported = [n for n in names if n not in skipped]
    assert [n for n in ported if n not in port.__all__] == []
    assert [n for n in ported if getattr(port, n, None) is None] == []
    assert sorted(set(port.__all__) & set(skipped)) == []


def test_lazy_subpackages_import_nothing():
    proc = _run(
        "import sys, yolo_tpu_torch.training, yolo_tpu_torch.utils\n"
        "print(sorted(m for m in ('PIL', 'matplotlib', 'torch', 'triton', 'jax')"
        " if m in sys.modules))\n"
        "from yolo_tpu_torch.training import Trainer\n"
        "from yolo_tpu_torch.utils import extract_objectness_scores\n"
        "print(Trainer.__module__, extract_objectness_scores.__module__,"
        " 'matplotlib' in sys.modules)\n"
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split("\n")[:2] == [
        "[]", "yolo_tpu_torch.training.trainer yolo_tpu_torch.utils.visualization False"]


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
        "adam_update.cu", "bf16_bottleneck.cu", "bf16_conv_stats.cu", "dyn_quant.cu", "fused_bn.cu",
        "int8_bottleneck.cu", "int8_conv.cu", "int8_wino.cu", "max_pool_int8.cu", "nms.cu",
        "quant_s2d.cu", "bf16_common.cuh", "int8_common.cuh", "sm90_bottleneck_tile.cuh",
        "sm90_conv_core.cuh"]
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert kernels.library_path().parent.parent == kernels.BUILD_ROOT
