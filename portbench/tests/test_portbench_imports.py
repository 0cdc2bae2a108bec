"""No run loads JAX or the JAX package; the references load nothing of the program."""

import ast
import subprocess
import sys

from portbench import harness

CHILD = """
import sys, json
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests import tiny
for name in {cells!r}:
    tiny.execute(name, seconds=0.2)
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def test_a_harness_run_loads_nothing_of_jax():
    cells = ["r50-int8-offline-b256", "yolov1-dyn8-offline-b64", "r50-train-bf16-b64"]
    out = subprocess.run([sys.executable, "-c", CHILD.format(root=str(harness.ROOT),
                                                             cells=cells)],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "yolo_tpu_torch" in tops and "torch" in tops
    assert not tops.intersection(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("yolo_tpu_torch_lookalike", sys)
    try:
        assert "yolo_tpu" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("yolo_tpu_torch_lookalike", None)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_import_nothing_of_the_program_or_jax():
    files = sorted((harness.HERE / "references").glob("*.py"))
    assert len(files) >= 3
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("yolo_tpu_torch", *harness.FORBIDDEN), (f.name, mod)
            assert top in ("torch", "numpy", "portbench", "math", "typing", "contextlib",
                           "__future__"), (f.name, mod)
            if top == "portbench":
                assert mod.startswith("portbench.references"), (f.name, mod)


def test_no_file_of_the_benchmark_imports_jax():
    for f in harness.HERE.rglob("*.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (f, mod)


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "r50-int8-offline-b256", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
