"""On the card: one short run of each cell through the command, correct,
with its end-to-end metrics; skips without a CUDA device."""

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 and NMS kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", str(2 ** 31 + 7), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and "setup_s" in line["metrics"]
