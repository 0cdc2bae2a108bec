"""Each driver at a test size on the CPU, through the port's plain paths:
the run completes, measures its end-to-end metric and comes out correct."""

import math

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = {
    "r50-int8-offline-b256": "images_per_s",
    "yolov1-dyn8-offline-b64": "images_per_s",
    "r50-train-bf16-b64": "train_images_per_s",
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_driver_runs_and_is_correct(name):
    run = tiny.execute(name)
    assert run.setup_s is not None and run.setup_s > 0
    value = run.metrics[CELLS[name]]
    assert math.isfinite(value) and value > 0
    assert run.attempted > 0 and run.failed == 0
    assert set(run.checks) == set(run.cell["limits"])
    assert harness.is_correct(run), run.checks


def test_traced_run_reads_no_device_metric_on_the_cpu():
    run = tiny.execute("r50-int8-offline-b256", trace=True)
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    out = harness.result(run, bench)
    assert out["metrics"] == {}
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
