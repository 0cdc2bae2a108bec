"""The trace reader on a made-up Chrome trace: busy time, idle gaps, their
labels by the host's CUDA call open at the time, and the window's edges."""

import json

import pytest

from portbench import trace

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "void k1<1>(int)", "ts": 100.0, "dur": 50.0},
    {"ph": "X", "cat": "kernel", "name": "void k2(float)", "ts": 140.0, "dur": 20.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 200.0,
     "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "void k1<1>(int)", "ts": 232.0, "dur": 18.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 165.0,
     "dur": 30.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 100.0, "dur": 10.0},
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 10.0},
]


class _Prof:
    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": EVENTS}, f)


def test_read_keeps_device_ops_and_cuda_calls():
    t = trace.read(_Prof(), window_s=200e-6)
    assert [op[0] for op in t.device_ops] == ["void k1<1>(int)", "void k2(float)",
                                              "Memcpy HtoD (Pinned -> Device)",
                                              "void k1<1>(int)"]
    assert [c[0] for c in t.host_calls] == ["cudaStreamSynchronize"]
    assert t.busy_s == pytest.approx(108e-6)
    assert t.gaps() == [(160.0, 200.0), (230.0, 232.0)]


def test_breakdown_labels_gaps_and_the_window_edges():
    t = trace.read(_Prof(), window_s=200e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1<1>", pytest.approx(68e-6)]
    labels = {g[0].split(":")[0]: g[1] for g in b["idle_gaps"]}
    assert labels["cudaStreamSynchronize"] == pytest.approx(40e-6)
    assert labels["short (< 5 us)"] == pytest.approx(2e-6)
    edges = [v for k, v in labels.items() if k.startswith("window edges")]
    assert edges == [pytest.approx(200e-6 - 108e-6 - 42e-6)]
