"""The span reader of ``yolo_tpu_torch/experiments/span_shares.py``, on made-up traces.

Its run of a cell needs the card; what it computes from a trace and the
tracer's spans does not: the trace's parse, the clock's offsets at the
window's two edges, the six readings (sampled replays counted by their
weight, spans outside the window left out, the set-up as a union), the
device time of kernels launched inside mapped spans, and the idle gaps
labelled by the innermost program span.
"""

import pytest

from portbench import trace
from yolo_tpu_torch.experiments import span_shares
from yolo_tpu_torch.utils.tracing import Span

OPEN, CLOSE = 1_000_000_000, 2_000_000_000  # perf_counter_ns: a 1-s window
OFFSET_US = 5_000.0  # trace clock = host us + OFFSET_US


def _span(name, start_ns, end_ns, device_ms=None, replayed=False, weight=1, ident=0,
          parent=None):
    return Span(name, ident, parent, 1, start_ns, end_ns, device_ms, replayed, weight)


def _at(ns):
    """A host time in ns on the trace's clock, in us."""
    return ns / 1e3 + OFFSET_US


def test_parse_events_keeps_device_ops_and_cuda_calls_with_correlations():
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1, "dur": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 3, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 2, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 4},
        {"ph": "X", "cat": "kernel", "name": "no duration", "ts": 4},
    ]
    device, host = span_shares.parse_events(events)
    assert device == [("k", "kernel", 10.0, 15.0, 7), ("Memcpy HtoD", "gpu_memcpy", 1.0, 3.0, None)]
    assert host == [("cuLaunchKernel", 3.0, 4.0, None), ("cudaLaunchKernel", 9.0, 10.0, 7)]


def test_clock_anchors_on_the_second_synchronize_and_the_closing_one():
    host = [(span_shares.SYNC, 0.0, _at(OPEN) - 1_800.0, None),  # stamped early
            (span_shares.SYNC, 0.0, _at(OPEN), None),
            ("cudaLaunchKernel", _at(OPEN) + 5, _at(OPEN) + 6, 1),
            (span_shares.SYNC, 0.0, _at(CLOSE) + 0.75, None),
            (span_shares.SYNC, 0.0, _at(CLOSE) + 900.0, None)]  # the profiler's stop
    clk = span_shares.clock(host, OPEN, CLOSE)
    assert clk["offset_open_us"] == pytest.approx(OFFSET_US)
    assert clk["offset_close_us"] == pytest.approx(OFFSET_US + 0.75)
    assert clk["diff_us"] == pytest.approx(0.75)
    with pytest.raises(ValueError):
        span_shares.clock(host[:2], OPEN, CLOSE)


def test_shares_weigh_read_replays_and_keep_to_the_window():
    ms = 1_000_000
    spans = [
        _span("kernels.load", 0, 100 * ms),
        _span("engine.build", 50 * ms, 300 * ms),
        _span("graphs.capture", 400 * ms, 500 * ms),
        _span("graphs.capture", OPEN + 10 * ms, OPEN + 20 * ms),  # inside the window
        _span("train.input", OPEN, OPEN + ms, device_ms=10.0),
        _span("train.forward", OPEN + ms, OPEN + 2 * ms, device_ms=290.0),
        _span("train.backward", OPEN + 2 * ms, OPEN + 3 * ms, device_ms=500.0),
        _span("train.clip", OPEN + 3 * ms, OPEN + 4 * ms, device_ms=20.0),
        _span("train.optimizer", OPEN + 4 * ms, OPEN + 5 * ms, device_ms=None),  # unread
        _span("train.optimizer", CLOSE, CLOSE + ms, device_ms=999.0),  # after the window
        _span("engine.max_pool", OPEN + 6 * ms, OPEN + 7 * ms, device_ms=2.5, replayed=True,
              weight=8),
        _span("engine.max_pool", OPEN - ms, OPEN, device_ms=99.0, replayed=True, weight=8),
    ]
    got = span_shares.shares(spans, OPEN, CLOSE)
    assert got["forward_share.train"] == pytest.approx(30.0)
    assert got["backward_share.train"] == pytest.approx(50.0)
    assert got["optimizer_share.train"] == pytest.approx(2.0)
    assert got["max_pool_share.offline"] == pytest.approx(2.0)
    assert got["quantize_share.offline"] is None
    assert got["program_setup_s.offline"] == pytest.approx(0.4)
    assert span_shares.shares([], OPEN, CLOSE)["program_setup_s.offline"] is None


def test_launched_in_counts_the_kernels_of_calls_inside_mapped_spans():
    ms = 1_000_000
    spans = [_span("train.clip", OPEN, OPEN + ms),
             _span("train.optimizer", OPEN + ms, OPEN + 3 * ms),
             _span("train.fake", OPEN + 3 * ms, OPEN + 4 * ms, replayed=True)]
    host = [("cudaLaunchKernel", _at(OPEN) + 10, _at(OPEN) + 12, 1),
            ("cudaLaunchKernel", _at(OPEN + ms) + 10, _at(OPEN + ms) + 12, 2),
            ("cudaLaunchKernel", _at(OPEN + 2 * ms), _at(OPEN + 2 * ms) + 2, 3),
            ("cudaLaunchKernel", _at(OPEN + 3 * ms) + 10, _at(OPEN + 3 * ms) + 12, 4),
            ("cudaMemcpyAsync", _at(OPEN + 5 * ms), _at(OPEN + 5 * ms) + 2, 5)]
    device = [("a", "kernel", 0.0, 1_000.0, 1), ("b", "kernel", 0.0, 3_000.0, 2),
              ("c", "kernel", 0.0, 6_000.0, 3), ("d", "kernel", 0.0, 50_000.0, 4),
              ("e", "gpu_memcpy", 0.0, 70_000.0, 5), ("f", "kernel", 0.0, 5.0, None)]
    got = span_shares.launched_in(spans, device, host, OFFSET_US, window_s=1.0)
    assert got == pytest.approx({"train.clip": 0.1, "train.optimizer": 0.9})


def test_innermost_names_the_deepest_open_host_span():
    spans = [_span("graphs.replay", 100, 200),
             _span("engine.max_pool", 100, 200, device_ms=1.0, replayed=True),
             _span("batcher.predict", 50, 300),
             _span("batcher.stack", 10, 40)]
    label = span_shares.innermost(spans)
    assert label(150) == "graphs.replay"
    assert label(250) == "batcher.predict"
    assert label(20) == "batcher.stack"
    assert label(45) == label(400) == span_shares.OUTSIDE


def test_gap_labels_name_the_program_span_and_the_cuda_call():
    # Device busy [0, 100) us, [102, 200) us, [300, 400) us, [1000, 1100) us.
    ops = [("k", "kernel", s, e) for s, e in ((0, 100), (102, 200), (300, 400), (1000, 1100))]
    calls = [("cudaMemcpyAsync", 240.0, 260.0), ("cudaGraphLaunch", 700.0, 800.0)]
    data = trace.TraceData(window_s=0.0011, device_ops=ops, host_calls=calls)
    offset = -OPEN / 1e3  # the host's OPEN is the trace's 0
    spans = [_span("graphs.copy_in", OPEN + 200_000, OPEN + 280_000),
             _span("graphs.replay", OPEN + 600_000, OPEN + 900_000)]
    got = span_shares.gap_labels(data, spans, offset)
    assert got == [
        ["graphs.replay / cudaGraphLaunch: 1 gaps, longest 0.6000 ms", pytest.approx(6e-4)],
        ["graphs.copy_in / cudaMemcpyAsync: 1 gaps, longest 0.1000 ms", pytest.approx(1e-4)],
        ["short (< 5 us): 1 gaps, longest 0.0020 ms", pytest.approx(2e-6)],
    ]
    outside = span_shares.gap_labels(data, [], offset)
    assert outside[0][0] == f"{span_shares.OUTSIDE} / cudaGraphLaunch: 1 gaps, longest 0.6000 ms"
