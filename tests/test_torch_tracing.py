"""The port's tracer (``yolo_tpu_torch/utils/tracing.py``) and its spans, on the CPU.

Off by default: ``span`` returns one shared no-op object and records
nothing, and no CUDA event is made. On: names, parents and per-thread
stacks, ``take`` emptying the buffer, the bound and the dropped count,
explicit-time spans, lazy and never-waited reads of device events (with
stand-in events), captured spans collected and read per replay, each
standing for ``READ_EVERY`` replays. Then the spans where the work happens,
on the plain twins: ``Trainer.train_step``'s five phases (losses and
parameters bit for bit the same with tracing on and off), the int8 engine's
``engine.build`` and ``engine.max_pool``, ``Int8Conv2d``'s quantize pass,
the batcher's spans and fill counter (which counts with tracing off too),
the kernels' launch seam (``kernels.launch`` against a stand-in library, and
``kernels.SIGNATURES`` against the C entry points of ``csrc/*.cu``), and
``GraphedPredict``'s counts and its traced graph,
replayed one call in ``READ_EVERY`` while the tracer is on (with a stand-in
graph).
"""

import contextlib
import copy
import ctypes
import re
import subprocess
import sys
import threading
from collections import Counter, namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_tpu_torch.data.transforms import device_normalize
from yolo_tpu_torch.models import create_model
from yolo_tpu_torch.models.layers import Int8Conv2d
from yolo_tpu_torch.serving.batcher import RequestBatcher
from yolo_tpu_torch.serving.engine import build_int8_predict
from yolo_tpu_torch.training.optim import make_optimizer
from yolo_tpu_torch.training.trainer import Trainer
from yolo_tpu_torch.utils import kernels, tracing

REPO = Path(__file__).resolve().parents[1]
STAGES, SIZE = (1, 1, 1, 1), 64
TRAIN_SPANS = ["train.input", "train.forward", "train.backward", "train.clip",
               "train.optimizer"]


@pytest.fixture
def tracer():
    """The tracer on, and off and emptied afterwards, whatever the test did."""
    tracing.take()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.take()


def _names(taken):
    return [s.name for s in taken.spans]


class FakeEvent:
    """A stand-in CUDA timing event: ``record`` stamps a time, ``query`` says
    whether the device got there; waiting for it fails the test."""

    made = []
    clock = 0.0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        self.external, self.t, self.done = external, None, True
        FakeEvent.made.append(self)

    def record(self, stream=None):
        FakeEvent.clock += 1.0
        self.t = FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t

    def synchronize(self):
        raise AssertionError("the tracer waited for the device")


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA initialized, with stand-in events; ``state["capturing"]`` says
    whether the current stream is under capture."""
    state = {"capturing": False}
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return state


# ---------------------------------------------------------------- off
def test_off_by_default_in_a_fresh_process():
    code = ("from yolo_tpu_torch.utils import tracing\n"
            "assert not tracing.enabled()\n"
            "assert tracing.span('a') is tracing.span('b') is tracing.NO_SPAN\n"
            "with tracing.span('a') as s:\n"
            "    assert s is None\n"
            "t = tracing.take()\n"
            "assert t.spans == [] and t.dropped == 0 and t.unread == 0\n"
            "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-2000:]


def test_off_records_nothing_and_makes_no_cuda_event(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made with the tracer off")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    tracing.disable()
    tracing.take()
    for name in ("a", "b"):
        with tracing.span(name) as s:
            assert s is None
    tracing.record("batcher.wait", 1, 2)
    assert tracing.replayed([object()], None) == []
    taken = tracing.take()
    assert taken.spans == [] and taken.dropped == 0 and taken.unread == 0


# ---------------------------------------------------------------- on
def test_spans_nest_with_parents_in_end_order(tracer):
    with tracing.span("outer") as outer:
        with tracing.span("inner") as inner:
            pass
        with tracing.span("second"):
            pass
    with tracing.span("after"):
        pass
    spans = {s.name: s for s in tracing.take().spans}
    assert list(spans) == ["inner", "second", "outer", "after"]
    assert spans["outer"].parent is None and spans["after"].parent is None
    assert spans["inner"].parent == spans["second"].parent == outer.id
    assert inner.id == spans["inner"].id
    o, i = spans["outer"], spans["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= spans["second"].start_ns <= o.end_ns
    assert all(s.device_ms is None and not s.replayed and s.weight == 1
               for s in spans.values())


def test_each_thread_has_its_own_stack(tracer):
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(f"{tag}.outer"):
            barrier.wait()  # both outer spans are open at once
            with tracing.span(f"{tag}.inner"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in tracing.take().spans}
    for tag in "ab":
        inner, outer = spans[f"{tag}.inner"], spans[f"{tag}.outer"]
        assert inner.parent == outer.id and outer.parent is None
        assert inner.thread == outer.thread
    assert spans["a.outer"].thread != spans["b.outer"].thread


def test_take_empties_the_buffer(tracer):
    with tracing.span("one"):
        pass
    assert _names(tracing.take()) == ["one"]
    assert tracing.take().spans == []
    tracing.disable()
    with tracing.span("off"):
        pass
    assert tracing.take().spans == []


def test_the_bound_counts_the_rest_as_dropped(tracer, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    for k in range(5):
        with tracing.span(f"s{k}"):
            pass
    tracing.record("late", 1, 2)
    taken = tracing.take()
    assert _names(taken) == ["s0", "s1", "s2"] and taken.dropped == 3
    with tracing.span("next"):
        pass
    taken = tracing.take()
    assert _names(taken) == ["next"] and taken.dropped == 0


def test_record_takes_explicit_times_across_threads(tracer):
    with tracing.span("open"):
        tracing.record("batcher.wait", 100, 250)
    wait = tracing.take().spans[0]
    assert (wait.name, wait.start_ns, wait.end_ns, wait.parent) == ("batcher.wait", 100, 250,
                                                                    None)


def test_eager_events_are_read_in_take_and_never_waited_for(tracer, fake_cuda):
    with tracing.span("done"):
        pass
    with tracing.span("running"):
        pass
    FakeEvent.made[-1].done = False
    with tracing.span("host only", device=False):
        pass
    assert len(FakeEvent.made) == 4 and not any(e.external for e in FakeEvent.made)
    taken = tracing.take()
    done, running, host = taken.spans
    assert host.name == "host only" and host.device_ms is None
    a, b = FakeEvent.made[:2]
    assert done.device_ms == b.t - a.t and done.device_ms > 0
    assert running.device_ms is None and taken.unread == 1


def test_captured_spans_are_collected_and_read_per_replay(tracer, fake_cuda):
    fake_cuda["capturing"] = True
    with tracing.collecting() as captured:
        with tracing.span("graphed.outer"):
            with tracing.span("graphed.inner"):
                pass
    fake_cuda["capturing"] = False
    assert [r.name for r in captured] == ["graphed.inner", "graphed.outer"]
    assert all(e.external for e in FakeEvent.made)
    assert tracing.take().spans == []  # held by the collector, not the buffer

    for k in range(2):
        with tracing.span("graphs.replay") as replay:
            # The replay records the graph's event nodes again, in capture
            # order: outer start, inner start, inner end, outer end.
            for i in (0, 2, 3, 1):
                FakeEvent.made[i].record()
        pending = tracing.replayed(captured, replay)
        if k == 0:
            FakeEvent.made[1].done = False  # the outer span's end is not there yet
            tracing.settle(pending, force=False)
            assert len(pending) == 2  # left for a later read
            tracing.settle(pending)  # the graph is about to be replayed again
            FakeEvent.made[1].done = True
    taken = tracing.take()
    first, second = taken.spans[1:3], taken.spans[4:6]
    assert _names(taken) == ["graphs.replay", "graphed.inner", "graphed.outer"] * 2
    assert taken.unread == 1 and first[1].device_ms is None
    for (inner, outer), replay in ((first, taken.spans[0]), (second, taken.spans[3])):
        assert inner.replayed and outer.replayed
        assert inner.weight == outer.weight == tracing.READ_EVERY
        assert outer.parent == replay.id and inner.parent == outer.id
        assert (inner.start_ns, inner.end_ns) == (replay.start_ns, replay.end_ns)
    assert first[0].device_ms is not None and second[1].device_ms > second[0].device_ms > 0


def test_a_captured_span_outside_a_collector_makes_no_event(tracer, fake_cuda):
    fake_cuda["capturing"] = True
    with tracing.span("captured elsewhere") as s:
        assert s is None
    assert FakeEvent.made == [] and tracing.take().spans == []


# ---------------------------------------------------------------- where the work happens
def _batch(seed, n=2):
    r = np.random.default_rng(seed)
    images = r.integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)
    targets = np.zeros((n, 7, 7, 30), np.float32)
    targets[:, 3, 3, :5] = (0.5, 0.5, 0.3, 0.4, 1.0)
    targets[:, 3, 3, 10 + 11] = 1.0
    return images, targets


def _trainer(model):
    optimizer, schedule = make_optimizer(model, lr=1e-3)
    return Trainer(model, optimizer, schedule, device="cpu", clip_norm=1.0)


def test_train_step_records_its_five_phases_and_changes_nothing(tracer):
    torch.manual_seed(0)
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES, image_size=SIZE)
    twin = copy.deepcopy(model)
    traced, plain = _trainer(model), _trainer(twin)
    for seed in (1, 2):
        batch = _batch(seed)
        tracing.enable()
        got = traced.train_step(*batch)
        tracing.disable()
        want = plain.train_step(*batch)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), name
    spans = tracing.take().spans
    assert [s.name for s in spans] == TRAIN_SPANS * 2
    assert all(s.parent is None for s in spans)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))

    tracing.enable()
    traced.eval_step(*_batch(3))
    assert tracing.take().spans == []


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES, image_size=SIZE)
    images = torch.from_numpy(_batch(4)[0])
    tracing.take()
    tracing.enable()
    try:
        fn, q = build_int8_predict(model, [device_normalize(images)])
    finally:
        tracing.disable()
    return fn, q, tracing.take()


def test_int8_build_records_engine_build(engine):
    build = engine[2].spans
    assert [s.name for s in build if s.parent is None] == ["engine.build"]
    assert build[-1].end_ns - build[-1].start_ns > 0


def test_int8_engine_records_its_max_pool_and_changes_nothing(engine, tracer):
    fn, q, _ = engine
    images = torch.from_numpy(_batch(5)[0])
    got = fn(q, images, 0.0, 0.4)
    tracing.disable()
    want = fn(q, images, 0.0, 0.4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _names(tracing.take()) == ["engine.max_pool"]


def test_int8conv_records_one_quantize_a_conv_and_changes_nothing(tracer):
    torch.manual_seed(0)
    model = create_model("resnet", 20, 7, 2, device="cpu", stage_sizes=STAGES,
                         image_size=SIZE, quantized=True).eval()
    n_convs = sum(isinstance(m, Int8Conv2d) for m in model.modules())
    x = device_normalize(torch.from_numpy(_batch(6)[0])).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(x)
        tracing.disable()
        want = model(x)
    assert torch.equal(got, want)
    assert n_convs > 0 and _names(tracing.take()) == ["int8conv.quantize"] * n_convs


Out = namedtuple("Out", "total first")


def _sums(images):
    x = torch.as_tensor(images).float()
    return Out(x.sum(dim=(1, 2, 3)), x[:, 0, 0, 0])


def test_batcher_records_its_spans_and_bucket_fill(tracer):
    images = np.random.default_rng(7).uniform(size=(5, 4, 4, 3)).astype(np.float32)
    with RequestBatcher(_sums, (4, 4, 3), buckets=(1, 4, 8), max_delay_ms=200.0) as b:
        futures = [b.submit(im) for im in images]
        results = [f.result(timeout=30) for f in futures]
    for im, r in zip(images, results):
        want = _sums(im[None])
        assert r.total == want.total[0].item() and r.first == want.first[0].item()
    assert b.images_served == 5
    assert b.slots_dispatched == sum(k * n for k, n in b.bucket_batches.items())
    assert b.slots_dispatched >= b.images_served
    spans = tracing.take().spans
    waits = [s for s in spans if s.name == "batcher.wait"]
    assert len(waits) == 5 and all(s.end_ns >= s.start_ns for s in waits)
    for name in ("batcher.stack", "batcher.predict", "batcher.copy_out", "batcher.fan_out"):
        assert sum(s.name == name for s in spans) == b.batches_dispatched, name
    per_batch = [s.name for s in spans if s.name != "batcher.wait"]
    assert per_batch[:4] == ["batcher.stack", "batcher.predict", "batcher.copy_out",
                             "batcher.fan_out"]


def test_the_batcher_counts_its_fill_with_tracing_off():
    tracing.disable()
    tracing.take()
    images = np.random.default_rng(8).uniform(size=(6, 4, 4, 3)).astype(np.float32)
    with RequestBatcher(_sums, (4, 4, 3), buckets=(4, 8), max_delay_ms=200.0) as b:
        for f in [b.submit(im) for im in images]:
            f.result(timeout=30)
    assert b.images_served == 6 and b.batches_dispatched == sum(b.bucket_batches.values())
    assert b.slots_dispatched == sum(k * n for k, n in b.bucket_batches.items()) >= 6
    assert tracing.take().spans == []


class FakeLibrary:
    """A stand-in for the kernels' library: every entry point records its
    arguments and returns ``code``."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def yolo_cuda_error_string(self, code):
        return b"stand-in error"

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.code

        return entry


@pytest.fixture
def seam(monkeypatch):
    """``kernels.launch`` on a stand-in library, with current device 0, a
    raw stream of 1000 + the device's index, a fresh ``LAUNCHES`` and the
    device guards it enters recorded."""
    lib, guards = FakeLibrary(), []

    def guard(index):
        guards.append(index)
        return contextlib.nullcontext()

    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "LAUNCHES", Counter())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    return lib, guards


GRID = ctypes.c_int(0)
LAUNCH_CASES = {
    "pool on the current device": ("yolo_max_pool_int8", 0, (11, 22, 2, 8, 8, 16)),
    "nms on another device": ("yolo_nms_f64", 1, (1, 2, 3, 4, 5, 2, 7, 0.5, 1e-6)),
    "chain with an out-parameter": ("yolo_int8_chain", 0, (1, 2, None, 4, 5, 1, 2, 8, 8, 64,
                                                           64, 64, 8, 8, ctypes.byref(GRID))),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launch_passes_the_stream_last_and_counts_the_call(seam, case):
    lib, guards = seam
    name, index, args = LAUNCH_CASES[case]
    kernels.launch(name, torch.device("cuda", index), *args)
    assert lib.calls == [(name, (*args, 1000 + index))]  # out-parameters pass unchanged
    assert kernels.LAUNCHES == {name: 1}
    assert guards == ([] if index == 0 else [index])  # the guard only for another device


@pytest.mark.parametrize("name", ["yolo_int8_conv", "yolo_bn_stats"])
def test_launch_raises_naming_the_entry_point_and_does_not_count(seam, name):
    lib, _ = seam
    lib.code = 700
    with pytest.raises(RuntimeError, match=rf"{name} launch failed: cudaError 700"):
        kernels.launch(name, torch.device("cuda", 0), 1, 2)
    assert kernels.LAUNCHES == {}


def _c_entry_points():
    """{name: parameter count} of every ``int yolo_*(`` definition in ``csrc/*.cu``."""
    out = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for name, params in re.findall(r"^int (yolo_\w+)\(([^)]*)\)", src.read_text(), re.M):
            out[name] = params.count(",") + 1
    return out


def test_signatures_name_every_c_entry_point():
    assert set(kernels.SIGNATURES) == set(_c_entry_points())


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_signature_has_the_c_parameter_count(name):
    assert len(kernels.SIGNATURES[name]) == _c_entry_points()[name]


class FakeGraph:
    """A stand-in captured graph: a replay records its captured events again
    in the order they were recorded at capture."""

    def __init__(self, events):
        self.events = events

    def replay(self):
        for e in self.events:
            e.record()


@pytest.fixture
def graphed(monkeypatch, fake_cuda):
    """A ``GraphedPredict`` whose device is the CPU, with no warm-up and a
    stand-in capture: the callable runs under the stand-in stream capture,
    counts 2 int8 conv launches, and its graph records its events again."""
    from yolo_tpu_torch.serving import graphs

    def predict(x):
        with tracing.span("graphed.whole"):
            return x.sum(dim=(1, 2, 3))

    def graph_of(self, static_in):
        first = len(FakeEvent.made)
        fake_cuda["capturing"] = True
        try:
            static_out = predict(static_in)
            kernels.LAUNCHES["yolo_int8_conv"] += 2
        finally:
            fake_cuda["capturing"] = False
        return FakeGraph(FakeEvent.made[first:]), static_out

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs.GraphedPredict, "_warm_up", lambda self, static_in: None)
    monkeypatch.setattr(graphs.GraphedPredict, "_graph_of", graph_of)
    monkeypatch.setattr(kernels, "LAUNCHES", Counter())
    g = graphs.GraphedPredict(predict, torch.device("cuda", 0))
    g.device = torch.device("cpu")
    return g


def _graph_state(graphed, images):
    return graphed._graphs[(tuple(images.shape), images.dtype)]


def test_graphed_predict_replays_the_traced_graph_one_call_in_read_every(graphed, tracer):
    every = tracing.READ_EVERY
    images = torch.ones(2, 3, 3, 3)
    calls = 2 * every + 1
    outs = [graphed(images) for _ in range(calls)]
    g = _graph_state(graphed, images)
    # The stand-in graphs compute nothing; which static outputs each call returned:
    assert [o is g.traced_out for o in outs] == [(k + 1) % every == 0 for k in range(calls)]
    assert all(o is g.static_out for o in outs if o is not g.traced_out)
    assert g.graph.events == [] and len(g.traced.events) == 2  # nodes only in the traced graph
    assert graphed.captures == 2 and graphed.replays == calls
    assert graphed.launches() == {"yolo_int8_conv": 2 * calls}
    taken = tracing.take()
    names = _names(taken)
    assert names.count("graphs.capture") == 2
    assert names.count("graphs.copy_in") == names.count("graphs.replay") == calls
    whole = [s for s in taken.spans if s.name == "graphed.whole"]
    assert len(whole) == 2 and all(s.replayed and s.weight == every for s in whole)
    assert all(s.device_ms == 1.0 for s in whole) and taken.unread == 0


def test_graphed_predict_reads_a_traced_replay_only_once_it_has_completed(graphed, tracer):
    every = tracing.READ_EVERY
    images = torch.ones(1, 2, 2, 3)
    for _ in range(every):
        graphed(images)
    g = _graph_state(graphed, images)
    g.traced.events[-1].done = False  # the card has not reached the replay's end yet
    graphed(images)
    assert g.pending  # left for a later call, not waited for
    g.traced.events[-1].done = True
    graphed(images)
    assert g.pending == [] and tracing.take().unread == 0


def test_graphed_predict_keeps_the_traced_graph_only_while_the_tracer_is_on(graphed, tracer):
    images = torch.zeros(1, 2, 2, 3)
    graphed(images)
    g = _graph_state(graphed, images)
    plain = g.graph
    assert g.traced is not None and g.spans
    tracing.disable()
    for _ in range(tracing.READ_EVERY):
        assert graphed(images) is g.static_out
    assert g.traced is None and g.spans == [] and g.graph is plain
    tracing.enable()
    graphed(images)
    assert g.traced is not None and g.graph is plain
    assert graphed.captures == 3 and graphed.replays == tracing.READ_EVERY + 2
    assert graphed.launches() == {"yolo_int8_conv": 2 * (tracing.READ_EVERY + 2)}
