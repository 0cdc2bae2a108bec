"""The port's spans in one benchmark cell on the card: ``python -m yolo_tpu_torch.experiments.span_shares --workload CELL --seed N``

Runs one cell of ``portbench/`` in-process as ``python -m portbench.run
--trace 1`` does (the same driver, traffic, profiler window and check), with
the port's tracer (``utils/tracing.py``) on from before the set-up, and
prints one line ``SPANS {json}``: the run's ``correct``, end-to-end and
per-layer readings as the harness computes them, and what the benchmark
does not read yet:

- ``shares``: the eight per-layer readings the spans give. A ``%`` is the
  device time of the spans (``device_ms * weight``) that start inside the
  window, over the window's host-clock length: ``forward_share.train``
  (``train.input`` + ``train.forward``), ``backward_share.train``,
  ``optimizer_share.train`` (``train.clip`` + ``train.optimizer``),
  ``max_pool_share.offline`` (``engine.max_pool``),
  ``quantize_share.offline`` (``int8conv.quantize``),
  ``swin_attn_share.train`` (``swin.wmsa`` + ``swin.swmsa``: a Swin
  block's norm1 through its residual add, forward only) and
  ``swin_mlp_share.train`` (``swin.mlp``);
  ``program_setup_s.offline`` is the length of the union of the host
  intervals of ``kernels.load``, ``engine.build`` and ``graphs.capture``
  before the window. A share whose spans are absent reads None.
- ``clock``: the offset of the host's ``perf_counter_ns`` onto the trace's
  clock at the window's opening and at its closing synchronize, and their
  difference. The window opens with two synchronizes, because the profiler
  stamps its first CUDA call early.
- ``launched_in``: per ``train.*`` span name, the device time of the
  kernels whose launch calls fall inside the mapped spans, over the window
  (beside ``optimizer_share.train``, the check that the spans share the
  trace's clock).
- ``idle_gaps``: the window's idle gaps as the harness's breakdown labels
  them, each gap of 5 us or more named ``<innermost span open at its
  middle> / <CUDA call>`` or ``outside the program / <CUDA call>``.
- ``graphs``: for an offline cell, the hand-written kernels' launches a
  batch in the window and the captures inside it; ``unread``, ``dropped``.
- ``swin``: for a Swin model, the token positions a forward of the cell's
  batch pads (``SwinBackbone.count_padding``; 0 at 448x448).
- ``device_ops``: the window's 30 longest device operations by share.

``--spans 0`` leaves the tracer off, for its on-cost. Needs a CUDA device;
run from the repository's root.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import tempfile  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

#: Span names of each share, and of the set-up.
SHARES = {
    "forward_share.train": ("train.input", "train.forward"),
    "backward_share.train": ("train.backward",),
    "optimizer_share.train": ("train.clip", "train.optimizer"),
    "max_pool_share.offline": ("engine.max_pool",),
    "quantize_share.offline": ("int8conv.quantize",),
    "swin_attn_share.train": ("swin.wmsa", "swin.swmsa"),
    "swin_mlp_share.train": ("swin.mlp",),
}
SETUP_SPANS = ("kernels.load", "engine.build", "graphs.capture")
SYNC = "cudaDeviceSynchronize"
OUTSIDE = "outside the program"


def parse_events(events: list) -> Tuple[list, list]:
    """A Chrome trace's device operations ``(name, category, start_us,
    end_us, correlation)`` and host CUDA calls ``(name, start_us, end_us,
    correlation)``, the calls sorted by start."""
    from portbench import trace

    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in trace.DEVICE_CATS:
            device.append((name, cat, s, e, corr))
        elif cat in trace.HOST_CATS:
            host.append((name, s, e, corr))
    host.sort(key=lambda h: h[1])
    return device, host


def clock(host: list, open_ns: int, close_ns: int) -> Dict[str, float]:
    """Offsets (us) of ``perf_counter_ns`` onto the trace's clock: the second
    synchronize's end at the window's opening, and the synchronize nearest
    where that offset puts the closing one (the profiler's stop adds one
    after it)."""
    ends = [h[2] for h in host if h[0] == SYNC]
    if len(ends) < 3:
        raise ValueError(f"the trace holds {len(ends)} synchronizes; the window makes 3")
    off_open = ends[1] - open_ns / 1e3
    close = min(ends[2:], key=lambda t: abs(t - (close_ns / 1e3 + off_open)))
    off_close = close - close_ns / 1e3
    return {"offset_open_us": off_open, "offset_close_us": off_close,
            "diff_us": off_close - off_open}


def in_window(spans: list, open_ns: int, close_ns: int) -> list:
    return [s for s in spans if open_ns <= s.start_ns < close_ns]


def shares(spans: list, open_ns: int, close_ns: int) -> Dict[str, Optional[float]]:
    """The six readings of the module's docstring."""
    from portbench import trace

    window_ms = (close_ns - open_ns) / 1e6
    device = defaultdict(float)
    seen = set()
    for s in in_window(spans, open_ns, close_ns):
        seen.add(s.name)
        if s.device_ms is not None:
            device[s.name] += s.device_ms * s.weight
    out: Dict[str, Optional[float]] = {}
    for metric, names in SHARES.items():
        out[metric] = (100.0 * sum(device[n] for n in names) / window_ms
                       if seen.intersection(names) else None)
    setup = [(s.start_ns, s.end_ns) for s in spans
             if s.name in SETUP_SPANS and s.end_ns <= open_ns]
    out["program_setup_s.offline"] = (trace.length(trace.union(setup)) * 1e-9
                                      if setup else None)
    return out


def launched_in(spans: list, device: list, host: list, offset_us: float,
                window_s: float) -> Dict[str, float]:
    """Per ``train.*`` span name, the device time (% of the window) of the
    operations whose host call starts inside one of the spans, mapped onto
    the trace's clock by ``offset_us``."""
    by_corr = defaultdict(float)
    for _, _, s, e, corr in device:
        if corr is not None:
            by_corr[corr] += e - s
    calls = [(s, corr) for _, s, _, corr in host if corr is not None]
    starts = [c[0] for c in calls]
    out = defaultdict(float)
    for sp in spans:
        if sp.replayed or not sp.name.startswith("train."):
            continue
        i = bisect.bisect_left(starts, sp.start_ns / 1e3 + offset_us)
        j = bisect.bisect_right(starts, sp.end_ns / 1e3 + offset_us)
        out[sp.name] += sum(by_corr.get(calls[k][1], 0.0) for k in range(i, j))
    return {k: 100.0 * v * 1e-6 / window_s for k, v in out.items()}


def innermost(spans: list):
    """``label(t_ns)``: the name of the innermost host span open at ``t_ns``
    (replayed spans excluded: their interval is their replay's launch), else
    :data:`OUTSIDE`."""
    host = sorted((s for s in spans if not s.replayed), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in host]
    longest = max((s.end_ns - s.start_ns for s in host), default=0)

    def label(t_ns: float) -> str:
        k = bisect.bisect_right(starts, t_ns) - 1
        best = None
        while k >= 0 and starts[k] >= t_ns - longest:
            s = host[k]
            if s.end_ns > t_ns and (best is None or s.start_ns > best.start_ns):
                best = s
            k -= 1
        return best.name if best is not None else OUTSIDE

    return label


def gap_labels(trace_data, spans: list, offset_us: float) -> list:
    """The idle gaps as ``trace_data.breakdown()`` gives them (the ten
    largest labels, ``N gaps, longest X ms`` and seconds), each gap of
    ``SHORT_GAP_US`` or more labelled ``<program span> / <CUDA call>`` at its
    middle; ``offset_us`` maps the host's clock onto the trace's."""
    from portbench import trace

    label = innermost(spans)
    by_label: Dict[str, List[float]] = defaultdict(list)
    for s, e in trace_data.gaps():
        if e - s < trace.SHORT_GAP_US:
            key = f"short (< {trace.SHORT_GAP_US:g} us)"
        else:
            m = 0.5 * (s + e)
            key = f"{label((m - offset_us) * 1e3)} / {trace_data.host_label(m)}"
        by_label[key].append((e - s) * 1e-6)
    top = sorted(by_label.items(), key=lambda kv: -sum(kv[1]))[:10]
    return [[f"{k}: {len(v)} gaps, longest {max(v) * 1e3:.4f} ms", sum(v)] for k, v in top]


def _run_cell(args) -> dict:
    import torch

    from portbench import harness, systems, trace
    from yolo_tpu_torch.utils import tracing

    root = harness.ROOT
    bench = harness.read_json(root / "BENCHMARK.json")
    cell = harness.read_json(harness.HERE / "workloads" / f"{args.workload}.json")
    config = harness.read_json(harness.HERE / "configs" / f"{cell['config']}.json")
    state: dict = {}  # what the window saw
    served_by_program = systems.served

    def served(run):
        state["served"] = served_by_program(run)
        return state["served"]

    class Run(harness.Run):
        @contextlib.contextmanager
        def window(self):
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            g = state.get("served")
            if hasattr(g, "launches"):
                state["before"] = (g.captures, g.replays, g.launches())
            try:
                torch.cuda.synchronize(self.device)
                torch.cuda.synchronize(self.device)
                state["open_ns"] = time.perf_counter_ns()
                yield
                torch.cuda.synchronize(self.device)
                state["close_ns"] = time.perf_counter_ns()
            finally:
                prof.__exit__(None, None, None)
            if "before" in state:
                state["after"] = (g.captures, g.replays, g.launches())
            del g
            state.pop("served", None)  # the driver frees the program's state before its check
            fd, path = tempfile.mkstemp(suffix=".json", prefix="span_shares_")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)
            finally:
                os.unlink(path)
            if isinstance(events, dict):
                events = events.get("traceEvents", [])
            state["device"], state["host"] = parse_events(events)
            self.trace_data = trace.TraceData(
                window_s=(state["close_ns"] - state["open_ns"]) * 1e-9,
                device_ops=[d[:4] for d in state["device"]],
                host_calls=[h[:3] for h in state["host"]])

    run = Run(cell=cell, config=config, seed=args.seed, seconds=args.seconds, trace=True,
              device=torch.device("cuda", 0), t_process=T_PROCESS)
    torch.cuda.set_device(run.device)
    systems.served = served
    if args.spans:
        tracing.enable()
    try:
        harness.execute(run)
    finally:
        systems.served = served_by_program
        tracing.disable()
    taken = tracing.take()
    result = harness.result(run, bench)
    out: dict = {"cell": args.workload, "seed": args.seed, "spans": bool(args.spans),
                 "correct": result["correct"], "setup_s": run.setup_s, **run.metrics,
                 "per_layer": {k: v["value"] for k, v in result["metrics"].items()},
                 "busy_s": result["device"].get("busy_s"),
                 "window_s": run.trace_data.window_s,
                 "unread": taken.unread, "dropped": taken.dropped}
    td, o, c = run.trace_data, state["open_ns"], state["close_ns"]
    if "after" in state:
        (c0, r0, l0), (c1, r1, l1) = state["before"], state["after"]
        batches = max(r1 - r0, 1)
        out["graphs"] = {"captures_in_window": c1 - c0, "replays": r1 - r0,
                         "launches_a_batch": {k: (v - l0.get(k, 0)) / batches
                                              for k, v in l1.items() if v > l0.get(k, 0)}}
    model = config["model"]
    if model["backbone"] == "swin_b":
        from yolo_tpu_torch.models import SwinBackbone

        side = -(-model["image_size"] // model["patch_size"])
        out["swin"] = {"padded_tokens_a_forward": SwinBackbone.count_padding(
            cell["params"]["batch"], side, side, model["depths"], model["window_size"])}
    by_op = defaultdict(float)
    for name, _, s, e, _ in state["device"]:
        by_op[trace.short_name(name)] += (e - s) * 1e-4 / td.window_s
    out["device_ops"] = sorted(by_op.items(), key=lambda kv: -kv[1])[:30]
    if taken.spans:
        clk = clock(state["host"], o, c)
        out["clock"] = clk
        out["shares"] = shares(taken.spans, o, c)
        out["launched_in"] = launched_in(in_window(taken.spans, o, c), state["device"],
                                         state["host"], clk["offset_close_us"], td.window_s)
        out["idle_gaps"] = gap_labels(td, taken.spans, clk["offset_close_us"])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    print("SPANS " + json.dumps(_run_cell(p.parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
