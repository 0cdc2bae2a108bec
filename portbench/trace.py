"""The profiler's trace of a window, reduced to what the metric readers need.

The window is traced with CUDA activity alone, so the host's operators are
not recorded and do not slow the window. The trace is exported as Chrome
JSON into ``TMPDIR`` and read back: the device's operations (``kernel``,
``gpu_memcpy``, ``gpu_memset``) and the host's CUDA API calls
(``cuda_runtime``, ``cuda_driver``), on one clock in microseconds. The
window's length comes from the host's clock; it starts after a synchronize
and ends with one, so every device operation of the trace is the window's.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
Interval = Tuple[float, float]
#: Idle gaps shorter than this (back-to-back launches) are not labelled one by one.
SHORT_GAP_US = 5.0


def short_name(name: str) -> str:
    """A device operation's name without return type, namespaces of no
    meaning and argument list, at most 160 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Merged ``a`` minus merged ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


@dataclass
class TraceData:
    window_s: float
    #: (name, category, start_us, end_us) of every device operation in the window.
    device_ops: List[Tuple[str, str, float, float]] = field(default_factory=list)
    #: (name, start_us, end_us) of the host's CUDA API calls, sorted by start.
    host_calls: List[Tuple[str, float, float]] = field(default_factory=list)

    def intervals(self, pred=lambda name, cat: True) -> List[Interval]:
        return union([(s, e) for name, cat, s, e in self.device_ops if pred(name, cat)])

    @property
    def busy_s(self) -> float:
        return length(self.intervals()) * 1e-6

    def device_time(self, pred) -> float:
        """Summed device seconds of the operations ``pred(name, category)`` picks."""
        return sum(e - s for name, cat, s, e in self.device_ops if pred(name, cat)) * 1e-6

    def gaps(self) -> List[Interval]:
        """Idle intervals between the window's first and last device operation."""
        busy = self.intervals()
        return subtract([(busy[0][0], busy[-1][1])], busy) if busy else []

    @functools.cached_property
    def _call_starts(self) -> List[float]:
        return [s for _, s, _ in self.host_calls]

    def host_label(self, t: float) -> str:
        """The host's CUDA call open at ``t``, else "host outside CUDA calls"."""
        i = bisect.bisect_right(self._call_starts, t)
        for name, s, e in reversed(self.host_calls[max(0, i - 64):i]):
            if s <= t < e:
                return name
        return "host outside CUDA calls"

    def breakdown(self) -> dict:
        by_op: Dict[str, float] = defaultdict(float)
        for name, _, s, e in self.device_ops:
            by_op[short_name(name)] += (e - s) * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        by_label: Dict[str, List[float]] = defaultdict(list)
        gaps = self.gaps()
        for s, e in gaps:
            label = (f"short (< {SHORT_GAP_US:g} us)" if e - s < SHORT_GAP_US
                     else self.host_label(0.5 * (s + e)))
            by_label[label].append((e - s) * 1e-6)
        edges = self.window_s - (length(gaps) * 1e-6 + self.busy_s)
        if edges > 0:
            by_label["window edges (before the first, after the last device op)"] = [edges]
        top = sorted(by_label.items(), key=lambda kv: -sum(kv[1]))[:10]
        return {
            "device_ops": [[name, t] for name, t in ops],
            "idle_gaps": [[f"{label}: {len(v)} gaps, longest {max(v) * 1e3:.4f} ms", sum(v)]
                          for label, v in top],
        }


def read(prof, window_s: float) -> TraceData:
    """The window's trace from a stopped ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, cat, s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
    host.sort(key=lambda x: x[1])
    return TraceData(window_s=window_s, device_ops=device, host_calls=host)
