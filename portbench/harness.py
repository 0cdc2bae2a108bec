"""One run of one cell: its files, the set-up clock, the window, the trace,
the check against the plain reference, and the result line.

A driver (``drivers/<name>.py``) exposes ``drive(run)``. It builds the system
under test from the cell's parameters, calls :meth:`Run.setup_done` just
before the first measured request, measures for ``run.seconds`` inside
``with run.window():``, stores its end-to-end values in ``run.metrics``, its
counts over the window in ``run.window_counts``, reads the memory peak
(:meth:`Run.read_memory_peak`), frees the program's state, and fills
``run.checks`` (name -> (value, limit)) from the comparison with the
reference. The harness does the rest.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that no run may load (the JAX stack and the JAX package).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yolo_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_file(path: Path):
    """A module from a file whose name may hold ``-`` or ``.`` (cells and
    metrics are named so); registered under a flat name of its own."""
    name = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in
                                       str(path.relative_to(HERE)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one purpose (``tag``) of a run's ``--seed``; any
    whole number, negative or above 2**32, gives a valid one."""
    import numpy as np

    s = int(seed) % (1 << 64)
    words = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32, *tag.encode()]).generate_state(2)
    return (int(words[0]) << 30) ^ int(words[1])


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are in :data:`FORBIDDEN`, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Run:
    """Everything one run knows; drivers and metric readers read and fill it."""

    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_process: float
    #: Hooks of the tests and of ``control.py``: ``wrap_predict`` (predict ->
    #: predict) and ``wrap_step`` (step -> step) wrap the program's entry where
    #: a traffic driver calls it; ``served`` replaces the served callable (the control).
    hooks: Dict[str, Callable] = field(default_factory=dict)
    #: Config keys overridden at a test size (never on the command line).
    overrides: Dict = field(default_factory=dict)
    setup_s: Optional[float] = None
    metrics: Dict[str, float] = field(default_factory=dict)
    window_counts: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    trace_data: object = None  # trace.TraceData
    notes: list = field(default_factory=list)

    # ------------------------------------------------------------ cell data
    @property
    def params(self) -> dict:
        return self.cell["params"]

    def model_config(self) -> dict:
        cfg = dict(self.config["model"])
        cfg.update(self.overrides)
        return cfg

    def seed_for(self, tag: str) -> int:
        return sub_seed(self.seed, tag)

    def reference(self):
        return load_file(HERE / "references" / f"{self.config['name']}.py")

    def counts(self):
        return load_file(HERE / "counts" / f"{self.config['name']}.py")

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    # ------------------------------------------------------------ clocks
    def setup_done(self) -> None:
        """Process start to the first measured request."""
        self.setup_s = time.perf_counter() - self.t_process

    def read_memory_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    @contextlib.contextmanager
    def window(self):
        """The measured window; under ``--trace 1`` the device's activity in
        it is traced (CUDA activity alone: the host's operators go
        unrecorded, so the traced window runs at the untraced pace), its
        length is taken by the host's clock, and the trace is read once the
        window has closed."""
        if not self.trace:
            yield
            return
        import torch

        from portbench import trace

        cuda = self.device.type == "cuda"
        activity = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[activity.CUDA if cuda else activity.CPU])
        prof.__enter__()
        try:
            t0 = time.perf_counter()
            yield
            if cuda:
                torch.cuda.synchronize(self.device)
            window_s = time.perf_counter() - t0
        finally:
            prof.__exit__(None, None, None)
        self.trace_data = trace.read(prof, window_s)


# ---------------------------------------------------------------- metrics
def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether a metric belongs in a cell: its ``workloads`` name the cell,
    or without the key, the end-to-end metric it moves is reported there."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def result_metrics(run: Run, bench: dict) -> Dict[str, dict]:
    cell = run.cell["name"]
    e2e = [m for m in bench["end_to_end"] if applies(m, cell, set())]
    if not run.trace:
        out = {}
        for m in e2e:
            value = run.setup_s if m["name"] == "setup_s" else run.metrics.get(m["name"])
            if value is None:
                raise RuntimeError(f"the traffic driver measured no {m['name']}")
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out
    reported = {m["name"] for m in e2e}
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, cell, reported):
            continue
        value = load_file(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run) -> dict:
    import torch

    if run.device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": int(run.cell["chips"]), "memory_peak_bytes": run.memory_peak}
    if run.trace and run.trace_data is not None:
        info["busy_s"] = run.trace_data.busy_s
        info["window_s"] = run.trace_data.window_s
    return info


def is_correct(run: Run) -> bool:
    return bool(run.checks) and all(
        math.isfinite(v) and v <= lim for v, lim in run.checks.values())


def result(run: Run, bench: dict) -> dict:
    """The result line's object; ``checks`` comes last."""
    out = {"correct": is_correct(run), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": result_metrics(run, bench),
           "device": device_info(run)}
    if run.trace and run.trace_data is not None:
        out["breakdown"] = run.trace_data.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def execute(run: Run) -> None:
    """Drive the cell (set-up, window, check)."""
    driver = load_file(HERE / "drivers" / f"{run.cell['driver']}.py")
    driver.drive(run)
