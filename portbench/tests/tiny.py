"""Runs of the benchmark's cells at a size a CPU test can hold: every width
of the configuration cut, every traffic driver and comparison as on the card."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness

SEED = 2 ** 31 + 977


def cell(name: str) -> dict:
    """The cell's file with its amounts cut to a test size."""
    c = copy.deepcopy(harness.read_json(harness.HERE / "workloads" / f"{name}.json"))
    p = c["params"]
    if "batch" in p:
        p["batch"] = 4
    if "pool_batches" in p:
        p["pool_batches"] = 4 if c["driver"] == "train" else 2
    return c


def run(name: str, seed: int = SEED, seconds: float = 0.5, trace: bool = False,
        hooks=None) -> harness.Run:
    c = cell(name)
    config = harness.read_json(harness.HERE / "configs" / f"{c['config']}.json")
    overrides = {"image_size": 64}
    if config["model"]["backbone"] == "resnet":
        overrides["stage_sizes"] = [1, 1, 1, 1]
    return harness.Run(cell=c, config=config, seed=seed, seconds=seconds, trace=trace,
                       device=torch.device("cpu"), t_process=time.perf_counter(),
                       hooks=dict(hooks or {}), overrides=overrides)


def execute(name: str, **kwargs) -> harness.Run:
    r = run(name, **kwargs)
    harness.execute(r)
    return r
