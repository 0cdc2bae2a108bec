"""``BENCHMARK.json`` against the benchmark's rules, every name it holds
against the allowed characters, each name's file, and the last line's shape."""

import json
import re

import pytest

from portbench import harness
from portbench.tests import tiny

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_is_allowed_and_unique():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] \
        + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


def test_configs_cells_and_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(configs) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (harness.HERE / "references" / f"{c['name']}.py").is_file()
        assert (harness.HERE / "counts" / f"{c['name']}.py").is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.read_json(harness.HERE / "workloads" / f"{w['name']}.json")
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (harness.HERE / "drivers" / f"{cell['driver']}.py").is_file()
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"]) and m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, m["moves"]), (m["name"], cell)
    for cell in cells:  # setup_s, another end-to-end metric, a per-layer one
        assert sum(reports(cell, n) for n in e2e) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(trace):
    run = tiny.execute("r50-int8-offline-b256", trace=trace, seconds=0.2)
    out = harness.result(run, BENCH)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in out) == trace
    assert isinstance(out["correct"], bool)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if not trace:
        assert set(out["metrics"]) == {"images_per_s", "setup_s"}
        assert out["metrics"]["images_per_s"]["unit"] == "images/s"
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] == run.cell["limits"][name]
    json.loads(json.dumps(out))
