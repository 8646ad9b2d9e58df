"""BENCHMARK.json and the files it names: every configuration, traffic mix,
metric reader and limit file loads and names only parts that exist."""

import json
import re
from pathlib import Path

import pytest

from portbench import check, harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and 1 <= len(entry["source"]) <= 200
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and set(cfg["reduced"]) <= set(cfg)
    for key in ("width", "height", "levels", "scale_factor", "max_keypoints",
                "fast_threshold", "harris_threshold", "fps", "fx", "fy", "cx", "cy",
                "scene", "assumed"):
        assert key in cfg, key
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}
    mix = harness.load_json("traffic", cell["traffic"])
    assert mix["mode"] in ("chunk", "frame")
    limits = check.load_limits(cell["name"])
    assert all(lo <= hi for lo, hi in limits.values())
    e2e, per_layer = harness.cell_metrics(SPEC, cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    """Each per-layer metric has its reader, which declares what the entry says."""
    reader = harness.load_reader(metric["name"])
    assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES) == (
        metric["layer"], metric["unit"], metric["better"], metric["moves"])
    assert reader.read({}) is None          # nothing to read: no number
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in metric["workloads"]:
        assert cell in e2e[metric["moves"]].get("workloads", [cell])


def test_layer_names_are_perf_md_layers():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in SPEC["per_layer"]}:
        assert f"**{layer}**" in perf, layer


def test_every_file_is_named():
    """No configuration, mix, reader or limit file lies unused."""
    here = ROOT / "portbench"
    names = {
        "configs": {c["name"] for c in SPEC["configs"]},
        "traffic": {w["traffic"] for w in SPEC["workloads"]},
        "limits": {w["name"] for w in SPEC["workloads"]},
    }
    for kind, want in names.items():
        assert {p.stem for p in (here / kind).glob("*.json")} == want, kind
    readers = {p.name[:-3] for p in (here / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in SPEC["per_layer"]}
