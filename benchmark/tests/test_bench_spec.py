"""BENCHMARK.json and the files the harness finds by name."""
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    ids = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(ids) == len(set(ids))


def test_bounds_and_layers():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    assert config["reduced"] == cfg["reduced"]
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{w['name']}.json").read_text())
    for m in traffic["modalities"]:
        assert {"tol", "limit"} <= set(limits[f"{m}_off"])
    assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
    assert callable(mod.read)
