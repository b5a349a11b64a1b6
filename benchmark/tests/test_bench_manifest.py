"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each entry names, and the metrics each cell reports."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", path) and not path.startswith("/")
        assert ".." not in path.split("/") and not path.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_files_and_reductions():
    keys = {"name", "source", "file", "reduced", "why"}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == keys and c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads_have_their_files():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "checks" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_metrics_fields_bounds_and_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    cells = {w["name"] for w in BENCH["workloads"]}

    def of(metric):
        return set(metric.get("workloads", cells))

    for cell in cells:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in of(m) for m in BENCH["per_layer"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and "\t" not in layer for layer in layers)
