"""The manifest against the benchmark's contract, and every name it gives
found as a file: a later cell, mix or metric is added as files and entries,
never by editing the harness."""

import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MANIFEST = harness.load_manifest()


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_paths():
    assert set(MANIFEST) == TOP
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for path in MANIFEST["paths"]:
        assert PATH.match(path) and not path.startswith("/") \
            and ".." not in path.split("/")
        assert os.path.isdir(os.path.join(harness.ROOT, path))
    assert MANIFEST["command"][1] in [f"{p}/run.py" for p in
                                      MANIFEST["paths"]]
    assert len(MANIFEST["command"]) <= 32
    assert all(line_ok(word) for word in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) \
        and 1 <= MANIFEST["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_names_units_and_entries():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line_ok(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert fours <= max(1, len(MANIFEST["workloads"]) // 4)


def test_every_config_is_used_and_its_file_found():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert config["source_url"] == c["source"]
        assert config["ops"] and all(
            {"count", "op", "dims", "dtype"} <= set(op)
            for op in config["ops"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_reports_what_the_manifest_asks(cell):
    found = harness.find_cell(MANIFEST, cell)
    assert "setup_s" in found.end_to_end and len(found.end_to_end) >= 2
    assert found.per_layer
    assert found.traffic["loop"]
    assert os.path.exists(os.path.join(harness.BENCH, "loops",
                                       found.traffic["loop"] + ".py"))
    for name in found.per_layer:
        entry = next(m for m in MANIFEST["per_layer"] if m["name"] == name)
        assert entry["moves"] in found.end_to_end, (name, entry["moves"])
        assert os.path.exists(os.path.join(
            harness.BENCH, "metrics", harness.metric_module(name) + ".py"))


def test_metric_workloads_name_cells():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]


def test_run_budget_fits_the_full_check():
    seconds = MANIFEST["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (seconds + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
