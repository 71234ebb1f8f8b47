"""The benchmark file against its contract, and every part of a cell found
by name; a mix, a cell and a metric added as new files and entries only."""

import json
import os
import re
import shutil

import pytest

from portbench import spec
from portbench.tests import benchdir

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_the_contract_keys(bench, section):
    entries = bench[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= ENTRY_KEYS[section], e["name"]
        assert set(e) >= ENTRY_KEYS[section] - {"workloads"}, e["name"]
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert line_ok(e[key]), (e["name"], key)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_finds_its_parts(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.load_reader(m["name"]))
        cfg = configs[w["config"]]
        assert cfg["file"] == f"portbench/configs/{w['config']}.json"
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == cfg["reduced"]
        assert line_ok(cell.config["source"]) and cell.config["source"] == cfg["source"]
        assert cell.point["nprobe"] >= 1


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(spec.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert PATH.match(rel), rel


def test_unknown_names_are_refused(bench):
    with pytest.raises(spec.SpecError):
        spec.Cell(bench, "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.load_config("../BENCHMARK")
    with pytest.raises(spec.SpecError):
        spec.load_reader("no_such_metric")


def test_an_addition_needs_no_edit(tmp_path):
    """A new mix, its cell and a new per-layer metric arrive as new files and
    new entries; every file already there is left as it was."""
    root = str(tmp_path)
    bench_dir = benchdir.make_bench_dir(root)
    before = {}
    for dirpath, _dirs, files in os.walk(bench_dir):
        for f in files:
            p = os.path.join(dirpath, f)
            before[p] = open(p, "rb").read()
    benchdir.write(os.path.join(bench_dir, "traffic", "wide.json"),
                   dict(benchdir.TINY_MIX, clients=4, k=20))
    benchdir.write(os.path.join(bench_dir, "cells", "tiny-ivfsq.wide.json"),
                   benchdir.TINY_POINT)
    with open(os.path.join(bench_dir, "metrics", "requests_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx['requests']))\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "tiny-ivfsq.wide", "config": "tiny-ivfsq",
                               "traffic": "wide", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "client",
                               "moves": "qps", "workloads": ["tiny-ivfsq.wide"]})
    cell = spec.Cell(bench, "tiny-ivfsq.wide", bench_dir)
    assert cell.mix["clients"] == 4 and cell.mix["k"] == 20
    assert [m["name"] for m in cell.per_layer][-1] == "requests_seen"
    assert spec.load_reader("requests_seen", bench_dir)({"requests": [1, 2]}) == 2.0
    old = spec.Cell(bench, "tiny-ivfsq.tiny", bench_dir)
    assert "requests_seen" not in [m["name"] for m in old.per_layer]
    for p, data in before.items():
        assert open(p, "rb").read() == data
    shutil.rmtree(root)
