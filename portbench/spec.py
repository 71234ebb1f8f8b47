"""Find a cell's parts by name: the benchmark file, the configuration, the
traffic mix, the operating point and the per-layer metric readers.

A later cell, mix, configuration or metric is added as new files and new
entries of ``BENCHMARK.json``; nothing here names one of them.
"""

import importlib.util
import json
import os
import re

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(ValueError):
    """A cell, configuration, mix or metric that cannot be found or read."""


def _name(value: str, what: str) -> str:
    if not isinstance(value, str) or not NAME_RE.match(value):
        raise SpecError(f"bad {what} name {value!r}")
    return value


def _json(path: str, what: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"no {what} file {os.path.relpath(path, ROOT)}") from None


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"), "benchmark")


class Cell:
    """One entry of ``workloads`` with everything it names, read from the
    folder ``bench_dir`` (``portbench/`` in the repo; a test's copy)."""

    def __init__(self, bench: dict, workload: str, bench_dir: str = HERE):
        entries = {w["name"]: w for w in bench.get("workloads", [])}
        if workload not in entries:
            raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entries[workload]
        self.name = _name(workload, "workload")
        self.chips = int(self.entry["chips"])
        self.bench_dir = bench_dir
        configs = {c["name"]: c for c in bench.get("configs", [])}
        cfg_name = _name(self.entry["config"], "config")
        if cfg_name not in configs:
            raise SpecError(f"workload {workload!r} names no known config {cfg_name!r}")
        self.config = load_config(cfg_name, bench_dir)
        self.mix = load_mix(_name(self.entry["traffic"], "traffic"), bench_dir)
        self.point = load_point(self.name, bench_dir)
        self.end_to_end = [m for m in bench.get("end_to_end", []) if applies(m, workload)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench.get("per_layer", [])
                          if applies(m, workload) and m.get("moves") in e2e_names]


def applies(metric: dict, workload: str) -> bool:
    """A metric with a ``workloads`` key is read in those cells only."""
    cells = metric.get("workloads")
    return cells is None or workload in cells


def load_config(name: str, bench_dir: str = HERE) -> dict:
    cfg = _json(os.path.join(bench_dir, "configs", f"{_name(name, 'config')}.json"),
                "config")
    for key in ("rows", "dim", "index", "corpus", "served_precision"):
        if key not in cfg:
            raise SpecError(f"config {name!r} lacks {key!r}")
    return cfg


def load_mix(name: str, bench_dir: str = HERE) -> dict:
    mix = _json(os.path.join(bench_dir, "traffic", f"{_name(name, 'traffic')}.json"),
                "traffic")
    for key in ("clients", "rows_per_request", "k", "recall_bar"):
        if key not in mix:
            raise SpecError(f"traffic {name!r} lacks {key!r}")
    return mix


def load_point(workload: str, bench_dir: str = HERE) -> dict:
    """The cell's operating point: the nprobe its sweep found, the recall
    there, and the query rate its pool is sized for."""
    point = _json(os.path.join(bench_dir, "cells", f"{_name(workload, 'workload')}.json"),
                  "cell")
    for key in ("nprobe", "recall10", "pool_rate"):
        if key not in point:
            raise SpecError(f"cell {workload!r} lacks {key!r}")
    return point


def load_reader(metric: str, bench_dir: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{_name(metric, 'metric')}.py")
    if not os.path.exists(path):
        raise SpecError(f"no reader {os.path.relpath(path, ROOT)} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
