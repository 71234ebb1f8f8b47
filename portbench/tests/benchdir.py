"""A benchmark folder of the harness's own layout at a size the CPU runs
in seconds, written into a test's temporary directory."""

import json
import os

TINY_CONFIG = {
    "name": "tiny-ivfsq", "source": "a CPU-sized shard of the ivfsq index type",
    "reduced": ["rows", "dim"], "assumed": {}, "rows": 12000, "dim": 32,
    "index": {"index_builder_type": "ivfsq", "dim": 32, "metric": "l2", "centroids": 32,
              "train_num": 4000},
    "corpus": {"kind": "lowrank", "rank": 8, "clusters": 24, "center_scale": 1.0,
               "ambient_sigma": 0.05, "structure_seed": 5},
    "served_precision": "float16",
    "kernels": {"K1": {"row_bytes": 72}},
    "control": {"kind": "reference", "precision": "int8"},
}
TINY_MIX = {"loop": "closed", "clients": 2, "rows_per_request": 16, "k": 10,
            "recall_bar": 0.8}
TINY_POINT = {"nprobe": 8, "recall10": 0.9, "pool_rate": 4000,
              "limits": {"dist_gap": 0.01}}


def benchmark(cells) -> dict:
    return {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 2,
        "configs": [{"name": "tiny-ivfsq", "source": "test", "file": "x", "reduced": [],
                     "why": "test"}],
        "workloads": [{"name": c, "config": "tiny-ivfsq", "traffic": "tiny", "chips": 1,
                       "why": "test"} for c in cells],
        "end_to_end": [
            {"name": "qps", "unit": "queries/s", "better": "higher", "bound": 0.05,
             "source": "host_clock"},
            {"name": "p95_ms", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock"},
            {"name": "device_mem_gib", "unit": "GiB", "better": "lower", "bound": 0.01,
             "source": "device_trace"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": n, "unit": u, "better": b, "source": "program_counter", "layer": "x",
             "moves": mv}
            for n, u, b, mv in (("host_path_ms", "ms", "lower", "p95_ms"),
                                ("queue_wait_ms", "ms", "lower", "p95_ms"),
                                ("launch_ms", "ms", "lower", "qps"))],
    }


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def make_bench_dir(root: str, cells=("tiny-ivfsq.tiny",), point=None) -> str:
    """``root``/portbench with the tiny config, the ``tiny`` mix, one
    operating point a cell and the repo's metric readers; returns it."""
    bench = os.path.join(root, "portbench")
    write(os.path.join(root, "BENCHMARK.json"), benchmark(cells))
    write(os.path.join(bench, "configs", "tiny-ivfsq.json"), TINY_CONFIG)
    write(os.path.join(bench, "traffic", "tiny.json"), TINY_MIX)
    for c in cells:
        write(os.path.join(bench, "cells", f"{c}.json"), dict(TINY_POINT, **(point or {})))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(bench, "metrics"), exist_ok=True)
    for name in os.listdir(os.path.join(here, "metrics")):
        if name.endswith(".py"):
            with open(os.path.join(here, "metrics", name)) as src, \
                    open(os.path.join(bench, "metrics", name), "w") as dst:
                dst.write(src.read())
    return bench
