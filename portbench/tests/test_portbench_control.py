"""The control comes out as not correct: the reference, its rows stored one
precision below what the configuration serves, put in the program's place.
On the CPU at a tiny size; at each cell's own size on the card."""

import os
import time

import pytest

from portbench import control, harness, spec
from portbench.tests import benchdir


def test_control_fails_the_tiny_limit(tmp_path):
    root = str(tmp_path)
    bench_dir = benchdir.make_bench_dir(root)
    cell = spec.Cell(spec.load_benchmark(root), "tiny-ivfsq.tiny", bench_dir)
    sound = harness.run_cell(cell, 5, 1.0, False, time.perf_counter(), device="cpu")
    ctl = control.control_numbers(cell, 5, 1.0, device="cpu")
    limit = cell.point["limits"]["dist_gap"]
    assert sound["checks"]["dist_gap"]["value"] * 3 <= limit < ctl["dist_gap"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(card, workload):
    cell = spec.Cell(spec.load_benchmark(), workload)
    limit = cell.point["limits"]["dist_gap"]
    seeds = [int(s) for s in os.environ.get("PORTBENCH_CONTROL_SEEDS", "101 102 103").split()]
    for seed in seeds:
        numbers = control.control_numbers(cell, seed, 3.0)
        assert numbers["dist_gap"] > limit or numbers["recall10"] < cell.mix["recall_bar"], \
            (workload, seed, numbers)
