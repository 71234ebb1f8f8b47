"""Whole runs of the harness on the CPU at a tiny size (the rank on the CPU,
the look for a card skipped): the result line's keys, ``breakdown`` only
when traced, the checks last, and ``correct`` false once the timed path is
broken underneath."""

import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from distributed_faiss_tpu_torch.parallel.client import IndexClient
from portbench import harness, rankproc, run, spec, traffic
from portbench.tests import benchdir

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(tmp_path, trace=False, seconds=2.0, seed=2**33 + 17, point=None):
    root = str(tmp_path)
    bench_dir = benchdir.make_bench_dir(root, point=point)
    cell = spec.Cell(spec.load_benchmark(root), "tiny-ivfsq.tiny", bench_dir)
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tmp_path, trace):
    out = tiny_run(tmp_path, trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert ("breakdown" in out) == trace
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["metrics"]) == {"host_path_ms", "queue_wait_ms", "launch_ms"}
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"qps", "p95_ms", "device_mem_gib", "setup_s"}
        assert out["metrics"]["qps"]["unit"] == "queries/s"
    assert set(out["checks"]) == {"unanswered", "bad_rows", "recall10", "dist_gap"}
    err, std = io.StringIO(), io.StringIO()
    with redirect_stderr(err), redirect_stdout(std):
        run.emit(out)
    assert json.loads(std.getvalue().splitlines()[-1]) == json.loads(json.dumps(out))
    assert err.getvalue().splitlines()[-1].startswith("check dist_gap:")


def broken(monkeypatch, fault):
    real = IndexClient.search

    def search(self, query, topk, index_id, **kw):
        if fault == "altered":
            d, meta = real(self, query, topk, index_id, **kw)
            meta = [list(row) for row in meta]
            for row in meta:
                row[0] = (row[0] + 1) % 12000
            return d, meta
        if fault == "half_left_out":
            half = query.shape[0] // 2
            d, meta = real(self, query[:half], topk, index_id, **kw)
            return np.concatenate([d, d]), list(meta) + list(meta)
        raise ValueError(fault)

    monkeypatch.setattr(IndexClient, "search", search)


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    broken(monkeypatch, fault)
    out = tiny_run(tmp_path)
    assert out["correct"] is False
    failing = {n for n, c in out["checks"].items()
               if not (c["value"] <= c["limit"] if n != "recall10" else c["value"] >= c["limit"])}
    assert failing & {"dist_gap", "recall10", "bad_rows"}


def test_a_pool_drawn_short_is_drawn_on_from_the_seed(tmp_path, monkeypatch):
    monkeypatch.setattr(traffic, "CHUNK_ROWS", 64)
    out = tiny_run(tmp_path, point={"pool_rate": 1})
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] * 16 > traffic.chunk_rows(16)


def test_pool_chunks_are_taken_once_and_drawn_from_the_seed():
    def more(i):
        return np.full((32, 4), float(i), np.float32)

    pool = traffic.Pool([more(0)], 16, more=more)
    try:
        offs = [pool.take() for _ in range(20)]
        assert offs == list(range(0, 320, 16))
        assert [float(pool.batch(o)[0, 0]) for o in offs[::2]] == list(map(float, range(10)))
        assert pool.drawn >= 9
    finally:
        pool.close()


def test_a_pool_with_nothing_more_to_draw_runs_out():
    pool = traffic.Pool([np.zeros((32, 4), np.float32)], 16)
    pool.take(), pool.take()
    with pytest.raises(traffic.PoolExhausted, match="ran out"):
        pool.take()

    def fails(i):
        raise OSError("no memory")

    pool = traffic.Pool([np.zeros((32, 4), np.float32)], 16, more=fails)
    try:
        pool.take(), pool.take()
        with pytest.raises(traffic.PoolExhausted, match="no memory"):
            pool.take()
    finally:
        pool.close()


def test_the_harness_keeps_one_physical_core():
    siblings = {0: [0, 4], 1: [1, 5]}
    assert rankproc.harness_cpus(list(range(8)), lambda c: siblings.get(c, [c])) == [0, 4]
    assert rankproc.harness_cpus(list(range(8)), lambda c: [c]) == [0, 1]
    assert rankproc.harness_cpus([0, 1, 2], lambda c: [c]) == [0, 1, 2]
