"""The port's utils/tracing.py against the JAX package's: the same records
give the same summaries, raw histograms, exemplars and deltas (exact: both
sides do the same float arithmetic), and the profiler hooks record their
ranges."""

import json
import os

import numpy as np
import pytest

import distributed_faiss_tpu.utils.tracing as jtracing
import distributed_faiss_tpu_torch.utils.tracing as ttracing


def _records(seed: int, n: int = 300):
    """(op, seconds, exemplar) triples: a log-uniform body from 1 µs to 10 s
    and out-of-range values, a few of them sampled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        op = ("search", "queue_wait_s", "e2e_s")[i % 3]
        secs = float(10 ** rng.uniform(-7, 3.5))
        ex = f"t{seed}-{i}" if rng.random() < 0.1 else None
        out.append((op, secs, ex))
    return out


def _both(records):
    j, t = jtracing.LatencyStats(), ttracing.LatencyStats()
    for op, secs, ex in records:
        j.record(op, secs, exemplar=ex)
        t.record(op, secs, exemplar=ex)
    return j, t


def test_bucket_bounds_are_the_jax_packages():
    assert ttracing.bucket_bounds() == jtracing.bucket_bounds()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("raw", [False, True])
def test_summaries_match_jax(seed, raw):
    """Exact equality of every summary field, the raw histogram and the
    fresh exemplars and p99 exemplar included."""
    j, t = _both(_records(seed))
    assert t.summary(raw=raw) == j.summary(raw=raw)


def test_p99_exemplar_is_the_tails_only():
    for mod in (jtracing, ttracing):
        stats = mod.LatencyStats()
        for _ in range(200):
            stats.record("op", 0.001)
        stats.record("op", 0.5, exemplar="tail-trace")
        assert stats.summary()["op"]["p99_exemplar"] == "tail-trace"
        raw = stats.summary(raw=True)["op"]
        assert sum(raw["hist"]) == 201 and list(raw["exemplars"].values()) == ["tail-trace"]
        body = mod.LatencyStats()
        body.record("op", 0.001, exemplar="body-trace")
        for _ in range(200):
            body.record("op", 0.5)
        assert "p99_exemplar" not in body.summary()["op"]


def test_exemplar_ttl_ages_out_in_both(monkeypatch):
    """An exemplar older than EXEMPLAR_TTL_S is no longer advertised; both
    packages age it on time.monotonic against the module's constant."""
    j, t = _both([("op", 0.5, "old-trace")])
    assert t.summary()["op"]["p99_exemplar"] == "old-trace"
    monkeypatch.setattr(jtracing, "EXEMPLAR_TTL_S", 0.0)
    monkeypatch.setattr(ttracing, "EXEMPLAR_TTL_S", 0.0)
    assert "p99_exemplar" not in t.summary()["op"]
    assert t.summary(raw=True)["op"]["exemplars"] == {}
    assert t.summary(raw=True) == j.summary(raw=True)


def test_no_exemplar_keeps_the_summary_shape():
    stats = ttracing.LatencyStats()
    stats.record("op", 0.01)
    assert set(stats.summary()["op"]) == {"count", "total_s", "max_s", "mean_s", "p50_s",
                                          "p95_s", "p99_s"}
    assert stats.summary(raw=True)["op"]["exemplars"] == {}


@pytest.mark.parametrize("seed", [0, 5])
def test_delta_matches_jax(seed):
    """The interval rows of two snapshots, the restart rule included."""
    recs = _records(seed)
    j, t = _both(recs[:100])
    jprev, tprev = j.summary(raw=True), t.summary(raw=True)
    for op, secs, ex in recs[100:]:
        j.record(op, secs, exemplar=ex)
        t.record(op, secs, exemplar=ex)
    jcur, tcur = j.summary(raw=True), t.summary(raw=True)
    got = ttracing.LatencyStats.delta(tprev, tcur)
    assert got == jtracing.LatencyStats.delta(jprev, jcur)
    assert sum(got["search"]["hist"]) == got["search"]["count"] == 66
    assert ttracing.LatencyStats.delta(None, tcur) == jtracing.LatencyStats.delta(None, jcur)
    # a rank that restarted: its new totals, never a negative rate
    jf, tf = _both(recs[:3])
    back = ttracing.LatencyStats.delta(tcur, tf.summary(raw=True))
    assert back == jtracing.LatencyStats.delta(jcur, jf.summary(raw=True))
    assert back["search"]["count"] == 1 and back["search"]["total_s"] > 0


def test_reset_clears_exemplars():
    stats = ttracing.LatencyStats()
    stats.record("op", 0.5, exemplar="x")
    stats.reset()
    assert stats.summary() == {}


def test_traced_records_and_names_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    stats = ttracing.LatencyStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttracing.traced("dft.test_block", stats):
            np.ones(1000).sum()
    assert stats.summary()["dft.test_block"]["count"] == 1
    assert "dft.test_block" in {e.key for e in prof.key_averages()}
    with ttracing.traced("dft.no_stats"):
        pass


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    log_dir = str(tmp_path / "prof")
    with ttracing.profile_trace(log_dir):
        with ttracing.traced("dft.profiled"):
            torch.ones(64).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        trace = json.load(f)
    assert any(e.get("name") == "dft.profiled" for e in trace["traceEvents"])
