"""The per-layer readers on recorded rank counters and a recorded trace."""

import numpy as np

from portbench import devtrace, spec, traffic
from portbench.tests import benchdir


def snap(queue_n, queue_t, dev_n, dev_t, rows_t, k1):
    return {"scheduler": {"queues": {"queue_wait_s": {"count": queue_n, "total_s": queue_t}}},
            "engine": {"bench": {"device_search_s": {"count": dev_n, "total_s": dev_t},
                                 "device_search_rows": {"count": dev_n, "total_s": rows_t}}},
            "kernels": {"flat_list_scan": k1}}


def request(sent, done):
    r = traffic.Request(0, 0, sent)
    r.done = done
    r.ids = np.zeros((4, 10), np.int64)
    return r


def ctx_of(tmp_path, **kw):
    root = str(tmp_path)
    bench_dir = benchdir.make_bench_dir(root)
    cell = spec.Cell(spec.load_benchmark(root), "tiny-ivfsq.tiny", bench_dir)
    ctx = dict(cell=cell, index_id="bench", w0=10.0, tp=20.0, w1=21.0, seed=3,
               snaps={"w0": snap(100, 0.5, 100, 2.0, 25600, 400),
                      "tp": snap(150, 0.6, 150, 3.0, 38400, 600)},
               requests=[request(9.0, 9.5), request(10.0, 10.04), request(12.0, 12.06),
                         request(19.99, 20.5)],
               trace=None, snapshot=None, programs=None, device="cpu", pool=None)
    ctx.update(kw)
    return ctx


def read(name, ctx):
    return spec.load_reader(name)(ctx)


def test_counter_diffs(tmp_path):
    ctx = ctx_of(tmp_path)
    assert np.isclose(read("queue_wait_ms", ctx), 0.1 / 50 * 1e3)
    assert np.isclose(read("launch_ms", ctx), 1.0 / 50 * 1e3)


def test_host_path_is_request_time_less_queue_and_device(tmp_path):
    ctx = ctx_of(tmp_path)
    # the two requests done in [w0, tp): 40 and 60 ms
    assert np.isclose(read("host_path_ms", ctx), 50.0 - 2.0 - 20.0)


def test_a_counter_that_did_not_move_reads_nothing(tmp_path):
    ctx = ctx_of(tmp_path)
    ctx["snaps"]["tp"] = ctx["snaps"]["w0"]
    for name in ("queue_wait_ms", "launch_ms", "host_path_ms"):
        assert read(name, ctx) is None


def test_graph_pool_and_idle(tmp_path):
    ctx = ctx_of(tmp_path, programs={"programs": 3, "pool_bytes": 3 << 29},
                 trace={"busy_s": 0.25, "window_s": 1.0})
    assert read("graph_pool_gib", ctx) == 1.5
    assert read("device_idle_pct", ctx) == 75.0
    assert read("device_idle_pct", ctx_of(tmp_path, trace={"busy_s": 0.0,
                                                           "window_s": 1.0})) is None
    assert read("graph_pool_gib", ctx_of(tmp_path, programs={"programs": 0})) is None


def test_roofline_share_over_the_traced_launches(tmp_path):
    c = np.array([[0.0] * 32, [5.0] * 32], np.float32)
    pool = traffic.Pool([np.zeros((64, 32), np.float32)], 16)
    reqs = [request(20.5, 20.6)]
    reqs[0].offset = 0
    trace = {"ops": {"void flat_scan_kernel<__half>(ScanArgs)": [4, 2e-6]},
             "busy_s": 1e-3, "window_s": 1.0}
    ctx = ctx_of(tmp_path, requests=reqs, pool=pool, trace=trace,
                 snapshot={"centroids": c, "sizes": np.array([100, 50])})
    ctx["cell"].point["nprobe"] = 1
    ctx["cell"].config["kernels"]["K1"]["row_bytes"] = 72
    # 12800 rows over 200 launches: 64 rows a launch, 4 traced -> 16 requests
    nbytes = 100 * 72 + 16 * 32 * 4 + 2 * 16 * 1 * 4 + 16 * 100 * 4
    want = 100 * 16 * nbytes / 3.35e12 / 2e-6
    assert np.isclose(read("k1_roofline_pct", ctx), want)
    assert read("k3_roofline_pct", ctx) is None


def test_trace_summary():
    spans = [(True, 0, 100, "k1"), (True, 50, 150, "k2"), (True, 400, 500, "k1"),
             (False, 160, 390, "cudaGraphLaunch"), (True, 900, 1200, "k3")]
    out = devtrace.summarize(spans, 1e-3)
    assert np.isclose(out["busy_s"], 350e-6)
    assert out["ops"]["k1"][0] == 2 and np.isclose(out["ops"]["k1"][1], 200e-6)
    assert out["device_ops"][0][0] == "k1"
    assert out["idle_gaps"][0][0].startswith("host: no profiled operation")
    assert np.isclose(out["idle_gaps"][0][1], 400e-6)
    assert out["idle_gaps"][1] == ["host: cudaGraphLaunch", 250e-6]
    assert devtrace.kernel_time(out, "k1") == (2, out["ops"]["k1"][1])


def test_profile_spans_of_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    torch.randn(64, 64) @ torch.randn(64, 64)
    prof.stop()
    spans = devtrace.profile_spans(prof)
    assert spans and all(not dev and 0 <= s <= e for dev, s, e, _n in spans)
    assert any("mm" in n for _d, _s, _e, n in spans)
