"""The port's observability on the CPU: span rings, sampling, the
Prometheus text (held against the JAX package's renderer on the same
trees), the metrics listener, serial CALL frames byte-identical to the JAX
serial client's, traced requests through loopback port servers (stages,
failover, exemplars), stats that degrade per dead rank, and dfstat."""

import importlib
import io
import json
import logging
import pkgutil
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributed_faiss_tpu.observability import export as jexport
from distributed_faiss_tpu.observability import spans as jspans
from distributed_faiss_tpu.parallel import rpc as jrpc
from distributed_faiss_tpu.utils.tracing import LatencyStats as JStats
import distributed_faiss_tpu_torch
from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.observability import dfstat, export, spans
from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.testing.chaos import ChaosProxy
from distributed_faiss_tpu_torch.utils.config import IndexCfg, ReplicationCfg, TracingCfg
from distributed_faiss_tpu_torch.utils.state import IndexState
from distributed_faiss_tpu_torch.utils.tracing import LatencyStats, bucket_bounds

from netutil import free_port

STAGES = ("server.queue", "server.device", "server.write")


def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def write_discovery(tmp_path, ports, name="disc.txt"):
    p = tmp_path / name
    p.write_text("\n".join([str(len(ports))] + [f"localhost,{port}" for port in ports]) + "\n")
    return str(p)


def make_trained_engine(storage, n=400, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cfg = IndexCfg(index_builder_type="flat", dim=d, metric="l2", train_num=64,
                   index_storage_dir=str(storage))
    idx = Index(cfg, device="cpu")
    idx.add_batch(x, [("doc", i) for i in range(n)], train_async_if_triggered=False)
    idx.train()
    assert wait_until(lambda: idx.get_state() == IndexState.TRAINED
                      and idx.get_idx_data_num()[0] == 0, timeout=60)
    return idx, x


def start_server(storage, engine=None, index_id="obs", tracing_cfg=None, selector=False):
    srv = IndexServer(0, str(storage), device="cpu", tracing_cfg=tracing_cfg)
    if engine is not None:
        srv.indexes[index_id] = engine
        srv._wire_engine(engine)
    port = srv.bind(0)
    threading.Thread(target=srv.start if selector else srv.start_blocking,
                     name=f"obs-server:{port}", daemon=True).start()
    return srv, port


# ------------------------------------------------------------- span rings


def test_span_buffer_bound_and_eviction():
    buf = spans.SpanBuffer(capacity=4, rank=3)
    for i in range(10):
        buf.record("t1" if i % 2 else "t2", f"stage{i}", 100.0 + i, 0.01, window=i)
    assert buf.stats() == {"capacity": 4, "size": 4, "recorded": 10, "evicted": 6}
    kept = buf.snapshot()
    assert [s["extra"]["window"] for s in kept] == [6, 7, 8, 9]
    assert all(s["rank"] == 3 for s in kept)
    assert all(s["trace_id"] == "t1" for s in buf.snapshot("t1"))
    buf.clear()
    assert buf.snapshot() == []


def test_span_buffer_capacity_from_env(monkeypatch):
    monkeypatch.setenv("DFT_TRACE_BUFFER", "7")
    assert spans.SpanBuffer().capacity == 7
    assert TracingCfg.from_env().buffer == 7
    with pytest.raises(ValueError):
        TracingCfg(buffer=0)
    with pytest.raises(ValueError):
        TracingCfg(metrics_port=-1)


def test_span_records_match_jax():
    """The same recording gives the same span dicts in both packages."""
    j, t = jspans.SpanBuffer(capacity=8, rank=1), spans.SpanBuffer(capacity=8, rank=1)
    for buf in (j, t):
        buf.record("a", "server.queue", 1.5, 0.25, window=3, occupancy_rows=7)
        buf.record("b", "engine.launch", 2.0, 0.5)
    assert t.snapshot() == j.snapshot() and t.stats() == j.stats()


def test_merge_timelines_dedupes_and_sorts_as_jax():
    a = {"trace_id": "t", "name": "x", "start_s": 2.0, "dur_s": 0.1, "rank": 0}
    b = {"trace_id": "t", "name": "y", "start_s": 1.0, "dur_s": 0.2}
    c = {"trace_id": "t", "name": "z", "start_s": 1.0, "dur_s": 0.5}
    merged = spans.merge_timelines([a, b], [dict(a), c], None)
    assert merged == [c, b, a]
    assert merged == jspans.merge_timelines([a, b], [dict(a), c], None)


def test_sampling_rate_knob(monkeypatch):
    monkeypatch.delenv("DFT_TRACE_SAMPLE", raising=False)
    assert spans.maybe_sample() is None
    monkeypatch.setenv("DFT_TRACE_SAMPLE", "1")
    tid = spans.maybe_sample()
    assert isinstance(tid, str) and len(tid) == 16
    monkeypatch.setenv("DFT_TRACE_SAMPLE", "0")
    assert spans.maybe_sample() is None
    monkeypatch.setenv("DFT_TRACE_SAMPLE", "0.5")
    drawn = [spans.maybe_sample() for _ in range(400)]
    assert 100 < sum(d is not None for d in drawn) < 300


def test_new_modules_are_in_the_isolation_walk():
    """The modules this slice adds are reached by the package walk that
    tests/test_torch_isolation.py imports without jax."""
    names = {m.name for m in pkgutil.walk_packages(distributed_faiss_tpu_torch.__path__,
                                                    "distributed_faiss_tpu_torch.")}
    for mod in ("observability", "observability.spans", "observability.export",
                "observability.dfstat", "scripts", "scripts.server_launcher",
                "scripts.load_data"):
        assert f"distributed_faiss_tpu_torch.{mod}" in names
        importlib.import_module(f"distributed_faiss_tpu_torch.{mod}")


def test_window_launch_span_in_every_sampled_request(tmp_path):
    """Two sampled requests and an unsampled one merged into one window:
    each sampled request gets the window's queue, device and launch spans
    (the JAX engine gives the launch span to the first one only), the
    unsampled one none, and the first sampled id is the exemplar of the
    engine's device_search_s."""
    from distributed_faiss_tpu_torch.serving.scheduler import SearchScheduler
    from distributed_faiss_tpu_torch.utils.config import SchedulerCfg

    idx, x = make_trained_engine(tmp_path / "s")
    buf = spans.SpanBuffer(capacity=64, rank=0)
    idx.span_buffer = buf
    sched = SearchScheduler(
        lambda iid, q, k, emb: idx.search_batched(q, top_k=k, return_embeddings=emb),
        SchedulerCfg(max_wait_ms=300, max_batch_rows=1000), span_buffer=buf)
    try:
        reqs = [sched.submit_async("obs", x[2 * i:2 * i + 2], 3, trace_id=tid)
                for i, tid in enumerate(("ta", None, "tb"))]
        assert all(r.event.wait(30) for r in reqs)
        assert all(r.error is None for r in reqs)
    finally:
        sched.stop()
    for tid in ("ta", "tb"):
        got = {s["name"]: s for s in buf.snapshot(tid)}
        assert set(got) == {"server.queue", "server.device", "engine.launch"}
        assert got["server.queue"]["extra"]["occupancy_requests"] == 3
        assert got["engine.launch"]["extra"]["rows"] == 6
    assert {s["trace_id"] for s in buf.snapshot()} == {"ta", "tb"}
    assert list(idx.perf_stats(raw=True)["device_search_s"]["exemplars"].values()) == ["ta"]
    assert spans.current_trace() is None and spans.current_window_traces() == ()


# ------------------------------------------------------ prometheus export


def _stats_tree(stats_cls):
    stats = stats_cls()
    for v in (2e-6, 5e-6, 3e-3, 0.2, 7.0):
        stats.record("queue_wait_s", v, exemplar="abc" if v > 1 else None)
    return {"scheduler": {"counters": {"queued": 3, "shed_deadline": 1}},
            "ops": stats.summary(raw=True),
            "rpc": {"in_flight": 0, "wire": "binary", "client": {"mux": True}},
            "replication": {"shard_group": None, "note": "skipped",
                            "last_transfer": {"ntotal": 5, "source": "h:1", "seconds": 0.5}},
            "process": {"peak_rss_mb": 12.5}, "flag": True, "none": None}


@pytest.mark.parametrize("labels", [None, {"rank": 2}])
def test_render_prometheus_equals_jax(labels):
    """The same tree renders to the same text in both packages: histograms
    over the same le bounds, gauges by path, strings and None skipped."""
    text = export.render_prometheus(_stats_tree(LatencyStats), labels=labels)
    assert text == jexport.render_prometheus(_stats_tree(JStats), labels=labels)
    lines = text.splitlines()
    lab = '{rank="2"}' if labels else ""
    assert f"dft_scheduler_counters_queued{lab} 3" in lines
    assert f"dft_ops_queue_wait_s_count{lab} 5" in lines
    b = [ln for ln in lines if "dft_ops_queue_wait_s_bucket" in ln]
    assert len(b) == len(bucket_bounds()) + 1
    le_2u = [ln for ln in b if f'le="{bucket_bounds()[3]:.6g}"' in ln]
    assert le_2u and le_2u[0].endswith(" 1")
    assert [ln for ln in b if 'le="+Inf"' in ln][0].endswith(" 5")
    assert "shard_group" not in text and "note" not in text and "source" not in text
    assert "exemplar" not in text and "_wire" not in text and "dft_none" not in text


def test_server_stats_tree_renders_as_jax(tmp_path):
    """A live port rank's raw stats tree, with every value the JAX tree
    lacks, renders to the JAX renderer's text."""
    idx, x = make_trained_engine(tmp_path / "s")
    srv, port = start_server(tmp_path, engine=idx)
    try:
        client = rpc.Client(0, "localhost", port)
        client.generic_fun("search", ("obs", x[:3], 4), trace_id=spans.mint_trace_id())
        tree = srv.get_perf_stats(raw=True)
        client.close()
        assert tree["tracing"]["recorded"] >= 3 and tree["rpc"]["mux_calls"] == 1
        text = export.render_prometheus(tree, labels={"rank": 0})
        assert text == jexport.render_prometheus(tree, labels={"rank": 0})
        assert 'dft_engine_obs_device_search_s_bucket{le="+Inf",rank="0"} 1' in text
    finally:
        srv.stop()


def test_metrics_exporter_http_lifecycle(tmp_path):
    idx, x = make_trained_engine(tmp_path / "s")
    srv, _port = start_server(tmp_path, engine=idx)
    exp = export.MetricsExporter(lambda: srv.get_perf_stats(raw=True), port=0, rank=0).start()
    try:
        idx.search_batched(x[:2], 3)
        body = urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/metrics",
                                      timeout=10).read().decode()
        assert 'dft_engine_obs_device_search_s_count{rank="0"} 1' in body
        assert "dft_tracing_capacity" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{exp.port}/other", timeout=10)
    finally:
        exp.stop()
        srv.stop()
    assert not exp._thread.is_alive()


def test_server_metrics_listener_from_cfg_and_env(tmp_path, monkeypatch):
    """Base + rank, started when the socket binds, reported under
    "tracing", stopped by stop(); DFT_METRICS_PORT reaches it through
    TracingCfg.from_env."""
    base = free_port()
    srv, _port = start_server(tmp_path, tracing_cfg=TracingCfg(metrics_port=base))
    try:
        assert srv._metrics is not None and srv._metrics.port == base
        body = urllib.request.urlopen(f"http://127.0.0.1:{base}/metrics",
                                      timeout=10).read().decode()
        assert 'dft_rpc_workers{rank="0"}' in body
        assert srv.get_perf_stats()["tracing"]["metrics_port"] == base
    finally:
        srv.stop()
    assert srv._metrics is None
    base = free_port()
    monkeypatch.setenv("DFT_METRICS_PORT", str(base))
    srv, _port = start_server(tmp_path / "env")
    try:
        assert srv.get_perf_stats()["tracing"]["metrics_port"] == base
    finally:
        srv.stop()


def test_metrics_bind_failure_only_logs(tmp_path, caplog):
    """A taken metrics port degrades to a warning; the rank serves."""
    taken = socket.socket()
    taken.bind(("", 0))
    taken.listen(1)
    base = taken.getsockname()[1]
    try:
        with caplog.at_level(logging.WARNING):
            srv, port = start_server(tmp_path, tracing_cfg=TracingCfg(metrics_port=base))
        try:
            assert srv._metrics is None
            assert "failed to bind" in caplog.text
            client = rpc.Client(0, "localhost", port)
            assert client.get_rank() == 0
            assert client.get_perf_stats()["tracing"]["metrics_port"] == 0
            client.close()
        finally:
            srv.stop()
    finally:
        taken.close()


# ------------------------------------------------------ frames and wire


class _LegacyServer:
    """A peer that answers untagged and in order, and reads only
    payload[:3] of a CALL."""

    def __init__(self):
        self._lsock = socket.socket()
        self._lsock.bind(("", 0))
        self._lsock.listen(5)
        self.port = self._lsock.getsockname()[1]
        self.metas = []
        threading.Thread(target=self._loop, name="legacy-server", daemon=True).start()

    def _loop(self):
        try:
            conn, _ = self._lsock.accept()
            while True:
                kind, payload = rpc.recv_frame(conn)
                if kind != rpc.KIND_CALL:
                    return
                self.metas.append(payload[3] if len(payload) > 3 else None)
                rpc.send_frame(conn, rpc.KIND_RESULT, f"legacy:{payload[0]}")
        except (OSError, EOFError):
            pass


def test_traced_mux_client_vs_legacy_server():
    srv = _LegacyServer()
    client = rpc.Client(0, "localhost", srv.port, mux=True)
    tid = spans.mint_trace_id()
    assert client.generic_fun("ping", trace_id=tid) == "legacy:ping"
    meta = srv.metas[0]
    assert meta["trace_id"] == tid and "req_id" in meta
    local = spans.local_buffer().snapshot(tid)
    assert {s["name"] for s in local} == {"client.pack", "client.rpc"}
    assert client.stats.summary()["round_trip_s"]["p99_exemplar"] == tid
    client.close()


def _capture_frames(make_client, calls):
    """The CALL frames ``make_client(port)`` sends for ``calls`` (name,
    args, trace_id) to a listener that answers each with RESULT None."""
    lsock = socket.socket()
    lsock.bind(("", 0))
    lsock.listen(1)
    got = []

    def serve():
        conn, _ = lsock.accept()
        reader = rpc.FrameReader(conn, bufsize=0)
        try:
            for _ in calls:
                buf = bytes(reader._take(rpc._HDR.size))
                _m, _k, skel_len, _narr = rpc._HDR.unpack(buf)
                got.append(buf + bytes(reader._take(skel_len)))
                rpc.send_frame(conn, rpc.KIND_RESULT, None)
        finally:
            conn.close()

    t = threading.Thread(target=serve, name="frame-capture", daemon=True)
    t.start()
    client = make_client(lsock.getsockname()[1])
    for name, args, tid in calls:
        assert client.generic_fun(name, args, trace_id=tid) is None
    client.close()
    t.join(timeout=10)
    lsock.close()
    assert not t.is_alive()
    return got


def test_serial_frames_byte_identical_to_jax(monkeypatch):
    """The serial client's CALL frames, untraced (sampling off) and
    traced, are the JAX serial client's bytes for the same calls."""
    monkeypatch.setenv("DFT_TRACE_SAMPLE", "0")
    tid = "0123456789abcdef"
    calls = [("get_rank", (), spans.maybe_sample()), ("get_state", ("idx",), None),
             ("get_rank", (), tid), ("set_nprobe", ("idx", 8), tid)]
    port_frames = _capture_frames(lambda p: rpc.Client(0, "localhost", p, mux=False), calls)
    jax_frames = _capture_frames(lambda p: jrpc.Client(0, "localhost", p, mux=False), calls)
    assert port_frames == jax_frames
    assert port_frames[0] == b"".join(bytes(p) for p in rpc.pack_frame(
        rpc.KIND_CALL, ("get_rank", (), {})))
    assert port_frames[2] == b"".join(bytes(p) for p in rpc.pack_frame(
        rpc.KIND_CALL, ("get_rank", (), {}, {"trace_id": tid})))


def test_mux_env_switch(monkeypatch):
    srv = _LegacyServer()
    monkeypatch.setenv("DFT_RPC_MUX", "0")
    client = rpc.Client(0, "localhost", srv.port)
    assert client.rpc_stats()["mux"] is False and client._reader is None
    assert client.ping() == "legacy:ping"
    assert srv.metas == [None]  # no meta element at all
    client.close()
    monkeypatch.setenv("DFT_RPC_MUX", "1")
    assert rpc.mux_enabled_by_env() is True


@pytest.mark.parametrize("selector", [False, True])
def test_traced_serial_client_vs_traced_server(tmp_path, selector):
    """A serial stub with a trace: the server records queue, device, launch
    and, after its send, write spans. The write span lands after the client
    has its answer, so it is polled for."""
    idx, x = make_trained_engine(tmp_path / "s")
    srv, port = start_server(tmp_path, engine=idx, selector=selector)
    try:
        client = rpc.Client(1, "localhost", port, mux=False)
        tid = spans.mint_trace_id()
        client.generic_fun("search", ("obs", x[:3], 4), trace_id=tid)
        assert wait_until(lambda: set(STAGES) <= {s["name"] for s in srv.spans.snapshot(tid)})
        names = {s["name"] for s in srv.get_trace_spans(tid)}
        assert "engine.launch" in names
        assert srv.get_perf_stats()["rpc"]["legacy_calls"] == 1
        client.close()
    finally:
        srv.stop()


def test_no_meta_legacy_frames_still_served(tmp_path):
    idx, _x = make_trained_engine(tmp_path / "s")
    srv, port = start_server(tmp_path, engine=idx)
    try:
        sock = socket.create_connection(("localhost", port), timeout=10)
        rpc.send_frame(sock, rpc.KIND_CALL, ("get_rank", (), {}))
        assert rpc.recv_frame(sock) == (rpc.KIND_RESULT, 0)
        rpc.send_frame(sock, rpc.KIND_CLOSE, None)
        sock.close()
    finally:
        srv.stop()


# ------------------------------------------- loopback cluster end to end


@pytest.fixture
def cluster(tmp_path, monkeypatch):
    """Two port ranks serving one replica group (R=2), each behind a
    ChaosProxy so a test can kill one crash-shaped, and a client that
    traces every request."""
    monkeypatch.setenv("DFT_TRACE_SAMPLE", "1")
    idx_a, x = make_trained_engine(tmp_path / "a", seed=1)
    idx_b, _ = make_trained_engine(tmp_path / "b", seed=1)
    srv_a, port_a = start_server(tmp_path / "a", engine=idx_a)
    srv_b, port_b = start_server(tmp_path / "b", engine=idx_b)
    proxies = (ChaosProxy("127.0.0.1", port_a).start(), ChaosProxy("127.0.0.1", port_b).start())
    disc = write_discovery(tmp_path, [p.port for p in proxies])
    client = IndexClient(disc, replication_cfg=ReplicationCfg(replication=2, write_quorum=1))
    client.cfg = idx_a.cfg
    for stub in client.sub_indexes:
        stub.RECONNECT_TIMEOUT = 0.3  # dead-rank drills fail fast
    yield {"client": client, "servers": (srv_a, srv_b), "proxies": proxies,
           "ports": tuple(p.port for p in proxies), "disc": disc, "x": x}
    client.close()
    for p in proxies:
        p.stop()
    srv_a.stop()
    srv_b.stop()


def _timeline(client, tid):
    """The merged timeline once the server's write span has landed."""
    assert wait_until(lambda: "server.write" in {s["name"] for s in
                                                 client.get_trace_spans(tid)})
    return client.get_trace_spans(tid)


def test_trace_end_to_end_accounts_for_latency(cluster):
    client, x = cluster["client"], cluster["x"]
    tid = spans.mint_trace_id()
    client.search(x[:4], 5, "obs", trace_id=tid)
    timeline = _timeline(client, tid)
    by = {}
    for s in timeline:
        by.setdefault(s["name"], []).append(s)
    for required in ("client.search", "client.pack", "client.rpc", "engine.launch") + STAGES:
        assert required in by, (required, sorted(by))
    e2e = by["client.search"][0]["dur_s"]
    rpc_dur = max(s["dur_s"] for s in by["client.rpc"])
    stage_sum = sum(max(s["dur_s"] for s in by[n]) for n in STAGES)
    assert stage_sum <= rpc_dur + 1e-3
    assert rpc_dur <= e2e + 1e-3
    assert e2e - stage_sum < max(0.5, 0.5 * e2e)
    q, d, w = (by[n][0]["start_s"] for n in STAGES)
    assert q <= d <= w
    assert by["server.queue"][0]["extra"]["occupancy_rows"] >= 4
    # the engine's launch sits inside the scheduler's device window
    launch, device = by["engine.launch"][0], by["server.device"][0]
    assert launch["dur_s"] <= device["dur_s"] + 1e-6
    assert launch["extra"]["rows"] >= 4


def test_trace_survives_rank_failover(cluster):
    client, x = cluster["client"], cluster["x"]
    client.search(x[:2], 3, "obs")  # pins a preferred replica
    with client._lock:
        victim = dict(client._preferred).get(0, 0)
    cluster["proxies"][victim].stop()  # crash-shaped: torn and refusing
    tid = spans.mint_trace_id()
    out = client.search(x[:4], 5, "obs", trace_id=tid)
    assert out[0].shape == (4, 5)
    timeline = _timeline(client, tid)
    hop = next(s for s in timeline if s["name"] == "client.failover")
    assert hop["extra"]["replica"] == client.sub_indexes[victim].id
    assert "server.device" in {s["name"] for s in timeline}


def test_exemplar_yields_fetchable_trace(cluster):
    client, x = cluster["client"], cluster["x"]
    for _ in range(4):
        client.search(x[:2], 3, "obs")
    exemplar = None
    for entry in client.get_perf_stats():
        exemplar = (entry.get("scheduler", {}).get("queues", {}).get("e2e_s", {})
                    .get("p99_exemplar")) or exemplar
    assert exemplar is not None
    assert any(s["name"] == "server.device" for s in client.get_trace_spans(exemplar))


def test_perf_stats_degrades_per_dead_rank(cluster):
    client = cluster["client"]
    cluster["proxies"][1].stop()
    stats = client.get_perf_stats()
    assert len(stats) == 2
    assert "error" not in stats[0] and "scheduler" in stats[0]
    assert stats[0]["rpc"]["client"]["mux"] is True
    assert "error" in stats[1] and stats[1]["port"] == cluster["ports"][1]
    assert stats[1]["rpc"]["client"]["in_flight"] == 0


def test_dfstat_stats_and_trace_views(cluster):
    client, x, disc = cluster["client"], cluster["x"], cluster["disc"]
    tid = spans.mint_trace_id()
    client.search(x[:4], 5, "obs", trace_id=tid)
    _timeline(client, tid)

    out = io.StringIO()
    assert dfstat.main(["--discovery", disc, "--count", "2", "--interval", "0.2"],
                       out=out) == 0
    text = out.getvalue()
    assert "rank" in text and "srch/s" in text and "DEAD" not in text

    out = io.StringIO()
    assert dfstat.main(["--discovery", disc, "--count", "1", "--json"], out=out) == 0
    doc = json.loads(out.getvalue())
    assert len(doc["ranks"]) == 2
    assert all("search_p99_ms" in r for r in doc["ranks"])

    out = io.StringIO()
    assert dfstat.main(["--discovery", disc, "--trace", tid], out=out) == 0
    trace_text = out.getvalue()
    assert tid in trace_text
    for stage in STAGES + ("engine.launch",):
        assert stage in trace_text
    out = io.StringIO()
    assert dfstat.main(["--discovery", disc, "--trace", "deadbeef" * 2], out=out) == 1
    assert "no spans" in out.getvalue()

    cluster["proxies"][0].stop()
    out = io.StringIO()
    assert dfstat.main(["--discovery", disc, "--count", "1"], out=out) == 0
    assert "DEAD" in out.getvalue()


def test_dfstat_rate_rows_match_jax(cluster):
    """dfstat's per-rank numbers are the JAX dfstat's for the same polls."""
    from distributed_faiss_tpu.observability import dfstat as jdfstat

    client, x = cluster["client"], cluster["x"]
    stubs = dfstat._connect(cluster["disc"])
    pool = dfstat._fanout_pool(stubs)
    try:
        prev = dfstat.poll(stubs, pool)
        client.search(x[:4], 5, "obs")
        cur = dfstat.poll(stubs, pool)
        for p, c in zip(prev, cur):
            assert dfstat._rate_row(p, c, 0.5) == jdfstat._rate_row(p, c, 0.5)
        assert dfstat.render_stats(prev, cur, 0.5, True) == \
            jdfstat.render_stats(prev, cur, 0.5, True)
    finally:
        pool.shutdown(wait=False)
        for _h, _p, stub in stubs:
            stub.close()


def test_dfstat_redials_rank_that_came_back(tmp_path):
    port = free_port()
    disc = write_discovery(tmp_path, [port])
    entries = dfstat._connect(disc, connect_timeout=0.2)
    pool = dfstat._fanout_pool(entries)
    assert entries[0][2] is None
    assert "error" in dfstat.poll(entries, pool)[0]
    srv = IndexServer(0, str(tmp_path), device="cpu")
    srv.bind(port)
    threading.Thread(target=srv.start_blocking, name=f"obs-server:{port}", daemon=True).start()
    try:
        cur = dfstat.poll(entries, pool)[0]
        assert "error" not in cur and "rpc" in cur
    finally:
        pool.shutdown(wait=False)
        entries[0][2].close()
        srv.stop()
