"""RPC multiplexing of the port: pipelined, out-of-order calls per
connection (the port of tests/test_rpc_mux.py on ``device="cpu"``).

Held elsewhere and not repeated here: the pipelined out-of-order demux
of tagged responses by req_id is
``test_torch_wire.py::test_mux_out_of_order_tagged_binary_responses``
(on binary frames). The cases below: a mux client against an untagged
in-order server degrades to FIFO attribution; a no-meta legacy client is
served unchanged by a mux server; a fast call completes while a slow
scheduled search on the same stub is still running; a single
IndexClient's in-flight window reaches the serving scheduler as merged
device batches with byte-identical results, in both serving loops;
close() and a torn connection fail every in-flight call (no hang) and
the demux thread exits; a per-call timeout abandons only its own slot;
and (slow, as in JAX) a rank SIGKILLed with a mux window in flight.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.utils import racecheck

from distributed_faiss_tpu_torch import (
    Index,
    IndexCfg,
    IndexClient,
    IndexServer,
    IndexState,
    SchedulerCfg,
)
from distributed_faiss_tpu_torch.parallel import rpc

pytestmark = pytest.mark.rpcmux

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_listening(port, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            socket.create_connection(("localhost", port), timeout=1).close()
            return True
        except OSError:
            time.sleep(0.05)
    return False


def write_discovery(tmp_path, ports, name="disc.txt"):
    p = tmp_path / name
    p.write_text("\n".join(
        [str(len(ports))] + [f"localhost,{port}" for port in ports]) + "\n")
    return str(p)


def flat_cfg(dim=16):
    return IndexCfg(index_builder_type="flat", dim=dim, metric="l2",
                    train_num=64)


def make_trained_engine(storage, n=600, d=16, seed=0):
    """An in-process trained engine Index (injected into servers so RPC
    tests don't pay the over-the-wire ingest)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    meta = [("doc", i) for i in range(n)]
    cfg = flat_cfg(d)
    cfg.index_storage_dir = str(storage)
    idx = Index(cfg, device="cpu")
    idx.add_batch(x, meta, train_async_if_triggered=False)
    idx.train()
    deadline = time.time() + 60
    while idx.get_state() != IndexState.TRAINED:
        assert time.time() < deadline, "train timed out"
        time.sleep(0.05)
    while idx.get_idx_data_num()[0] > 0:
        assert time.time() < deadline, "add drain timed out"
        time.sleep(0.05)
    queries = [rng.standard_normal((4, d)).astype(np.float32)
               for _ in range(8)]
    return idx, queries


def start_server(storage, mode, sched_cfg=None, engine=None,
                 index_id="mux"):
    port = free_port()
    srv = IndexServer(0, str(storage), scheduler_cfg=sched_cfg, device="cpu")
    if engine is not None:
        srv.indexes[index_id] = engine
    target = srv.start_blocking if mode == "blocking" else srv.start
    threading.Thread(target=target, args=(port,), daemon=True).start()
    assert wait_listening(port)
    return srv, port


class _LegacyServer:
    """The pre-mux serve loop: one frame at a time, in order, untagged
    responses, meta element ignored. Records max concurrently-received-
    but-unanswered depth (always 1 here: it cannot pipeline)."""

    def __init__(self):
        self.calls = 0
        self.port = free_port()
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("", self.port))
        self._lsock.listen(5)
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        try:
            while True:
                conn, _ = self._lsock.accept()
                threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True).start()
        except OSError:
            pass

    def _serve(self, conn):
        try:
            while True:
                kind, payload = rpc.recv_frame(conn)
                if kind == rpc.KIND_CLOSE:
                    break
                fname, args, kwargs = payload[:3]
                self.calls += 1
                rpc.send_frame(conn, rpc.KIND_RESULT, ("echo", args))
        except (EOFError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        self._lsock.close()


def test_mux_client_against_legacy_server_degrades_to_fifo():
    """Interop direction 1: a mux client against an untagged in-order
    server. The demux attributes untagged responses FIFO (exact, because
    a legacy server answers one frame at a time in order) — every one of
    6 threads x 10 pipelined calls gets ITS OWN result back."""
    srv = _LegacyServer()
    c = rpc.Client(0, "localhost", srv.port)
    assert c._mux
    bad = []

    def worker(i):
        for j in range(10):
            got = c.generic_fun("echo", ((i, j),))
            if got != ("echo", ((i, j),)):
                bad.append((i, j, got))  # pragma: no cover

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not bad, bad[:3]
    assert srv.calls == 60
    c.close()
    srv.close()


def test_legacy_no_meta_client_against_mux_server(tmp_path):
    """Interop direction 2: a no-meta legacy peer against a mux server.
    Raw 3-tuple frames (no meta element at all) must be served on the
    unchanged synchronous path with untagged responses, and a serial
    (DFT_RPC_MUX=0) Client must round-trip fully."""
    srv, port = start_server(tmp_path, "blocking")

    # raw legacy frames, no meta element
    raw = socket.create_connection(("localhost", port))
    rpc.send_frame(raw, rpc.KIND_CALL, ("get_rank", (), {}))
    kind, payload = rpc.recv_frame(raw)
    assert kind == rpc.KIND_RESULT and payload == 0  # untagged response
    rpc.send_frame(raw, rpc.KIND_CLOSE, None)
    raw.close()

    serial = rpc.Client(0, "localhost", port, mux=False)
    assert serial.get_rank() == 0
    assert serial.ping()["rank"] == 0
    serial.close()

    stats = srv.get_perf_stats()["rpc"]
    assert stats["legacy_calls"] >= 3
    assert stats["mux_calls"] == 0
    srv.stop()


# ------------------------------------------------------------- real server


def test_out_of_order_completion_on_real_server(tmp_path):
    """A slow scheduled search and a fast get_rank in flight on the SAME
    stub: the fast call must complete while the search still runs —
    impossible before mux (the stub lock serialized the round trips, the
    server one frame per connection)."""
    engine, queries = make_trained_engine(tmp_path / "shard")
    srv, port = start_server(tmp_path, "blocking",
                             SchedulerCfg(max_wait_ms=1.0), engine)
    orig = engine.search_batched

    def slow_search(*a, **k):
        time.sleep(0.6)
        return orig(*a, **k)

    engine.search_batched = slow_search
    try:
        c = rpc.Client(0, "localhost", port)
        events = []
        search_done = threading.Event()

        def do_search():
            c.generic_fun("search", ("mux", queries[0], 3))
            events.append("search")
            search_done.set()

        t = threading.Thread(target=do_search)
        t.start()
        time.sleep(0.2)  # search is in flight on the wire
        assert c.generic_fun("get_rank", ()) == 0
        events.append("get_rank")
        assert not search_done.is_set()  # answered while search in flight
        t.join()
        assert events == ["get_rank", "search"]
        c.close()
    finally:
        engine.search_batched = orig
    srv.stop()


@pytest.mark.parametrize("mode", ["blocking", "selector"])
def test_single_client_window_coalesces_with_identical_results(
        tmp_path, mode):
    """The acceptance case, in both serving loops: 8 concurrent callers
    through ONE IndexClient (one stub, one connection) are byte-identical
    to sequential serving, AND their in-flight window reaches the
    scheduler as merged device batches (batch_requests > 1 from a single
    client — impossible pre-mux)."""
    engine, queries = make_trained_engine(tmp_path / "shard")
    srv, port = start_server(tmp_path, mode,
                             SchedulerCfg(max_wait_ms=25.0), engine)
    disc = write_discovery(tmp_path, [port])
    client = IndexClient(disc)
    client.cfg = flat_cfg()

    golden = [client.search(q, 3, "mux") for q in queries]
    srv.scheduler.stats.reset()  # only count the concurrent storm below

    results = {}
    errors = []
    barrier = threading.Barrier(8)

    def caller(tid):
        try:
            barrier.wait()
            out = []
            for _ in range(5):
                out.append(client.search(queries[tid], 3, "mux"))
            results[tid] = out
        except Exception as e:  # pragma: no cover
            errors.append((tid, e))

    ts = [threading.Thread(target=caller, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors[:2]
    for tid in range(8):
        g_scores, g_meta = golden[tid]
        assert len(results[tid]) == 5
        for scores, meta in results[tid]:
            assert scores.dtype == g_scores.dtype
            np.testing.assert_array_equal(scores, g_scores)
            assert meta == g_meta

    sched = srv.get_perf_stats()["scheduler"]
    merged_max = sched["queues"]["batch_requests"]["max_s"]
    assert merged_max > 1, (
        f"single client's window never merged (max batch_requests="
        f"{merged_max})")

    # the observability satellite: per-stub client-side view rides the
    # same get_perf_stats surface
    stats = client.get_perf_stats()
    view = stats[0]["rpc"]["client"]
    assert view["mux"] is True
    assert view["in_flight_peak"] > 1
    assert view["round_trip_s"]["count"] >= 40
    assert "p99_s" in view["round_trip_s"]
    client.close()
    srv.stop()


def test_close_with_calls_in_flight_unblocks_and_demux_exits(tmp_path):
    """close() with a call still in flight: the caller is failed promptly
    (no hang) and the demux reader thread exits cleanly."""
    engine, queries = make_trained_engine(tmp_path / "shard")
    srv, port = start_server(tmp_path, "blocking",
                             SchedulerCfg(max_wait_ms=1.0), engine)
    orig = engine.search_batched

    def slow_search(*a, **k):
        time.sleep(1.0)
        return orig(*a, **k)

    engine.search_batched = slow_search
    try:
        c = rpc.Client(0, "localhost", port)
        outcome = []

        def do_search():
            try:
                outcome.append(("ok", c.generic_fun(
                    "search", ("mux", queries[0], 3))))
            except Exception as e:
                outcome.append(("err", e))

        t = threading.Thread(target=do_search)
        t.start()
        time.sleep(0.2)  # call is on the wire
        reader = c._reader
        t0 = time.time()
        c.close()
        t.join(timeout=5.0)
        assert not t.is_alive(), "in-flight caller hung through close()"
        assert time.time() - t0 < 5.0
        assert outcome and outcome[0][0] == "err"
        assert not reader.is_alive(), "demux thread survived close()"
        # close is terminal: no redial
        with pytest.raises(RuntimeError):
            c.generic_fun("get_rank", ())
    finally:
        engine.search_batched = orig
    srv.stop()


def test_percall_timeout_on_tagged_peer_abandons_only_that_call():
    """A per-call timeout against a peer that is demonstrably alive
    (tagged responses still flowing) abandons ONLY the timed-out slot:
    other in-flight calls complete, the connection survives, and the
    late response is dropped by req_id instead of misrouted."""
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("", 0))
    lsock.listen(5)
    port = lsock.getsockname()[1]

    def serve():
        try:
            conn, _ = lsock.accept()
            frames = [rpc.recv_frame(conn)[1] for _ in range(2)]
            by_name = {f[0]: f[3]["req_id"] for f in frames}
            # answer the companion call, never the one that will time out
            rpc.send_parts(conn, rpc.pack_tagged_response(
                rpc.KIND_RESULT, "companion-ok", by_name["companion"]))
            # the connection must still serve AFTER the timeout
            kind, payload = rpc.recv_frame(conn)
            rpc.send_parts(conn, rpc.pack_tagged_response(
                rpc.KIND_RESULT, "after-ok", payload[3]["req_id"]))
        except (EOFError, OSError):
            pass

    threading.Thread(target=serve, daemon=True).start()
    c = rpc.Client(0, "localhost", port)
    outcomes = {}

    def doomed():
        try:
            outcomes["doomed"] = c.generic_fun("doomed", (), timeout=0.8)
        except OSError as e:  # socket.timeout
            outcomes["doomed"] = e

    def companion():
        time.sleep(0.1)  # send after doomed, so its response proves life
        outcomes["companion"] = c.generic_fun("companion", ())

    ts = [threading.Thread(target=doomed), threading.Thread(target=companion)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=5.0)
        assert not t.is_alive()
    assert isinstance(outcomes["doomed"], OSError)
    assert outcomes["companion"] == "companion-ok"  # NOT collaterally failed
    # same connection, no redial: the window survived the timeout
    with racecheck.peeking():  # white-box peek, reviewed
        assert not c._closed
    assert c.generic_fun("after", ()) == "after-ok"
    c.close()
    lsock.close()


def test_transport_failure_fails_all_inflight_calls():
    """A torn connection fails EVERY in-flight call with a TRANSPORT
    error (so retry/reroute/partial-search machinery sees the rank as
    dead), and the stub redials cleanly on the next call."""
    # script a server that answers nothing, then dies mid-window
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("", 0))
    lsock.listen(5)
    port = lsock.getsockname()[1]
    conns = []

    def accept_loop():
        try:
            while True:
                conn, _ = lsock.accept()
                conns.append(conn)
        except OSError:
            pass

    threading.Thread(target=accept_loop, daemon=True).start()
    c = rpc.Client(0, "localhost", port)
    errs = []

    def call(i):
        try:
            c.generic_fun("never_answered", (i,))
        except rpc.TRANSPORT_ERRORS as e:
            errs.append(e)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(5)]
    for t in ts:
        t.start()
    deadline = time.time() + 5
    while len(c._pending) < 5 and time.time() < deadline:
        time.sleep(0.01)
    assert len(c._pending) == 5  # the whole window is in flight
    for conn in conns:
        conn.close()  # RST/EOF mid-window
    for t in ts:
        t.join(timeout=5.0)
        assert not t.is_alive(), "caller hung past connection teardown"
    assert len(errs) == 5  # every caller saw a transport error
    lsock.close()
    c.close()


@pytest.mark.slow
def test_sigkill_with_mux_window_bounded_and_reroutes(tmp_path):
    """Chaos interplay: SIGKILL a rank while W mux calls are in flight on
    one stub — every caller gets a transport error within the deadline
    bound (no hang), ingest reroutes to the surviving rank (acked batches
    never lost), and the demux threads shut down cleanly on close()."""
    from distributed_faiss_tpu_torch.testing.chaos import ServerHarness

    index_id = "chaos_mux"
    disc = str(tmp_path / "disc.txt")
    harness = ServerHarness(2, disc, str(tmp_path / "storage"),
                            base_port=free_port(), env={"PYTHONPATH": REPO_ROOT},
                            device="cpu")
    with harness:
        client = IndexClient(disc)
        client.create_index(index_id, flat_cfg())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((600, 16)).astype(np.float32)
        meta = [("doc", i) for i in range(600)]
        for s in range(0, 600, 100):
            client.add_index_data(index_id, x[s:s + 100], meta[s:s + 100])
        client.sync_train(index_id)
        deadline = time.time() + 60
        while client.get_state(index_id) != IndexState.TRAINED:
            assert time.time() < deadline, "train timed out"
            time.sleep(0.1)
        q = rng.standard_normal((4, 16)).astype(np.float32)

        # ranks register in the discovery file in racy order: pin the
        # storm to the stub actually wired to the rank we will SIGKILL
        stub = next(s for s in client.sub_indexes
                    if s.port == harness.port(0))
        stop = threading.Event()
        outcomes = []

        def storm(tid):
            while not stop.is_set():
                t0 = time.time()
                try:
                    stub.generic_fun("search", (index_id, q, 3),
                                     timeout=5.0)
                except rpc.RETRYABLE_ERRORS as e:
                    # transport classified AND bounded: no caller waits
                    # past its own timeout + teardown slack
                    outcomes.append(("err", time.time() - t0, e))
                    time.sleep(0.05)
                else:
                    outcomes.append(("ok", time.time() - t0, None))

        ts = [threading.Thread(target=storm, args=(t,)) for t in range(6)]
        for t in ts:
            t.start()
        time.sleep(0.8)   # storm the live rank with a full window
        harness.kill(0)   # SIGKILL with W calls in flight
        time.sleep(1.5)   # storm the corpse: failures must stay bounded
        stop.set()
        for t in ts:
            t.join(timeout=15.0)
            assert not t.is_alive(), "storm caller hung after SIGKILL"
        errs = [o for o in outcomes if o[0] == "err"]
        assert errs, "SIGKILL produced no transport errors?"
        assert max(o[1] for o in outcomes) < 8.0  # timeout + slack, no hang

        # retry/reroute still works: ingest lands on the surviving rank
        before = len(client.reroutes)
        client.add_index_data(index_id, x[:50], meta[:50])
        assert len(client.reroutes) >= before  # acked by SOME rank

        readers = [s._reader for s in client.sub_indexes
                   if s._reader is not None]
        client.close()
        for r in readers:
            r.join(timeout=5.0)
            assert not r.is_alive(), "demux thread survived close()"
