"""The port's two serving loops on the CPU: thread-per-connection
(``start_blocking``) and the selector loop (``start``), each answering the
multiplexed and the serial client. Eight concurrent clients get results
byte-identical to the engine's own in all four arms; the selector loop
serves hand-rolled 3-tuple frames, pipelined frames already buffered in a
connection's reader, and drops a malformed connection without stopping."""

import pickle
import socket
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.parallel import rpc as jrpc
from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

D, N, CLIENTS, REQUESTS, ROWS, K = 16, 2000, 8, 4, 10, 5


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cfg = IndexCfg(index_builder_type="ivfsq", dim=D, metric="l2", train_num=500,
                   centroids=8, nprobe=8, pallas_flat=True,
                   index_storage_dir=str(tmp_path_factory.mktemp("sel")))
    idx = Index(cfg, device="cpu")
    idx.add_batch(x, [(i, f"m{i}") for i in range(N)], train_async_if_triggered=False)
    deadline = time.monotonic() + 60
    while not (idx.get_state() == IndexState.TRAINED and idx.get_idx_data_num() == (0, N)):
        assert time.monotonic() < deadline, "train/drain timed out"
        time.sleep(0.02)
    q = x[:CLIENTS * REQUESTS * ROWS] + 0.01 * rng.standard_normal(
        (CLIENTS * REQUESTS * ROWS, D)).astype(np.float32)
    yield idx, q
    idx.retire()


def serve(tmp_path, engine_obj, selector: bool):
    srv = IndexServer(0, str(tmp_path), device="cpu")
    srv.indexes["sel"] = engine_obj
    srv._wire_engine(engine_obj)
    port = srv.bind(0)
    t = threading.Thread(target=srv.start if selector else srv.start_blocking,
                         name=f"sel-server:{port}", daemon=True)
    t.start()
    return srv, port, t


@pytest.mark.parametrize("selector", [False, True], ids=["threaded", "selector"])
@pytest.mark.parametrize("mux", [True, False], ids=["mux", "serial"])
def test_eight_clients_byte_identical(tmp_path, engine, monkeypatch, selector, mux):
    """Each of 8 clients (own IndexClient, own connection) searches its
    query blocks concurrently; every answer is byte for byte the engine's
    own result for that block, whichever loop and client dialect."""
    idx, q = engine
    monkeypatch.setenv("DFT_RPC_MUX", "1" if mux else "0")
    srv, port, thread = serve(tmp_path, idx, selector)
    disc = tmp_path / "disc.txt"
    disc.write_text(f"1\nlocalhost,{port}\n")
    clients = [IndexClient(str(disc)) for _ in range(CLIENTS)]
    for client in clients:
        client.cfg = idx.cfg
    got, errors = {}, []

    def run(c, client):
        try:
            for r in range(REQUESTS):
                b = c * REQUESTS + r
                got[b] = client.search(q[b * ROWS:(b + 1) * ROWS], K, "sel")
        except Exception as e:  # reported on the main thread
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(c, cl), name=f"sel-client-{c}")
                   for c, cl in enumerate(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert all(cl.sub_indexes[0].rpc_stats()["mux"] is mux for cl in clients)
        for b in range(CLIENTS * REQUESTS):
            want_d, want_m, _ = idx.search(q[b * ROWS:(b + 1) * ROWS], K)
            assert pickle.dumps(got[b][0]) == pickle.dumps(want_d)
            assert got[b][1] == want_m
        rpc_stats = srv.get_perf_stats()["rpc"]
        assert rpc_stats["mux_calls" if mux else "legacy_calls"] >= CLIENTS * REQUESTS
        assert rpc_stats["in_flight"] == 0
    finally:
        for cl in clients:
            cl.close()
        srv.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_selector_serves_legacy_three_tuple_frames(tmp_path, engine):
    idx, q = engine
    srv, port, thread = serve(tmp_path, idx, selector=True)
    try:
        sock = socket.create_connection(("localhost", port), timeout=10)
        rpc.send_frame(sock, rpc.KIND_CALL, ("get_rank", (), {}))
        assert rpc.recv_frame(sock) == (rpc.KIND_RESULT, 0)
        rpc.send_frame(sock, rpc.KIND_CALL, ("search", ("sel", q[:3], K), {}))
        kind, (d, m, _e) = rpc.recv_frame(sock)
        want_d, want_m, _ = idx.search(q[:3], K)
        assert kind == rpc.KIND_RESULT and m == want_m
        np.testing.assert_array_equal(d, want_d)
        rpc.send_frame(sock, rpc.KIND_CALL, ("no_such_op", (), {}))
        kind, tb = rpc.recv_frame(sock)
        assert kind == rpc.KIND_ERROR and "no_such_op" in tb
        rpc.send_frame(sock, rpc.KIND_CLOSE, None)
        sock.close()
        assert srv.get_perf_stats()["rpc"]["legacy_calls"] == 3
    finally:
        srv.stop()
        thread.join(timeout=10)


@pytest.mark.parametrize("tagged", [False, True])
def test_selector_drains_frames_buffered_in_the_reader(tmp_path, engine, tagged):
    """Several CALL frames in one write land in one recv: the frames after
    the first wait in the connection's reader, never making the socket
    readable again, and must be served without another send."""
    idx, _q = engine
    srv, port, thread = serve(tmp_path, idx, selector=True)
    try:
        sock = socket.create_connection(("localhost", port), timeout=5)
        frames = []
        for i in range(4):
            call = ("get_rank", (), {}, {"req_id": i}) if tagged else ("get_rank", (), {})
            frames.append(b"".join(bytes(p) for p in rpc.pack_frame(rpc.KIND_CALL, call)))
        sock.sendall(b"".join(frames))
        reader = rpc.FrameReader(sock)
        answers = [reader.recv_frame() for _ in range(4)]
        if tagged:
            assert sorted(a[1][0]["req_id"] for a in answers) == [0, 1, 2, 3]
            assert all(a[0] == rpc.KIND_RESULT_MUX and a[1][1] == 0 for a in answers)
        else:
            assert answers == [(rpc.KIND_RESULT, 0)] * 4
        sock.close()
    finally:
        srv.stop()
        thread.join(timeout=10)


def test_frame_reader_pending_as_jax():
    """``pending`` is True exactly while a next frame's bytes wait in the
    buffer, in both packages' readers."""
    two = b"".join(bytes(p) for p in rpc.pack_frame(rpc.KIND_RESULT, 1)) * 2
    for mod in (rpc, jrpc):
        a, b = socket.socketpair()
        try:
            a.sendall(two)
            reader = mod.FrameReader(b)
            assert reader.pending is False
            assert reader.recv_frame() == (mod.KIND_RESULT, 1)
            assert reader.pending is True
            assert reader.recv_frame() == (mod.KIND_RESULT, 1)
            assert reader.pending is False
        finally:
            a.close()
            b.close()


def test_selector_drops_a_malformed_connection_only(tmp_path, engine):
    idx, _q = engine
    srv, port, thread = serve(tmp_path, idx, selector=True)
    try:
        good = rpc.Client(0, "localhost", port)
        bad = socket.create_connection(("localhost", port), timeout=5)
        bad.sendall(b"NOPE" + bytes(9))
        assert bad.recv(16) == b""  # the loop closed it
        bad.close()
        fresh = rpc.Client(1, "localhost", port)
        assert good.get_rank() == 0 and fresh.get_rank() == 0
        good.close()
        fresh.close()
    finally:
        srv.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
