"""The port's binary wire skeletons (distributed_faiss_tpu_torch/parallel/wire.py
and the negotiation in parallel/rpc.py and parallel/server.py) against the
JAX package's: the same bytes for the same frame (the golden vector of
tests/test_wire.py), round trips of exact types, schema misses that fall
back to pickle per frame, garbage refused as a transport error, and the
per-connection negotiation over loopback, whose results equal those of a
pickle-only connection. The port has one serving loop (thread per
connection) and one client (multiplexed); a peer that never advertises,
such as a serial caller, is answered in pickle."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.parallel import rpc as jrpc
from distributed_faiss_tpu.parallel import wire as jwire
from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.parallel import rpc, wire
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils.config import IndexCfg, SchedulerCfg, WireCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

PICKLE_PROTO4 = b"\x80\x04"  # pickle.dumps(protocol=4) prefix


def frame_bytes(parts) -> bytes:
    return b"".join(bytes(p) for p in parts)


def make_trained_engine(storage, meta_fn=lambda i: (i, i % 4), n=400, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cfg = IndexCfg(index_builder_type="flat", dim=d, metric="l2", train_num=64,
                   index_storage_dir=str(storage))
    idx = Index(cfg, device="cpu")
    idx.add_batch(x, [meta_fn(i) for i in range(n)], train_async_if_triggered=False)
    deadline = time.time() + 60
    while idx.get_state() != IndexState.TRAINED or idx.get_idx_data_num()[0] > 0:
        assert time.time() < deadline, "train/drain timed out"
        time.sleep(0.02)
    queries = [rng.standard_normal((4, d)).astype(np.float32) for _ in range(8)]
    return idx, queries


class Served:
    """A port IndexServer on a loopback port serving ``engine`` as "wire";
    stopped on exit."""

    def __init__(self, storage, engine=None, wire_cfg=None, scheduler_cfg=None):
        self.srv = IndexServer(0, str(storage), device="cpu", wire_cfg=wire_cfg,
                               scheduler_cfg=scheduler_cfg or SchedulerCfg(max_wait_ms=1.0))
        if engine is not None:
            self.srv.indexes["wire"] = engine
        self.port = self.srv.bind(0)
        self.thread = threading.Thread(target=self.srv.start_blocking, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.stop()
        self.thread.join(10)


def client_for(tmp_path, port, cfg, name="disc.txt"):
    p = tmp_path / name
    p.write_text(f"1\nlocalhost,{port}\n")
    client = IndexClient(str(p))
    client.cfg = cfg
    return client


# ------------------------------------------------------------------- codec


def test_binary_call_golden_vector():
    """The CALL skeleton's bytes are the JAX package's, byte for byte (the
    golden vector of tests/test_wire.py), and decode back."""
    q = np.arange(6, dtype=np.float32).reshape(2, 3)
    meta = {"req_id": 9, "deadline_s": 2.0, "trace_id": "ab", "wire": 1}
    skel, arrays = wire.encode_call("search", ("idx", q, 7, True), {}, meta)
    expected = (b"\x01" b"\x00" b"\x07"
                + struct.pack("<Q", 9) + struct.pack("<d", 2.0)
                + struct.pack("<I", 2) + b"ab"
                + struct.pack("<I", 3) + b"idx"
                + struct.pack("<I", 0) + struct.pack("<I", 7) + b"\x01")
    assert skel == expected
    jskel, jarrays = jwire.encode_call("search", ("idx", q, 7, True), {}, meta)
    assert skel == jskel
    np.testing.assert_array_equal(arrays[0], jarrays[0])
    fname, args, kwargs, got_meta = wire.decode_call(skel, arrays)
    assert fname == "search" and kwargs == {}
    assert args[0] == "idx" and args[2] == 7 and args[3] is True
    np.testing.assert_array_equal(args[1], q)
    assert got_meta == {"wire": 1, "req_id": 9, "deadline_s": 2.0, "trace_id": "ab"}
    assert wire.BINARY_CALL_OPS == jwire.BINARY_CALL_OPS
    # the whole frame matches too
    assert (frame_bytes(rpc.pack_binary_call("search", ("idx", q, 7, True), {}, meta))
            == frame_bytes(jrpc.pack_binary_call("search", ("idx", q, 7, True), {}, meta)))


LABELS = {
    "generic": [[(1,), ("doc", 2), None, True],
                [(-5, "x"), (3.25,), False, ("nested", (1, 2))],
                [[], (0,), ("s",), (2 ** 62,)]],
    "int_ids": [[1, 2, 3, 4], [5, 6, 7, 8], [-1, 0, 2 ** 40, 9]],
    "int_tuples": [[(1, 0), (2, 1), (3, 2), (4, 3)], [(5, 1), (6, 2), (7, 3), (8, 0)],
                   [(9, 1), (10, 2), (11, 3), (12, 0)]],
}


@pytest.mark.parametrize("layout", sorted(LABELS))
def test_binary_result_roundtrip_matches_jax(layout):
    """Every label layout round-trips exact Python types, and the port's
    result frame is the JAX package's, byte for byte, in both directions."""
    scores = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    labels = LABELS[layout]
    skel, arrays = wire.encode_result((scores, labels, None))
    jskel, jarrays = jwire.encode_result((scores, labels, None))
    assert skel == jskel
    for dec, s, a in ((wire.decode_result, jskel, jarrays), (jwire.decode_result, skel, arrays)):
        out = dec(s, a)
        np.testing.assert_array_equal(out[0], scores)
        assert out[1] == labels and out[2] is None
        for got, want in zip(out[1], labels):
            assert [type(g) for g in got] == [type(w) for w in want]
    assert (frame_bytes(rpc.pack_binary_response(rpc.KIND_RESULT, (scores, labels, None), 5))
            == frame_bytes(jrpc.pack_binary_response(jrpc.KIND_RESULT,
                                                     (scores, labels, None), 5)))


def test_binary_result_with_embeddings_roundtrip():
    scores = np.zeros((2, 2), np.float32)
    embs = [[np.full(4, i, np.float32) for i in range(2)] for _ in range(2)]
    skel, arrays = wire.encode_result((scores, [[1, 2], [3, 4]], embs))
    assert skel == jwire.encode_result((scores, [[1, 2], [3, 4]], embs))[0]
    out = wire.decode_result(skel, arrays)
    for row_got, row_want in zip(out[2], embs):
        for g, w in zip(row_got, row_want):
            np.testing.assert_array_equal(g, w)


def test_binary_error_and_busy_roundtrip():
    skel, arr = wire.encode_error("Traceback: boom")
    assert skel == jwire.encode_error("Traceback: boom")[0]
    assert wire.decode_error(skel, arr) == "Traceback: boom"
    for payload in ({"reason": "stopping"},
                    {"reason": "queue_full", "queue_depth": 3, "max_queue": 8}):
        skel, arr = wire.encode_busy(payload)
        assert skel == jwire.encode_busy(payload)[0]
        assert wire.decode_busy(skel, arr) == payload


def test_encode_schema_misses_fall_back():
    """Anything outside the schema raises WireEncodeError (the per-frame
    fallback signal), and the rpc helpers return None instead."""
    q = np.zeros((1, 4), np.float32)
    with pytest.raises(wire.WireEncodeError):
        wire.encode_call("get_rank", (), {}, {})
    with pytest.raises(wire.WireEncodeError):
        wire.encode_call("search", ("i", q, 3), {"min_version": (1, 2, 3)}, {})
    with pytest.raises(wire.WireEncodeError):
        wire.encode_call("search", ("i", q, 3), {}, {"baggage": "x"})
    with pytest.raises(wire.WireEncodeError):
        wire.encode_result((q, [[(np.int64(3),)]], None))
    with pytest.raises(wire.WireEncodeError):
        wire.encode_result((q, [[{"doc": 1}]], None))
    with pytest.raises(wire.WireEncodeError):
        wire.encode_result(42)
    assert rpc.pack_binary_call("get_rank", (), {}, {}) is None
    assert rpc.pack_binary_response(rpc.KIND_RESULT, 42, req_id=1) is None
    assert rpc.pack_binary_response(rpc.KIND_CLOSE, None) is None


def test_binary_decode_rejects_garbage():
    """Truncation, trailing bytes, dangling plane refs, a wrong query dtype
    and bad tags raise WireDecodeError; at the frame layer a garbled binary
    skeleton is a FrameError, a transport error."""
    q = np.zeros((2, 3), np.float32)
    skel, arrays = wire.encode_call("search", ("i", q, 3, False), {}, {"req_id": 1})
    for s, a in ((skel[:-2], arrays), (skel + b"xx", arrays), (skel, []),
                 (skel, [q.astype(np.float64)])):
        with pytest.raises(wire.WireDecodeError):
            wire.decode_call(s, a)
    with pytest.raises(wire.WireDecodeError):
        wire.decode_result(b"\x01\x00" + struct.pack("<I", 0) + b"\xff", [q])
    assert issubclass(rpc.FrameError, rpc.TRANSPORT_ERRORS)
    a, b = socket.socketpair()
    try:
        a.sendall(rpc._HDR.pack(rpc.MAGIC, rpc.KIND_CALL | rpc.WIRE_BINARY_FLAG, 4, 0)
                  + b"\xde\xad\xbe\xef")
        with pytest.raises(rpc.FrameError):
            rpc.recv_frame_ex(b)
    finally:
        a.close()
        b.close()


def test_jax_binary_frames_decode_in_the_port():
    """Binary skeletons name no classes, so a JAX-packed binary search
    RESULT decodes in the port to the same payload (the pickle skeletons
    stay refused across packages, see test_torch_serving.py)."""
    scores = np.ones((1, 2), np.float32)
    a, b = socket.socketpair()
    try:
        a.sendall(frame_bytes(jrpc.pack_binary_response(
            jrpc.KIND_RESULT, (scores, [[(1, 2), (3, 4)]], None), 7)))
        kind, payload, was_binary = rpc.recv_frame_ex(b)
    finally:
        a.close()
        b.close()
    assert kind == rpc.KIND_RESULT_MUX and was_binary
    meta, (s, labels, embs) = payload
    assert meta == {"req_id": 7} and labels == [[(1, 2), (3, 4)]] and embs is None
    np.testing.assert_array_equal(s, scores)


# ------------------------------------------------------------- negotiation


def test_negotiation_and_identity(tmp_path, monkeypatch):
    """The first search rides pickle plus the advert, the server answers in
    binary, the stub flips peer_wire, and later search CALLs go out binary:
    every result equals the one a DFT_RPC_WIRE=pickle client gets."""
    idx, queries = make_trained_engine(tmp_path / "eng")
    with Served(tmp_path / "s", idx) as s:
        client = client_for(tmp_path, s.port, idx.cfg)
        monkeypatch.setenv("DFT_RPC_WIRE", "pickle")
        pickled = client_for(tmp_path, s.port, idx.cfg, "d2.txt")
        monkeypatch.delenv("DFT_RPC_WIRE")
        try:
            first = client.search(queries[0], 5, "wire")
            stub = client.sub_indexes[0]
            assert stub.rpc_stats()["peer_wire"] is True
            assert stub.rpc_stats()["wire"] == "binary"
            for q in queries:
                got, want = client.search(q, 5, "wire"), pickled.search(q, 5, "wire")
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]
            assert pickled.sub_indexes[0].rpc_stats()["peer_wire"] is False
            second = client.search(queries[0], 5, "wire")
            np.testing.assert_array_equal(first[0], second[0])
            assert first[1] == second[1]
            _d, m, e = client.search(queries[1], 3, "wire", return_embeddings=True)
            assert len(e) == 4 and len(e[0]) == 3 and m[0][0][1] == m[0][0][0] % 4
            assert stub.get_rank() == 0  # control ops keep pickle
            stats = client.get_perf_stats()[0]
            assert stats["rpc"]["wire"] == "binary"
            assert stats["rpc"]["client"]["peer_wire"] is True
        finally:
            client.close()
            pickled.close()


def test_handshake_with_a_pickle_only_peer(tmp_path):
    """A binary-capable client against a pickle-only server, a pickle-only
    client against a binary server, and a serial caller (no req_id, no
    advert) all serve the same results on pickle frames."""
    idx, queries = make_trained_engine(tmp_path / "eng")
    with Served(tmp_path / "s1", idx) as s:
        golden_stub = rpc.Client(0, "localhost", s.port)
        golden_stub.generic_fun("search", ("wire", queries[0], 5))
        golden = golden_stub.generic_fun("search", ("wire", queries[0], 5))
        assert golden_stub.rpc_stats()["peer_wire"] is True
        golden_stub.close()
        stub = rpc.Client(1, "localhost", s.port, wire_binary=False)
        out = [stub.generic_fun("search", ("wire", queries[0], 5)) for _ in range(3)][-1]
        assert stub.rpc_stats()["peer_wire"] is False
        np.testing.assert_array_equal(out[0], golden[0])
        assert out[1] == golden[1]
        stub.close()
        # a serial caller: no req_id, answered in order and in pickle even
        # when it advertises
        with socket.create_connection(("localhost", s.port)) as sock:
            for meta in ({}, {"wire": 1}):
                rpc.send_frame(sock, rpc.KIND_CALL, ("search", ("wire", queries[0], 5), {},
                                                     meta))
                kind, payload, was_binary = rpc.recv_frame_ex(sock)
                assert kind == rpc.KIND_RESULT and not was_binary
                assert payload[1] == golden[1]
    with Served(tmp_path / "s2", idx, wire_cfg=WireCfg(encoding="pickle")) as s:
        stub = rpc.Client(0, "localhost", s.port)
        out = [stub.generic_fun("search", ("wire", queries[0], 5)) for _ in range(3)][-1]
        assert stub.rpc_stats()["peer_wire"] is False
        np.testing.assert_array_equal(out[0], golden[0])
        assert out[1] == golden[1]
        stub.close()


def test_env_pins_pickle(monkeypatch):
    """DFT_RPC_WIRE=pickle turns the advert off; a bad value fails fast."""
    monkeypatch.setenv("DFT_RPC_WIRE", "pickle")
    assert rpc.wire_binary_by_env() is False
    monkeypatch.setenv("DFT_RPC_WIRE", "binary")
    assert rpc.wire_binary_by_env() is True
    monkeypatch.setenv("DFT_RPC_WIRE", "msgpack")
    with pytest.raises(ValueError):
        rpc.wire_binary_by_env()
    with pytest.raises(ValueError):
        WireCfg(encoding="msgpack")


def test_env_pickle_client_sends_no_advert(tmp_path, monkeypatch):
    """A client built under DFT_RPC_WIRE=pickle sends frames with no wire
    key at all, and the server never answers it in binary."""
    captured = []
    real_send = rpc.send_parts

    def tap(sock, parts):
        captured.append(frame_bytes(parts))
        return real_send(sock, parts)

    idx, queries = make_trained_engine(tmp_path / "eng")
    monkeypatch.setenv("DFT_RPC_WIRE", "pickle")
    with Served(tmp_path / "s", idx) as s:
        stub = rpc.Client(0, "localhost", s.port)
        monkeypatch.setattr(rpc, "send_parts", tap)
        for q in queries[:3]:
            stub.generic_fun("search", ("wire", q, 5))
        monkeypatch.setattr(rpc, "send_parts", real_send)
        stats = stub.rpc_stats()
        assert (stats["wire"], stats["peer_wire"]) == ("pickle", False)
        assert stats["round_trip_s"]["count"] == 3
        stub.close()
    assert len(captured) == 6
    a, b = socket.socketpair()
    try:
        for buf in captured:
            a.sendall(buf)
            kind, payload, was_binary = rpc.recv_frame_ex(b)
            assert not was_binary
            if kind == rpc.KIND_CALL:
                assert set(payload[3]) == {"req_id"}
    finally:
        a.close()
        b.close()


def test_per_frame_fallback_on_a_negotiated_connection(tmp_path):
    """On a negotiated connection a result outside the schema (dict
    metadata) and a call outside it (an extra kwarg: a read-your-writes
    ``min_version``, answered, or an unknown one, refused) ride pickle for
    that frame; the connection keeps serving."""
    idx, queries = make_trained_engine(tmp_path / "eng", meta_fn=lambda i: {"doc": i})
    with Served(tmp_path / "s", idx) as s:
        stub = rpc.Client(0, "localhost", s.port)
        try:
            stub.generic_fun("search", ("wire", queries[0], 5))
            # dict metadata has no binary layout: the response stayed
            # pickle, so this connection has not seen a binary frame yet
            assert stub.rpc_stats()["peer_wire"] is False
            out = stub.generic_fun("search", ("wire", queries[0], 5))
            assert all(isinstance(m, dict) for m in out[1][0])
            # a read-your-writes min_version rides pickle and is answered
            ryw = stub.generic_fun("search", ("wire", queries[0], 5), {"min_version": None})
            assert ryw[1] == out[1]
            with pytest.raises(rpc.ServerException, match="unexpected keyword"):
                stub.generic_fun("search", ("wire", queries[0], 5), {"bogus": 3})
            assert stub.generic_fun("get_rank", ()) == 0
        finally:
            stub.close()
    idx, queries = make_trained_engine(tmp_path / "eng2")
    with Served(tmp_path / "s2", idx) as s:
        stub = rpc.Client(0, "localhost", s.port)
        try:
            out = stub.generic_fun("search", ("wire", queries[0], 5))
            assert stub.rpc_stats()["peer_wire"] is True
            ryw = stub.generic_fun("search", ("wire", queries[0], 5), {"min_version": None})
            assert ryw[1] == out[1]
            with pytest.raises(rpc.ServerException, match="unexpected keyword"):
                stub.generic_fun("search", ("wire", queries[0], 5), {"bogus": 3})
            assert stub.generic_fun("get_rank", ()) == 0
        finally:
            stub.close()


@pytest.mark.parametrize("scheduler", [True, False], ids=["scheduler", "direct"])
def test_negotiated_search_frames_contain_no_pickle(tmp_path, monkeypatch, scheduler):
    """After negotiation every search CALL and RESULT frame is binary and
    pickle-free, on the scheduler's path and on the direct path
    (DFT_SCHEDULER=0, through engine.search)."""
    captured = []
    real_send = rpc.send_parts

    def tap(sock, parts):
        captured.append(frame_bytes(parts))
        return real_send(sock, parts)

    idx, queries = make_trained_engine(tmp_path / "eng")
    with Served(tmp_path / "s", idx,
                scheduler_cfg=SchedulerCfg(enabled=scheduler, max_wait_ms=1.0)) as s:
        stub = rpc.Client(0, "localhost", s.port)
        try:
            want = stub.generic_fun("search", ("wire", queries[0], 5))
            monkeypatch.setattr(rpc, "send_parts", tap)
            got = [stub.generic_fun("search", ("wire", q, 5)) for q in queries[:4]]
            monkeypatch.setattr(rpc, "send_parts", real_send)
        finally:
            stub.close()
    assert got[0][1] == want[1]
    calls = results = 0
    for buf in captured:
        _magic, kind, skel_len, _narr = rpc._HDR.unpack(buf[:rpc._HDR.size])
        skel = buf[rpc._HDR.size:rpc._HDR.size + skel_len]
        base = kind & ~rpc.WIRE_BINARY_FLAG
        assert kind & rpc.WIRE_BINARY_FLAG, f"pickle frame kind {kind}"
        assert PICKLE_PROTO4 not in skel
        calls += base == rpc.KIND_CALL
        results += base == rpc.KIND_RESULT_MUX
    assert calls == 4 and results == 4


def test_malformed_binary_frame_drops_only_that_connection(tmp_path):
    with Served(tmp_path / "s") as s:
        for kind, body in ((rpc.KIND_CALL, b"\xff" * 8), (rpc.KIND_CLOSE, b"\x01\x00")):
            bad = socket.create_connection(("localhost", s.port))
            bad.sendall(rpc._HDR.pack(rpc.MAGIC, kind | rpc.WIRE_BINARY_FLAG, len(body), 0)
                        + body)
            bad.settimeout(10)
            assert bad.recv(1) == b""  # the server dropped it
            bad.close()
        c = rpc.Client(0, "localhost", s.port)
        assert c.get_rank() == 0
        c.close()


def test_mux_out_of_order_tagged_binary_responses():
    """The demux routes binary tagged responses by req_id, out of order, and
    the first one flips peer_wire."""
    lsock = socket.socket()
    lsock.bind(("localhost", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    frames = []
    scores = {"a": np.full((1, 2), 1.0, np.float32), "b": np.full((1, 2), 2.0, np.float32)}

    def serve():
        conn, _ = lsock.accept()
        with conn:
            for _ in range(2):
                kind, payload = rpc.recv_frame(conn)
                assert kind == rpc.KIND_CALL
                frames.append(payload)
            for payload in reversed(frames):
                _fname, args, _kw, meta = payload
                assert meta["wire"] == 1
                rpc.send_parts(conn, rpc.pack_binary_response(
                    rpc.KIND_RESULT, (scores[args[0]], [[("hit", args[0])]], None),
                    meta["req_id"]))
                time.sleep(0.05)
            conn.recv(1)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    c = rpc.Client(0, "localhost", port)
    done = {}

    def call(iid):
        done[iid] = c.generic_fun("search", (iid, np.zeros((1, 2), np.float32), 1))

    threads = [threading.Thread(target=call, args=(i,)) for i in ("a", "b")]
    for th in threads:
        th.start()
        time.sleep(0.05)  # arrival order a, b
    for th in threads:
        th.join(timeout=10)
    assert sorted(done) == ["a", "b"]
    for iid in "ab":
        np.testing.assert_array_equal(done[iid][0], scores[iid])
        assert done[iid][1] == [[("hit", iid)]]
    assert c.rpc_stats()["peer_wire"] is True
    c.close()
    lsock.close()
    t.join(10)


def test_peer_wire_resets_with_the_connection(tmp_path):
    """A redial may reach a pickle-only peer: the stub's peer_wire resets
    when its connection is replaced."""
    idx, queries = make_trained_engine(tmp_path / "eng")
    with Served(tmp_path / "s", idx) as s:
        stub = rpc.Client(0, "localhost", s.port)
        try:
            stub.generic_fun("search", ("wire", queries[0], 5))
            assert stub.rpc_stats()["peer_wire"] is True
            with stub._lock:
                stub._fail_locked(ConnectionResetError("test drop"))
            assert stub.generic_fun("get_rank", ()) == 0  # redials
            assert stub.rpc_stats()["peer_wire"] is False
        finally:
            stub.close()
