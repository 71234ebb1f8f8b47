"""Link faults through the port's ChaosProxy against in-process port servers
on the CPU: garbled and cut frames cost one connection in both serving
loops; latency and a blackhole are bounded by the caller's deadline; a
reset on a redial is healed by the client's retry; a drop_kind fault
swallows digest frames while searches on the same link flow."""

import socket
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.testing.chaos import ChaosProxy, Fault
from distributed_faiss_tpu_torch.utils.config import AntiEntropyCfg, IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

from netutil import free_port

D = 16


def flat_cfg(**kw):
    kw.setdefault("index_builder_type", "flat")
    kw.setdefault("dim", D)
    kw.setdefault("metric", "l2")
    kw.setdefault("train_num", 20)
    return IndexCfg(**kw)


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def serving(tmp_path):
    """start(selector=False, **kw) -> (server, port); every server stops at
    teardown."""
    started = []

    def start(selector=False, rank=0, storage=None, **kw):
        srv = IndexServer(rank, str(storage or tmp_path / f"s{len(started)}"), device="cpu",
                          **kw)
        port = srv.bind(0)
        t = threading.Thread(target=srv.start if selector else srv.start_blocking,
                             name=f"chaos-server:{port}", daemon=True)
        t.start()
        started.append((srv, t))
        return srv, port

    yield start
    for srv, t in started:
        srv.stop()
        t.join(timeout=10)


def test_fault_validation():
    with pytest.raises(ValueError, match="unknown fault"):
        Fault("melt")
    with pytest.raises(ValueError, match="direction"):
        Fault("latency", direction="sideways")
    with pytest.raises(ValueError, match="drop_kinds"):
        Fault(Fault.DROP_KIND)
    assert "garble" in repr(Fault("garble"))


@pytest.mark.parametrize("selector", [False, True], ids=["threaded", "selector"])
@pytest.mark.parametrize("kind", ["garble", "cut", "garble-down"])
def test_frame_faults_drop_connection_not_server(serving, selector, kind):
    """The faulted connection fails with a retryable transport error, the
    same stub succeeds on its next (clean) connection, and a bystander on a
    direct connection never notices; garble-down corrupts the response, so
    the client itself detects the bad frame."""
    _srv, port = serving(selector=selector)
    fault = {"garble": Fault("garble", after_bytes=2, nbytes=6, direction="up"),
             "cut": Fault("cut", after_bytes=7, direction="up"),
             "garble-down": Fault("garble", after_bytes=0, nbytes=4, direction="down")}[kind]
    with ChaosProxy("localhost", port, plan=[fault]) as proxy:
        bystander = rpc.Client(1, "localhost", port)
        c = rpc.Client(0, "localhost", proxy.port)
        try:
            with pytest.raises(rpc.TRANSPORT_ERRORS) as ei:
                c.generic_fun("get_rank", (), {}, timeout=10.0)
            assert rpc.RetryPolicy().is_retryable(ei.value)
            assert c.generic_fun("get_rank", (), {}, timeout=10.0) == 0
            assert bystander.get_rank() == 0
            assert proxy.connections_seen() == 2
        finally:
            c.close()
            bystander.close()


@pytest.mark.parametrize("mux", [True, False], ids=["mux", "serial"])
def test_latency_and_blackhole_bounded_by_deadline(serving, mux):
    _srv, port = serving()
    with ChaosProxy("localhost", port,
                    plan=[Fault("latency", delay=0.2, direction="up")]) as proxy:
        c = rpc.Client(0, "localhost", proxy.port, mux=mux)
        t0 = time.monotonic()
        assert c.generic_fun("get_rank", (), {}, timeout=10.0) == 0
        assert time.monotonic() - t0 >= 0.2
        c.close()
    with ChaosProxy("localhost", port, plan=[Fault("blackhole")]) as proxy:
        c = rpc.Client(0, "localhost", proxy.port, mux=mux)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            c.generic_fun("get_rank", (), {}, deadline=time.time() + 0.5)
        took = time.monotonic() - t0
        assert took < 0.5 + rpc.Client.DEADLINE_GRACE + 0.5, took
        c.close()


def test_reset_on_redial_healed_by_retry(serving, tmp_path):
    """conn 0 (the first dial) is clean, conn 1 (the first redial) is reset
    at accept, conn 2 is clean: a write whose live socket was severed
    retries through the RST and lands on the same rank, no reroute."""
    _srv, port = serving()
    with ChaosProxy("localhost", port, plan=[None, Fault("reset")]) as proxy:
        disc = tmp_path / "disc.txt"
        disc.write_text(f"1\nlocalhost,{proxy.port}\n")
        client = IndexClient(str(disc), retry_policy=rpc.RetryPolicy(
            max_attempts=4, base_delay=0.02, jitter=0.0))
        try:
            client.create_index("r", flat_cfg())
            x = np.random.default_rng(3).standard_normal((60, D)).astype(np.float32)
            client.add_index_data("r", x[:30], [(i,) for i in range(30)])
            stub = client.sub_indexes[0]
            stub.sock.shutdown(socket.SHUT_RDWR)  # sever the live connection
            stub.RECONNECT_TIMEOUT = 0.5
            before = list(client.reroutes)
            client.add_index_data("r", x[30:], [(i,) for i in range(30, 60)])
            assert list(client.reroutes) == before
            assert proxy.connections_seen() >= 3
            client.sync_train("r")
            assert wait_until(lambda: client.get_ntotal("r") == 60
                              and client.get_state("r") == IndexState.TRAINED)
            _d, meta = client.search(x[:3], 1, "r")
            assert [row[0][0] for row in meta] == [0, 1, 2]
        finally:
            client.close()


def test_drop_kind_swallows_digests_while_search_flows(serving, tmp_path):
    """Only KIND_DIGEST frames are dropped on the proxied link: the digest
    exchange through it times out, and rank A's detector marks B suspect
    after two sweeps, while a search through the same proxy and a direct
    one are served."""
    b, pb = serving(rank=1, storage=tmp_path / "b")
    b.set_shard_group(0)
    proxy = ChaosProxy("localhost", pb).start()
    proxy.set_fault(Fault(Fault.DROP_KIND, direction="up", drop_kinds={rpc.KIND_DIGEST}))
    try:
        port_a = free_port()
        disc = tmp_path / "disc.txt"
        disc.write_text(f"2\nlocalhost,{port_a}\nlocalhost,{proxy.port}\n")
        a = IndexServer(0, str(tmp_path / "a"), device="cpu", discovery_path=str(disc),
                        antientropy_cfg=AntiEntropyCfg(interval_s=600, suspect_after=2,
                                                       exchange_timeout_s=0.5))
        a.set_shard_group(0)
        a.bind(port_a)
        ta = threading.Thread(target=a.start_blocking, name="chaos-server-a", daemon=True)
        ta.start()
        try:
            assert wait_until(lambda: a._antientropy is not None)
            b.create_index("t", flat_cfg())
            x = np.random.default_rng(4).standard_normal((20, D)).astype(np.float32)
            b.add_index_data("t", x, [(i,) for i in range(20)])
            assert wait_until(lambda: b.get_state("t") == IndexState.TRAINED
                              and b.get_aggregated_ntotal("t") == 0)
            with pytest.raises(OSError):
                rpc.digest_exchange("localhost", proxy.port, {"rank": 0, "group": 0},
                                    timeout=0.5)
            a._antientropy.sweep_once()
            a._antientropy.sweep_once()
            assert [s["port"] for s in a.get_health()["suspects"]] == [proxy.port]
            for port in (proxy.port, pb):
                c = rpc.Client(7, "localhost", port, mux=False)
                scores, meta, _ = c.generic_fun("search", ("t", x[:2], 3, False))
                assert scores.shape == (2, 3) and [m[0][0] for m in meta] == [0, 1]
                c.close()
            assert rpc.digest_exchange("localhost", pb, {"rank": 0, "group": 0})["rank"] == 1
        finally:
            a.stop()
            ta.join(timeout=10)
    finally:
        proxy.stop()


def test_proxy_stop_joins_its_threads(serving):
    _srv, port = serving()
    proxy = ChaosProxy("localhost", port).start()
    clients = [rpc.Client(i, "localhost", proxy.port) for i in range(3)]
    assert [c.get_rank() for c in clients] == [0, 0, 0]
    threads = list(proxy._threads)
    proxy.stop()
    assert not proxy._accept_thread.is_alive()
    assert not any(t.is_alive() for t in threads)
    for c in clients:
        with pytest.raises(rpc.TRANSPORT_ERRORS + (ConnectionRefusedError,)):
            c.generic_fun("get_rank", timeout=5.0)
        c.close()
