"""The port's serving path on the CPU: an IndexServer and an IndexClient over
loopback TCP, create -> add -> threshold train -> search -> save -> load,
and a storage dir written by the JAX engine served by the port's server."""

import os
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu.engine import Index as JIndex
from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
from distributed_faiss_tpu.utils.state import IndexState as JState
from distributed_faiss_tpu_torch.engine import Index as TIndex
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.utils import racecheck
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

from netutil import free_port

D = 16


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def cluster(tmp_path):
    """Start port servers on loopback ports; yields a function that starts
    ``n`` of them and returns (client, servers). Every server and client is
    stopped in the fixture's teardown."""
    servers, clients = [], []

    def start(n=1, storage=None):
        storage = storage or str(tmp_path / "store")
        lines = []
        for rank in range(n):
            srv = IndexServer(rank, storage, device="cpu")
            port = srv.bind(0)
            threading.Thread(target=srv.start_blocking, name=f"test-server-{rank}",
                             daemon=True).start()
            servers.append(srv)
            lines.append(f"localhost,{port}")
        disc = str(tmp_path / f"discovery{len(clients)}.txt")
        with open(disc, "w") as f:
            f.write(f"{n}\n" + "\n".join(lines) + "\n")
        client = IndexClient(disc)
        clients.append(client)
        return client, servers[-n:]

    try:
        yield start
    finally:
        for c in clients:
            c.close()
        for s in servers:
            s.stop()


def indexed(client, iid, n):
    return (client.get_state(iid) == IndexState.TRAINED
            and client.get_buffer_depth(iid) == 0 and client.get_ntotal(iid) == n)


@pytest.mark.parametrize("builder", ["ivfsq", "flat"])
def test_create_add_train_search_save_load(rng, cluster, builder):
    client, _ = cluster(2)
    x = rng.standard_normal((900, D)).astype(np.float32)
    cfg = IndexCfg(index_builder_type=builder, dim=D, metric="l2", train_num=300,
                   centroids=8, nprobe=8, pallas_flat=True)
    assert client.create_index("idx", cfg) == [True, True]
    for s in range(0, 900, 100):
        client.add_index_data("idx", x[s:s + 100], [("m", i) for i in range(s, s + 100)])
    assert wait_until(lambda: indexed(client, "idx", 900))
    D1, M1 = client.search(x[:6] + 1e-4, 4, "idx")
    assert D1.shape == (6, 4) and np.all(np.diff(D1, axis=1) >= 0)
    # every row's nearest neighbour is itself, wherever it was placed
    assert [m[0] for m in M1] == [("m", i) for i in range(6)]
    client.save_index("idx")
    client.drop_index("idx")
    assert client.load_index("idx")
    D2, M2 = client.search(x[:6] + 1e-4, 4, "idx")
    assert M2 == M1
    np.testing.assert_array_equal(D2, D1)
    stats = client.get_perf_stats()
    assert stats[0]["scheduler"] and "search" in stats[0]


def test_jax_storage_dir_served_by_port(rng, cluster, tmp_path):
    """The JAX engine writes a generation + MANIFEST storage dir; a port
    server loads it and serves the same ids and metadata as the JAX engine
    does from that dir."""
    storage = str(tmp_path / "store")
    x = rng.standard_normal((600, D)).astype(np.float32)
    q = x[:8] + 0.01 * rng.standard_normal((8, D)).astype(np.float32)
    cfg = JCfg(index_builder_type="ivfsq", dim=D, metric="l2", train_num=300,
               centroids=8, nprobe=4, pallas_flat=True,
               index_storage_dir=os.path.join(storage, "idx", "0"))
    jidx = JIndex(cfg)
    jidx.add_batch(x, [{"doc": i} for i in range(600)], train_async_if_triggered=False)
    assert wait_until(lambda: jidx.get_state() == JState.TRAINED
                      and jidx.get_idx_data_num() == (0, 600))
    assert jidx.save() is True
    jidx.retire()
    want_d, want_m, _ = JIndex.from_storage_dir(cfg.index_storage_dir).search(q, 5)

    client, _ = cluster(1, storage)
    assert client.load_index("idx")
    assert client.cfg.nprobe == 4 and client.get_ntotal("idx") == 600
    got_d, got_m = client.search(q, 5, "idx")
    assert got_m == want_m
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3)


def test_engine_refuses_tombstoned_dir(rng, tmp_path):
    """A JAX-written dir whose tombstone set is not empty is no longer
    refused: the port loads it with the deletes and never serves a
    deleted row, as the JAX engine does from that dir."""
    storage = str(tmp_path / "shard")
    x = rng.standard_normal((200, D)).astype(np.float32)
    cfg = JCfg(index_builder_type="flat", dim=D, metric="l2", train_num=100,
               index_storage_dir=storage)
    jidx = JIndex(cfg)
    jidx.add_batch(x, [(i, "doc") for i in range(200)], train_async_if_triggered=False)
    assert wait_until(lambda: jidx.get_idx_data_num() == (0, 200))
    assert jidx.remove_ids([3, 4]) == 2
    assert jidx.save() is True
    jidx.retire()
    tidx = TIndex.from_storage_dir(storage, device="cpu")
    want = JIndex.from_storage_dir(storage)
    try:
        _, got_m, _ = tidx.search(x[:6], 3)
        _, want_m, _ = want.search(x[:6], 3)
        assert got_m == want_m
        assert not {m[0] for row in got_m for m in row} & {3, 4}
        assert tidx.get_ids() == set(range(200)) - {3, 4}
    finally:
        tidx.retire()
        want.retire()


def test_port_engine_dir_loads_in_jax(rng, tmp_path):
    """The port's generation + MANIFEST file set loads in the JAX engine."""
    storage = str(tmp_path / "shard")
    x = rng.standard_normal((500, D)).astype(np.float32)
    cfg = IndexCfg(index_builder_type="ivf_simple", dim=D, metric="dot", train_num=200,
                   centroids=8, nprobe=8, index_storage_dir=storage)
    tidx = TIndex(cfg, device="cpu")
    tidx.add_batch(x, [("r", i) for i in range(500)], train_async_if_triggered=False)
    assert wait_until(lambda: tidx.get_state() == IndexState.TRAINED
                      and tidx.get_idx_data_num() == (0, 500))
    assert tidx.save() is True
    got_d, got_m, _ = tidx.search(x[:5], 3)
    want_d, want_m, _ = JIndex.from_storage_dir(storage).search(x[:5], 3)
    assert got_m == want_m
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3)


def test_dft1_frames_match_the_jax_package():
    """The frame layout and kind codes are the JAX package's: a frame of
    builtins is byte-identical and each package reads the other's. Tensor
    planes travel too, but their skeleton placeholder pickles by module
    path, and each package's restricted unpickler allows only its own."""
    import pickle
    import socket

    from distributed_faiss_tpu.parallel import rpc as jrpc
    from distributed_faiss_tpu_torch.parallel import rpc as trpc

    for name in ("KIND_CALL", "KIND_RESULT", "KIND_ERROR", "KIND_CLOSE", "KIND_BUSY",
                 "KIND_RESULT_MUX", "KIND_ERROR_MUX", "KIND_BUSY_MUX", "MAGIC"):
        assert getattr(trpc, name) == getattr(jrpc, name)
    call = ("get_state", ("idx",), {}, {"req_id": 3, "deadline_s": 1.5})
    frame = b"".join(bytes(p) for p in trpc.pack_frame(trpc.KIND_CALL, call))
    assert frame == b"".join(bytes(p) for p in jrpc.pack_frame(jrpc.KIND_CALL, call))
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        assert jrpc.recv_frame(b) == (jrpc.KIND_CALL, call)
        a.sendall(b"".join(bytes(p) for p in jrpc.pack_tagged_response(
            jrpc.KIND_RESULT, [1, 2], 3)))
        assert trpc.recv_frame(b) == (trpc.KIND_RESULT_MUX, ({"req_id": 3}, [1, 2]))
        a.sendall(b"".join(bytes(p) for p in jrpc.pack_frame(
            jrpc.KIND_RESULT, np.zeros(2, np.float32))))
        with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
            trpc.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_object_dtype_plane_is_a_frame_error():
    """A tensor plane header naming an object dtype is refused before any
    bytes are read into it."""
    import socket
    import struct

    from distributed_faiss_tpu_torch.parallel import rpc as trpc

    parts = trpc.pack_frame(trpc.KIND_RESULT, np.zeros(2, np.int64))
    frame = bytearray(b"".join(bytes(p) for p in parts))
    plane = frame.index(struct.pack("<B", 3) + b"<i8")
    frame[plane:plane + 4] = struct.pack("<B", 3) + b"|O8"
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(trpc.FrameError, match="object dtype"):
            trpc.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_scheduler_coalesces_and_sheds():
    """Concurrent searches merge into one window and each caller gets its
    own rows back; a full queue rejects with SchedulerBusy; an expired
    deadline is shed before the launch."""
    from distributed_faiss_tpu_torch.serving.scheduler import (DeadlineExpired,
                                                                SchedulerBusy,
                                                                SearchScheduler)
    from distributed_faiss_tpu_torch.utils.config import SchedulerCfg

    windows = []
    gate = threading.Event()
    gate.set()

    def search_fn(index_id, q, k, return_embeddings):
        windows.append(q.shape[0])
        gate.wait(10)
        return q[:, :k] * 2, [[int(v)] for v in q[:, 0]], None

    # the window flushes when 12 rows are pending, long before the wait
    sched = SearchScheduler(search_fn, SchedulerCfg(max_batch_rows=12, max_wait_ms=10_000,
                                                    max_queue=3))
    try:
        results = {}

        def call(i):
            results[i] = sched.submit("idx", np.full((4, 3), float(i), np.float32), 2)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert windows == [12]
        for i, (scores, meta, _) in results.items():
            np.testing.assert_array_equal(scores, np.full((4, 2), 2.0 * i, np.float32))
            assert meta == [[i]] * 4

        gate.clear()  # hold the batcher inside the next launch
        sched.submit_async("idx", np.zeros((1, 3), np.float32), 2, eager=True)
        assert wait_until(lambda: len(windows) == 2)
        for _ in range(3):
            sched.submit_async("idx", np.zeros((1, 3), np.float32), 2)
        with pytest.raises(SchedulerBusy):
            sched.submit_async("idx", np.zeros((1, 3), np.float32), 2)
        with pytest.raises(DeadlineExpired):
            sched.submit_async("idx", np.zeros((1, 3), np.float32), 2,
                               deadline=time.monotonic() - 1.0)
    finally:
        gate.set()
        sched.stop()


# ---------------------------------------------------------------------------
# the rest of the single-rank surface, against the JAX package's


@pytest.fixture
def jax_client(tmp_path):
    """One JAX IndexServer on a loopback port and a JAX IndexClient; both
    stopped in teardown."""
    from distributed_faiss_tpu.parallel.client import IndexClient as JClient
    from distributed_faiss_tpu.parallel.server import IndexServer as JServer

    port = free_port()
    srv = JServer(0, str(tmp_path / "jax_store"))
    threading.Thread(target=srv.start_blocking, args=(port,), daemon=True).start()
    disc = tmp_path / "jax_discovery.txt"
    disc.write_text(f"1\nlocalhost,{port}\n")
    client = JClient(str(disc))
    try:
        yield client
    finally:
        client.close()
        srv.stop()


def _fill(client, iid, x, meta, bs=100):
    for s in range(0, x.shape[0], bs):
        client.add_index_data(iid, x[s:s + bs], meta[s:s + bs])


def _filter_corpus(rng):
    x = rng.standard_normal((400, D)).astype(np.float32)
    # 95% of rows filtered out: a 3x over-fetch of k=5 leaves rows short
    meta = [("rare" if i % 20 == 0 else "common", i) for i in range(400)]
    return x, meta


@pytest.mark.parametrize("max_requery", [0, 3])
def test_search_with_filter_matches_jax(rng, cluster, jax_client, max_requery):
    """search_with_filter over two port ranks gives the JAX package's
    single-rank answer (exact flat search: the same global top-k however
    the rows were placed): no kept row carries the filtered value, and rows
    are short only without the requery."""
    from distributed_faiss_tpu.utils.config import IndexCfg as JCfg

    x, meta = _filter_corpus(rng)
    q = x[:4] + 0.01
    client, _ = cluster(2)
    kw = dict(index_builder_type="flat", dim=D, metric="l2", train_num=20)
    client.create_index("f", IndexCfg(**kw))
    jax_client.create_index("f", JCfg(**kw))
    for c in (client, jax_client):
        _fill(c, "f", x, meta)
        c.sync_train("f")
    assert wait_until(lambda: indexed(client, "f", 400))
    assert wait_until(lambda: jax_client.get_ntotal("f") == 400
                      and jax_client.get_buffer_depth("f") == 0)
    args = (q, 5, "f")
    kwargs = dict(filter_pos=0, filter_value="common", max_requery=max_requery)
    got_s, got_m = client.search_with_filter(*args, **kwargs)
    want_s, want_m = jax_client.search_with_filter(*args, **kwargs)
    assert got_m == want_m
    for gs, ws in zip(got_s, want_s):
        np.testing.assert_allclose(gs, ws, rtol=1e-3, atol=1e-3)
    assert all(m[0] == "rare" for row in got_m for m in row)
    if max_requery:
        assert all(len(row) == 5 for row in got_m)
    else:
        assert any(len(row) < 5 for row in got_m)
    # filter_pos < 0 is the plain search
    d, m = client.search_with_filter(q, 5, "f")
    assert m == client.search(q, 5, "f")[1]


def test_get_ids_matches_jax(rng, cluster, jax_client):
    from distributed_faiss_tpu.utils.config import IndexCfg as JCfg

    x = rng.standard_normal((120, D)).astype(np.float32)
    meta = [("m", 1000 + i) for i in range(120)]
    client, _ = cluster(2)
    kw = dict(index_builder_type="flat", dim=D, metric="l2", train_num=20,
              custom_meta_id_idx=1)
    client.create_index("ids", IndexCfg(**kw))
    jax_client.create_index("ids", JCfg(**kw))
    for c in (client, jax_client):
        _fill(c, "ids", x[:90], meta[:90], bs=30)
        c.sync_train("ids")
        _fill(c, "ids", x[90:], meta[90:], bs=30)
    assert wait_until(lambda: indexed(client, "ids", 120))
    assert wait_until(lambda: jax_client.get_ntotal("ids") == 120)
    assert client.get_ids("ids") == jax_client.get_ids("ids") == set(range(1000, 1120))


def test_centroids_index_loaded_buffer_and_omp(rng, cluster):
    """get_centroids, index_loaded, add_buffer_to_index and
    set_omp_num_threads answer on every rank."""
    client, servers = cluster(2)
    x = rng.standard_normal((600, D)).astype(np.float32)
    cfg = IndexCfg(index_builder_type="ivfsq", dim=D, metric="l2", train_num=200,
                   centroids=4, nprobe=4)
    client.create_index("c", cfg)
    assert [s.index_loaded("c") for s in servers] == [False, False]
    _fill(client, "c", x, list(range(600)))
    client.add_buffer_to_index("c")  # a no-op until trained, then a drain
    assert wait_until(lambda: indexed(client, "c", 600))
    client.add_buffer_to_index("c")
    cents = client.get_centroids("c")
    assert len(cents) == 2 and all(c.shape == (4, D) for c in cents)
    for c, s in zip(cents, servers):
        with racecheck.peeking():  # a white-box read of the engine's model
            np.testing.assert_array_equal(c, s.indexes["c"].model.get_centroids())
    assert [s.index_loaded("c") for s in servers] == [True, True]
    assert not servers[0].index_loaded("nope")
    client.set_omp_num_threads(2)
    assert os.environ["OMP_NUM_THREADS"] == "2"


def test_allow_partial_with_a_stopped_server(rng, cluster):
    """With one of two ranks stopped, allow_partial serves the survivor's
    top-k and names the dead rank in ``missing``; the strict call raises; an
    application error from the live rank still raises; and with every rank
    dead the partial call raises too."""
    from distributed_faiss_tpu_torch.parallel import rpc

    client, servers = cluster(2)
    x = rng.standard_normal((400, D)).astype(np.float32)
    client.create_index("p", IndexCfg(index_builder_type="flat", dim=D, metric="l2",
                                      train_num=20))
    _fill(client, "p", x, [("r", i) for i in range(400)])
    client.sync_train("p")
    assert wait_until(lambda: indexed(client, "p", 400))
    q = x[:6] + 0.01
    full_d, full_m, missing = client.search(q, 5, "p", allow_partial=True)
    assert missing == []
    np.testing.assert_array_equal(full_d, client.search(q, 5, "p")[0])
    survivor = servers[0].indexes["p"]
    servers[1].stop()
    with pytest.raises(rpc.TRANSPORT_ERRORS):
        client.search(q, 5, "p")
    d, m, missing = client.search(q, 5, "p", allow_partial=True, partial_timeout=5.0)
    want_d, want_m, _ = survivor.search(q, 5)
    assert m == want_m
    np.testing.assert_allclose(d, want_d, rtol=1e-5)
    assert len(missing) == 1 and missing[0]["server"] == client.sub_indexes[1].id
    assert missing[0]["port"] == client.sub_indexes[1].port
    with pytest.raises(rpc.ServerException, match="no index"):
        client.search(q, 5, "absent", allow_partial=True)
    servers[0].stop()
    with pytest.raises(RuntimeError, match="every rank"):
        client.search(q, 5, "p", allow_partial=True)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_save_watcher_commits_a_generation(rng, tmp_path, package):
    """save_interval_sec > 0 starts a save watcher: rows added once, with no
    later add, reach a committed generation within two intervals, as in the
    JAX engine; retire() stops the watcher at once."""
    from distributed_faiss_tpu.utils import serialization as jser
    from distributed_faiss_tpu_torch.utils import serialization as tser

    storage = str(tmp_path / "shard")
    x = rng.standard_normal((200, D)).astype(np.float32)
    kw = dict(index_builder_type="flat", dim=D, metric="l2", train_num=50,
              save_interval_sec=1, index_storage_dir=storage)
    if package == "port":
        idx, ser, trained = TIndex(IndexCfg(**kw), device="cpu"), tser, IndexState.TRAINED
    else:
        idx, ser, trained = JIndex(JCfg(**kw)), jser, JState.TRAINED
    try:
        idx.add_batch(x, list(range(200)), train_async_if_triggered=False)
        assert wait_until(lambda: idx.get_state() == trained
                          and idx.get_idx_data_num() == (0, 200))
        t0 = time.monotonic()
        assert wait_until(lambda: ser.list_generations(storage), timeout=2.0)
        assert time.monotonic() - t0 <= 2.0
    finally:
        idx.retire()
    assert not idx._save_thread.is_alive()
    if package == "port":
        loaded = TIndex.from_storage_dir(storage, device="cpu")
        assert loaded.get_idx_data_num() == (0, 200)
        loaded.retire()


def _jax_legacy_dir(rng, tmp_path, deletes=()):
    """A pre-manifest shard written by the JAX engine: one saved generation
    whose files are renamed to the flat names and whose MANIFEST is gone;
    ``deletes`` are removed after the save, so they live only in the
    standalone tombstone sidecar (layout 0)."""
    from distributed_faiss_tpu.utils import serialization as jser

    storage = str(tmp_path / "legacy")
    x = rng.standard_normal((120, D)).astype(np.float32)
    jidx = JIndex(JCfg(index_builder_type="flat", dim=D, metric="l2", train_num=20,
                       index_storage_dir=storage))
    jidx.add_batch(x, [(i, "m") for i in range(120)], train_async_if_triggered=False)
    assert wait_until(lambda: jidx.get_state() == JState.TRAINED
                      and jidx.get_idx_data_num() == (0, 120))
    assert jidx.save() is True
    if deletes:
        assert jidx.remove_ids(list(deletes)) == len(deletes)
    jidx.retire()
    ((_gen, mpath),) = jser.list_generations(storage)
    manifest = jser.load_manifest(mpath)
    for key, flat in (("index", "index.npz"), ("meta", "meta.pkl"), ("buffer", "buffer.pkl"),
                      ("cfg", "cfg.json")):
        os.replace(os.path.join(storage, manifest["files"][key]["name"]),
                   os.path.join(storage, flat))
    os.unlink(mpath)
    return storage, x


@pytest.mark.parametrize("deletes", [(), (3, 4)])
def test_legacy_flat_layout_loads_in_both_engines(rng, tmp_path, deletes):
    """Twin of tests/test_manifest.py::test_legacy_flat_layout_still_loads:
    a JAX-written pre-manifest dir (flat index.npz / meta.pkl / buffer.pkl /
    cfg.json, a layout-0 sidecar) loads in the port's engine TRAINED at
    generation 0 and serves the JAX engine's ids and distances from the same
    dir, no deleted id among them; its next save commits generation 1."""
    from distributed_faiss_tpu_torch.engine import get_index_files
    from distributed_faiss_tpu_torch.utils import serialization as tser

    storage, x = _jax_legacy_dir(rng, tmp_path, deletes)
    assert all(os.path.exists(f) for f in get_index_files(storage))
    want = JIndex.from_storage_dir(storage)
    got = TIndex.from_storage_dir(storage, device="cpu")
    try:
        assert got is not None and got.get_state() == IndexState.TRAINED
        assert got._generation == 0 == want._generation
        want_d, want_m, _ = want.search(x[:6], 4)
        got_d, got_m, _ = got.search(x[:6], 4)
        assert got_m == want_m
        np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
        assert not {m[0] for row in got_m for m in row} & set(deletes)
        assert got.get_ids() == set(range(120)) - set(deletes)
        assert got.save() is True
        assert [g for g, _p in tser.list_generations(storage)] == [1]
    finally:
        got.retire()
        want.retire()
    assert TIndex.from_storage_dir(str(tmp_path / "empty"), device="cpu") is None


def test_perf_stats_degrade_per_dead_rank(rng, cluster):
    """Queue 3 fault 4: with one in-process rank stopped, get_perf_stats
    answers that rank with {"error", "server", "host", "port"} (and this
    client's views of its stub) and returns the survivor's stats intact, as
    the JAX client does; the stub's view sits under entry["rpc"]["client"]."""
    client, servers = cluster(2)
    for stub in client.sub_indexes:
        stub.RECONNECT_TIMEOUT = 0.3
    client.create_index("p", IndexCfg(index_builder_type="flat", dim=D, metric="l2",
                                      train_num=20))
    healthy = client.get_perf_stats()
    assert all("error" not in e and e["rpc"]["client"]["mux"] is True for e in healthy)
    servers[1].stop()
    stats = client.get_perf_stats()
    assert len(stats) == 2
    assert "error" not in stats[0] and "scheduler" in stats[0]
    # this very call is the one the survivor has in flight
    assert stats[0]["rpc"]["in_flight"] == 1 and stats[0]["rpc"]["mux_calls"] >= 3
    dead = stats[1]
    assert dead["server"] == client.sub_indexes[1].id
    assert (dead["host"], dead["port"]) == (client.sub_indexes[1].host,
                                            client.sub_indexes[1].port)
    assert dead["error"].split(":")[0] in ("ConnectionRefusedError", "ConnectionResetError",
                                           "BrokenPipeError", "EOFError", "OSError")
    assert "replication" in dead and "client" in dead["rpc"]
