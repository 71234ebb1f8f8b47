"""Scheduler result-identity and ordering guarantees of the port, end to
end (the port of tests/test_scheduler_identity.py, case by case, on
``device="cpu"``).

The serving scheduler must be invisible in results: N concurrent clients
through the scheduler get BYTE-IDENTICAL (scores, meta) to direct
(scheduler-off) serving, in both serving loops. Under faults (rank
SIGKILL mid-batch) callers may see transport errors or BUSY — never
another caller's rows.

Cases already held elsewhere in the port's tests, and not repeated here:
``test_torch_selector.py::test_eight_clients_byte_identical`` holds eight
clients against the engine's own answers in both loops with the mux and
the serial client; ``test_torch_serving.py::test_scheduler_coalesces_and_sheds``
holds the scheduler object's coalescing, SchedulerBusy and pre-launch
deadline refusal. The cases below hold the same guarantees over the wire:
scheduler on against scheduler off, BUSY frames and the client's retry,
a deadline shed inside the server, the mesh-backed rank (one counted
launch a window; no program captured after warm-up, read through the
port's ``compilecheck`` with ``programs.RecordingGraphs`` standing in for
CUDA graphs on the CPU) and the rank SIGKILLed mid-batch (slow, as in
JAX).
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.utils import compilecheck, programs, racecheck

from distributed_faiss_tpu_torch import (
    IndexCfg,
    IndexClient,
    IndexServer,
    IndexState,
    SchedulerCfg,
)
from distributed_faiss_tpu_torch.parallel import rpc

from netutil import free_base, free_port

pytestmark = pytest.mark.scheduler

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_listening(port, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            socket.create_connection(("localhost", port), timeout=1).close()
            return True
        except OSError:
            time.sleep(0.05)
    return False


def write_discovery(tmp_path, ports, name):
    p = tmp_path / name
    p.write_text("\n".join(
        [str(len(ports))] + [f"localhost,{port}" for port in ports]) + "\n")
    return str(p)


def start_server(storage, mode, sched_cfg):
    port = free_port()
    srv = IndexServer(0, str(storage), scheduler_cfg=sched_cfg, device="cpu")
    target = srv.start_blocking if mode == "blocking" else srv.start
    threading.Thread(target=target, args=(port,), daemon=True).start()
    assert wait_listening(port)
    return srv, port


def flat_cfg():
    return IndexCfg(index_builder_type="flat", dim=16, metric="l2",
                    train_num=64)


def build_corpus(rng_seed=0, n=600, d=16):
    rng = np.random.default_rng(rng_seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    meta = [("doc", i) for i in range(n)]
    queries = [rng.standard_normal((4, d)).astype(np.float32)
               for _ in range(8)]
    return x, meta, queries


def fill_and_train(disc, index_id, x, meta):
    client = IndexClient(disc)
    client.create_index(index_id, flat_cfg())
    for s in range(0, x.shape[0], 100):
        client.add_index_data(index_id, x[s:s + 100], meta[s:s + 100])
    client.sync_train(index_id)
    deadline = time.time() + 60
    while client.get_state(index_id) != IndexState.TRAINED:
        assert time.time() < deadline, "train timed out"
        time.sleep(0.1)
    # wait for the async add drain so both clusters serve the full corpus
    while client.get_buffer_depth(index_id) > 0:
        assert time.time() < deadline, "add drain timed out"
        time.sleep(0.1)
    return client


@pytest.mark.parametrize("mode", ["blocking", "selector"])
def test_concurrent_clients_identical_to_direct_serving(tmp_path, mode):
    """8 concurrent clients x 5 searches through the scheduler vs direct
    serving: every (scores, meta) pair must match exactly."""
    x, meta, queries = build_corpus()
    index_id = f"ident_{mode}"
    setups = {}
    for arm, enabled in (("on", True), ("off", False)):
        cfg = SchedulerCfg(enabled=enabled, max_wait_ms=3.0)
        srv, port = start_server(tmp_path / arm, mode, cfg)
        disc = write_discovery(tmp_path, [port], f"{arm}.txt")
        admin = fill_and_train(disc, index_id, x, meta)
        admin.close()
        setups[arm] = (srv, disc)
    assert setups["on"][0].scheduler is not None
    assert setups["off"][0].scheduler is None

    results = {"on": {}, "off": {}}
    errors = []

    def client_thread(arm, tid):
        try:
            c = IndexClient(setups[arm][1], None)
            c.cfg = flat_cfg()
            out = []
            for _ in range(5):
                scores, m = c.search(queries[tid], 3, index_id)
                out.append((scores.copy(), m))
            results[arm][tid] = out
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append((arm, tid, e))

    for arm in ("on", "off"):
        ts = [threading.Thread(target=client_thread, args=(arm, t))
              for t in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errors, errors[:2]

    for tid in range(8):
        for (s_on, m_on), (s_off, m_off) in zip(
                results["on"][tid], results["off"][tid]):
            assert s_on.dtype == s_off.dtype
            np.testing.assert_array_equal(s_on, s_off)
            assert m_on == m_off
    # the scheduler actually served these (not silently bypassed), and the
    # new observability fields travel through the get_perf_stats RPC
    stats = setups["on"][0].get_perf_stats()
    assert stats["scheduler"]["counters"]["submitted"] >= 40
    assert "p99_s" in stats["scheduler"]["queues"]["queue_wait_s"]
    for arm in setups:
        setups[arm][0].stop()


def test_return_embeddings_identical_through_scheduler(tmp_path):
    x, meta, queries = build_corpus()
    index_id = "ident_embs"
    arms = {}
    for arm, enabled in (("on", True), ("off", False)):
        srv, port = start_server(
            tmp_path / arm, "blocking", SchedulerCfg(enabled=enabled))
        disc = write_discovery(tmp_path, [port], f"{arm}.txt")
        admin = fill_and_train(disc, index_id, x, meta)
        arms[arm] = (srv, admin)
    out = {}
    for arm, (_srv, client) in arms.items():
        out[arm] = client.search(queries[0], 3, index_id,
                                 return_embeddings=True)
    s_on, m_on, e_on = out["on"]
    s_off, m_off, e_off = out["off"]
    np.testing.assert_array_equal(s_on, s_off)
    assert m_on == m_off
    for row_on, row_off in zip(e_on, e_off):
        for a, b in zip(row_on, row_off):
            np.testing.assert_array_equal(a, b)
    for arm, (srv, client) in arms.items():
        client.close()
        srv.stop()


def test_busy_backpressure_and_client_retry(tmp_path):
    """A saturated 1-deep queue rejects with a structured BUSY frame; a raw
    stub surfaces rpc.BusyError, while IndexClient's RetryPolicy backoff
    rides it out and still gets the right answer."""
    x, meta, queries = build_corpus()
    index_id = "busy"
    srv, port = start_server(
        tmp_path / "srv", "blocking",
        SchedulerCfg(max_wait_ms=0.0, max_batch_rows=1, max_queue=1))
    disc = write_discovery(tmp_path, [port], "srv.txt")
    admin = fill_and_train(disc, index_id, x, meta)
    golden = admin.search(queries[0], 3, index_id)

    # slow every scheduled launch so the queue saturates deterministically
    engine = srv.indexes[index_id]
    orig = engine.search_batched

    def slow_search(*a, **k):
        time.sleep(0.4)
        return orig(*a, **k)

    engine.search_batched = slow_search
    try:
        stubs = [rpc.Client(i, "localhost", port) for i in range(3)]
        outcomes = []

        def one(stub):
            try:
                outcomes.append(
                    ("ok", stub.generic_fun(
                        "search", (index_id, queries[0], 3))))
            except rpc.BusyError as e:
                outcomes.append(("busy", e))

        ts = []
        for stub in stubs:  # stagger: launch-occupant, queued, rejected
            t = threading.Thread(target=one, args=(stub,))
            t.start()
            ts.append(t)
            time.sleep(0.1)
        for t in ts:
            t.join()
        kinds = sorted(k for k, _ in outcomes)
        assert kinds == ["busy", "ok", "ok"], outcomes
        busy = next(e for k, e in outcomes if k == "busy")
        assert busy.info["reason"] == "queue_full"
        # the successes returned the exact direct-serving answer
        for k, v in outcomes:
            if k == "ok":
                np.testing.assert_array_equal(v[0], golden[0])
                assert v[1] == golden[1]
        assert srv.scheduler.perf_stats()["counters"]["rejected_busy"] >= 1

        # IndexClient with a patient RetryPolicy absorbs BUSY transparently
        patient = IndexClient(disc, None, retry_policy=rpc.RetryPolicy(
            max_attempts=8, base_delay=0.1, jitter=0.0))
        patient.cfg = flat_cfg()
        blocker = threading.Thread(target=one, args=(stubs[0],))
        filler = threading.Thread(target=one, args=(stubs[1],))
        blocker.start()
        time.sleep(0.1)
        filler.start()
        time.sleep(0.05)
        scores, m = patient.search(queries[0], 3, index_id)
        np.testing.assert_array_equal(scores, golden[0])
        assert m == golden[1]
        blocker.join()
        filler.join()
        for stub in stubs:
            stub.close()
        patient.close()
    finally:
        engine.search_batched = orig
    admin.close()
    srv.stop()


def test_deadline_shed_serverside_without_touching_device(tmp_path):
    """A request whose stamped deadline expires while queued is shed by the
    scheduler: the engine never sees it, and the shed counter records it.
    No kernel wrapper counts a launch (on the CPU they run their plain
    versions, so the counts stay 0 whatever is served)."""
    x, meta, queries = build_corpus()
    index_id = "shed"
    srv, port = start_server(
        tmp_path / "srv", "blocking",
        SchedulerCfg(max_wait_ms=0.0, max_batch_rows=1, max_queue=8))
    disc = write_discovery(tmp_path, [port], "srv.txt")
    admin = fill_and_train(disc, index_id, x, meta)

    engine = srv.indexes[index_id]
    orig = engine.search_batched
    launches = []

    def slow_search(*a, **k):
        launches.append(a[0].shape)
        time.sleep(0.5)
        return orig(*a, **k)

    engine.search_batched = slow_search
    try:
        c1 = rpc.Client(1, "localhost", port)
        c2 = rpc.Client(2, "localhost", port)
        t1 = threading.Thread(target=lambda: c1.generic_fun(
            "search", (index_id, queries[0], 3)))
        t1.start()
        time.sleep(0.15)  # c1's launch is in flight; c2 queues behind it
        with pytest.raises(rpc.DeadlineExceeded):
            # 0.2s budget < the 0.35s left of c1's launch: expires queued,
            # the server sheds it at flush and its structured BUSY(deadline)
            # frame arrives within the client's grace window
            c2.generic_fun("search", (index_id, queries[0], 3),
                           deadline=time.time() + 0.2)
        t1.join()
        deadline = time.time() + 5
        while not srv.scheduler.perf_stats()["counters"]["shed_deadline"]:
            assert time.time() < deadline, "request was never shed"
            time.sleep(0.05)
        time.sleep(0.2)  # would-be second launch window
        assert len(launches) == 1  # c2's rows never reached the engine
        assert set(srv.ping()["kernels"].values()) == {0}
        c1.close()
        c2.close()
    finally:
        engine.search_batched = orig
    admin.close()
    srv.stop()


@pytest.fixture
def host_mesh(monkeypatch):
    """The rank's host mesh: 4 virtual shards on the CPU, no compaction
    watcher."""
    monkeypatch.setenv("DFT_MESH_DEVICES", "4")
    monkeypatch.setenv("DFT_MESH_VIRTUAL", "1")
    monkeypatch.delenv("DFT_MESH_MODE", raising=False)
    monkeypatch.setenv("DFT_COMPACT", "0")


@pytest.mark.mesh
def test_mesh_backed_clients_identical_and_one_launch_per_window(tmp_path, host_mesh):
    """A mesh-backed rank (flat corpus sharded over 4 virtual shards)
    serving 8 concurrent clients through the scheduler is byte-identical
    to scheduler-off serving, AND every merged window costs exactly ONE
    counted model call (the engine's perf counters pin it)."""
    x, meta, queries = build_corpus()
    index_id = "mesh_ident"
    mesh_cfg = IndexCfg(index_builder_type="flat", dim=16, metric="l2",
                        train_num=64, mesh_shards=True)
    setups = {}
    for arm, enabled in (("on", True), ("off", False)):
        cfg = SchedulerCfg(enabled=enabled, max_wait_ms=3.0)
        srv, port = start_server(tmp_path / arm, "blocking", cfg)
        disc = write_discovery(tmp_path, [port], f"mesh_{arm}.txt")
        admin = IndexClient(disc)
        admin.create_index(index_id, mesh_cfg)
        for s in range(0, x.shape[0], 100):
            admin.add_index_data(index_id, x[s:s + 100], meta[s:s + 100])
        admin.sync_train(index_id)
        deadline = time.time() + 120
        while (admin.get_state(index_id) != IndexState.TRAINED
               or admin.get_buffer_depth(index_id) > 0):
            assert time.time() < deadline, "mesh train/drain timed out"
            time.sleep(0.1)
        admin.close()
        setups[arm] = (srv, disc)
    from distributed_faiss_tpu_torch.parallel.mesh import ShardedFlatIndex

    for arm in setups:
        with racecheck.peeking():  # white-box peek, reviewed
            assert isinstance(setups[arm][0].indexes[index_id].model,
                              ShardedFlatIndex)

    results = {"on": {}, "off": {}}
    errors = []

    def client_thread(arm, tid):
        try:
            c = IndexClient(setups[arm][1], None)
            c.cfg = mesh_cfg
            out = []
            for _ in range(5):
                scores, m = c.search(queries[tid], 3, index_id)
                out.append((scores.copy(), m))
            results[arm][tid] = out
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append((arm, tid, e))

    for arm in ("on", "off"):
        ts = [threading.Thread(target=client_thread, args=(arm, t))
              for t in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errors, errors[:2]

    for tid in range(8):
        for (s_on, m_on), (s_off, m_off) in zip(
                results["on"][tid], results["off"][tid]):
            np.testing.assert_array_equal(s_on, s_off)
            assert m_on == m_off

    # launch-count assertion: one device launch per merged window — every
    # scheduler flush became exactly one dispatch on the mesh
    stats = setups["on"][0].get_perf_stats()
    eng = stats["engine"][index_id]
    sched = stats["scheduler"]["counters"]
    assert sched["submitted"] >= 40
    assert eng["device_launches"]["max_s"] == 1.0, eng["device_launches"]
    assert eng["device_launches"]["count"] == sched["batches"], (
        eng["device_launches"], sched)
    assert eng["rows_per_launch"]["max_s"] >= 4.0  # windows really merged rows
    for arm in setups:
        setups[arm][0].stop()


@pytest.mark.mesh
@pytest.mark.compilecheck
def test_mesh_serving_compiles_nothing_after_warmup(tmp_path, host_mesh):
    """Steady-state compile budget: after warming every pow2 query bucket
    an 8-client storm can reach (windows merge 1..8 four-row requests ->
    4..32 rows -> buckets 8/16/32), the storm itself must capture ZERO new
    programs — on a card each capture is a stall on the serving path, so
    a capture here means the bucketing leaked a fresh key. The
    compile-count witness (utils/compilecheck.py, DFT_COMPILECHECK)
    supplies the tally; ``programs.RecordingGraphs`` stands in for the
    CUDA graph backend on the CPU, so the served model captures and
    replays as it would on a card. The test force-installs the witness so
    the budget is pinned in tier-1 too."""
    x, meta, queries = build_corpus()
    index_id = "mesh_budget"
    mesh_cfg = IndexCfg(index_builder_type="flat", dim=16, metric="l2",
                        train_num=64, mesh_shards=True)
    installed_here = not compilecheck._installed
    compilecheck.install()
    try:
        srv, port = start_server(tmp_path / "srv", "blocking",
                                 SchedulerCfg(enabled=True, max_wait_ms=3.0))
        disc = write_discovery(tmp_path, [port], "budget.txt")
        admin = IndexClient(disc)
        admin.create_index(index_id, mesh_cfg)
        for s in range(0, x.shape[0], 100):
            admin.add_index_data(index_id, x[s:s + 100], meta[s:s + 100])
        admin.sync_train(index_id)
        deadline = time.time() + 120
        while (admin.get_state(index_id) != IndexState.TRAINED
               or admin.get_buffer_depth(index_id) > 0):
            assert time.time() < deadline, "mesh train/drain timed out"
            time.sleep(0.1)
        with racecheck.peeking():  # white-box: the served model's programs
            model = srv.indexes[index_id].model
            backend = model.programs.backend = programs.RecordingGraphs()

        # warmup: touch every reachable query bucket through the real
        # serving path (single client -> one window per request)
        rng = np.random.default_rng(7)
        for rows in (4, 8, 16, 32):
            q = rng.standard_normal((rows, 16)).astype(np.float32)
            admin.search(q, 3, index_id)
        assert any(k.startswith("capture:") for k in compilecheck.counts()), (
            "compile witness saw no capture at all — the program cache is "
            "not wired to it")
        snap = compilecheck.snapshot()

        errors = []

        def client_thread(tid):
            try:
                c = IndexClient(disc, None)
                c.cfg = mesh_cfg
                for _ in range(5):
                    c.search(queries[tid], 3, index_id)
                c.close()
            except Exception as e:  # pragma: no cover
                errors.append((tid, e))

        ts = [threading.Thread(target=client_thread, args=(t,))
              for t in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors[:2]
        fresh = compilecheck.new_since(snap)
        assert not fresh, (
            f"steady-state serving window captured new programs "
            f"after warmup: {fresh}")
        sched = srv.get_perf_stats()["scheduler"]["counters"]
        assert sched["submitted"] >= 40  # the storm really went through
        assert backend.replays >= sched["batches"] > 0  # served by replays
        admin.close()
        srv.stop()
    finally:
        if installed_here:
            compilecheck.uninstall()


@pytest.mark.slow
def test_rank_sigkill_mid_batch_never_crosses_results(tmp_path):
    """Chaos case: SIGKILL the rank while 6 clients hammer the scheduler.
    Every outcome must be either the exact golden answer for THAT client's
    query or a transport/BUSY/deadline error — never another caller's
    rows."""
    from distributed_faiss_tpu_torch.testing.chaos import ServerHarness

    x, meta, queries = build_corpus()
    index_id = "chaos"
    disc = str(tmp_path / "disc.txt")
    harness = ServerHarness(1, disc, str(tmp_path / "storage"),
                            base_port=free_base(1), env={"PYTHONPATH": REPO_ROOT},
                            device="cpu")
    with harness:
        admin = fill_and_train(disc, index_id, x, meta)
        goldens = {t: admin.search(queries[t], 3, index_id)
                   for t in range(6)}
        admin.close()

        bad = []
        stop = threading.Event()

        def storm(tid):
            c = IndexClient(disc, None)
            c.cfg = flat_cfg()
            while not stop.is_set():
                try:
                    scores, m = c.search(queries[tid], 3, index_id)
                except (rpc.TRANSPORT_ERRORS + (
                        rpc.BusyError, rpc.DeadlineExceeded)):
                    continue  # shed/killed: acceptable, results withheld
                if not (np.array_equal(scores, goldens[tid][0])
                        and m == goldens[tid][1]):
                    bad.append((tid, scores, m))  # pragma: no cover
            c.close()

        ts = [threading.Thread(target=storm, args=(t,)) for t in range(6)]
        for t in ts:
            t.start()
        time.sleep(1.0)   # storm against the live rank
        harness.kill(0)   # mid-batch SIGKILL
        time.sleep(1.0)   # storm against the corpse
        stop.set()
        for t in ts:
            t.join()
    assert not bad, f"cross-caller results surfaced: {bad[:1]}"
