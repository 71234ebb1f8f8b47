"""The port's lock-order witness (utils/lockdep.py) against the JAX package's.

Unit layer: each case of tests/test_lockdep.py runs through both packages'
witnesses (``ld`` is one package's module), so the port keeps the JAX
semantics: cycle-closing edges raise before blocking, re-taking a held
non-reentrant key raises, held sets are per thread, Condition.wait drops
its key, and with the knob off the factories return plain primitives.

Port layer: every pinned lock of the port is created by the factory under
the JAX package's key (a key of its own for the port-only locks); the
scheduler and the engine run clean under the witness; and the same
scheduler + rpc-mux workload through both packages records edge graphs
whose union is acyclic: the port takes no lock order the JAX package
forbids. The slow cases re-run the port's serving suites under the knob.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from distributed_faiss_tpu.utils import lockdep as jax_lockdep
from distributed_faiss_tpu_torch.utils import lockdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGIN = "distributed_faiss_tpu_torch.testing.pytest_witness"


@pytest.fixture(params=["port", "jax"])
def ld(request):
    return {"port": lockdep, "jax": jax_lockdep}[request.param]


@pytest.fixture
def witness(monkeypatch, ld):
    monkeypatch.setenv("DFT_LOCKDEP", "1")
    ld.reset()
    yield ld
    ld.reset()


# ------------------------------------------------------------------ factories

def test_disabled_returns_plain_primitives(monkeypatch, ld):
    monkeypatch.delenv("DFT_LOCKDEP", raising=False)
    monkeypatch.delenv("DFT_RACECHECK", raising=False)
    assert not ld.enabled()
    assert type(ld.lock("X.lk")) is type(threading.Lock())
    assert type(ld.rlock("X.rlk")) is type(threading.RLock())
    assert isinstance(ld.condition("X.cond"), threading.Condition)


def test_enabled_reads_env(witness):
    ld = witness
    assert ld.enabled()
    lk = ld.lock("X.lk")
    assert isinstance(lk, ld._DepLock)
    with lk:
        assert ld.held() == ("X.lk",)
    assert ld.held() == ()


# ------------------------------------------------------------ cycle detection

def test_abba_cycle_raises(witness):
    ld = witness
    a, b = ld.lock("T.a"), ld.lock("T.b")
    with a:
        with b:
            pass
    assert ("T.a", "T.b") in ld.edges()
    with b:
        with pytest.raises(ld.LockOrderError, match="T.a"):
            a.acquire()


def test_abba_across_threads_is_caught(witness):
    ld = witness
    a, b = ld.lock("AB.a"), ld.lock("AB.b")
    errors = []

    def t1():
        with a:
            with b:
                pass

    def t2():
        try:
            with b:
                with a:
                    pass  # pragma: no cover - must raise before here
        except ld.LockOrderError as e:
            errors.append(e)

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join(10.0)
        assert not th.is_alive()
    assert len(errors) == 1
    msg = str(errors[0])
    assert "AB.a" in msg and "AB.b" in msg and "cycle" in msg


def test_three_lock_cycle_chain_in_message(witness):
    ld = witness
    a, b, c = ld.lock("C.a"), ld.lock("C.b"), ld.lock("C.c")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with pytest.raises(ld.LockOrderError) as exc:
            a.acquire()
    msg = str(exc.value)
    assert "C.a -> C.b" in msg and "C.b -> C.c" in msg


def test_self_deadlock_raises(witness):
    ld = witness
    a = ld.lock("S.a")
    with a:
        with pytest.raises(ld.LockOrderError, match="re-acquires"):
            a.acquire()
    assert ld.held() == ()


def test_rlock_reentry_is_legal(witness):
    ld = witness
    r = ld.rlock("R.r")
    with r:
        with r:
            assert ld.held() == ("R.r",)
    assert ld.held() == ()


def test_consistent_order_never_raises(witness):
    ld = witness
    a, b = ld.lock("OK.a"), ld.lock("OK.b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert ld.edges().keys() == {("OK.a", "OK.b")}


# ------------------------------------------------------- held-set bookkeeping

def test_held_sets_are_per_thread(witness):
    ld = witness
    a = ld.lock("H.a")
    seen = {}

    def other():
        seen["held"] = ld.held()

    with a:
        t = threading.Thread(target=other)
        t.start()
        t.join(10.0)
        assert ld.held() == ("H.a",)
    assert seen["held"] == ()


def test_condition_wait_releases_key(witness):
    ld = witness
    cond = ld.condition("W.cond")
    with cond:
        assert ld.held() == ("W.cond",)
        assert cond.wait(0.01) is False
        assert ld.held() == ("W.cond",)
    assert ld.held() == ()


def test_condition_wait_unowned_does_not_corrupt_held(witness):
    ld = witness
    cond = ld.condition("W.unowned")
    with pytest.raises(RuntimeError):
        cond.wait(0.01)
    assert ld.held() == ()
    with cond:
        assert ld.held() == ("W.unowned",)
    assert ld.held() == ()


def test_reset_clears_edges(witness):
    ld = witness
    a, b = ld.lock("RS.a"), ld.lock("RS.b")
    with a:
        with b:
            pass
    assert ld.edges()
    ld.reset()
    assert ld.edges() == {}


def test_error_in_one_thread_leaves_witness_usable(witness):
    ld = witness
    a, b = ld.lock("E.a"), ld.lock("E.b")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(ld.LockOrderError):
            a.acquire()
    with a:
        with b:
            pass


def test_same_sequence_same_edges_and_errors_in_both_packages(monkeypatch):
    """One scripted sequence through both witnesses: the same edge set, and
    a LockOrderError at the same ABBA and three-lock steps."""
    monkeypatch.setenv("DFT_LOCKDEP", "1")

    def script(ld):
        ld.reset()
        locks = {n: ld.lock(f"P.{n}") for n in "abcd"}
        outcome = []
        for outer, inner in ("ab", "bc", "cd", "ba", "db", "ac"):
            with locks[outer]:
                try:
                    with locks[inner]:
                        outcome.append("ok")
                except ld.LockOrderError:
                    outcome.append("cycle")
        edges = set(ld.edges())
        ld.reset()
        return outcome, edges

    port, jax = script(lockdep), script(jax_lockdep)
    assert port == jax
    assert port[0] == ["ok", "ok", "ok", "cycle", "cycle", "ok"]


# ----------------------------------------------------------- the port's locks

def _port_objects(tmp_path):
    """(name, object, lock attribute, key) of every pinned lock the port
    creates per object; the caller tears the objects down."""
    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.mutation.versions import HLC
    from distributed_faiss_tpu_torch.observability.spans import SpanBuffer
    from distributed_faiss_tpu_torch.parallel import antientropy, replication, rpc
    from distributed_faiss_tpu_torch.parallel.server import IndexServer, _ConnState
    from distributed_faiss_tpu_torch.serving.scheduler import SearchScheduler
    from distributed_faiss_tpu_torch.testing.chaos import ChaosProxy, ServerHarness
    from distributed_faiss_tpu_torch.utils.atomics import AtomicCounters
    from distributed_faiss_tpu_torch.utils.batching import SearchBatcher
    from distributed_faiss_tpu_torch.utils.config import IndexCfg
    from distributed_faiss_tpu_torch.utils.tracing import LatencyStats

    eng = Index(IndexCfg(dim=8, index_builder_type="flat"), device="cpu")
    srv = IndexServer(0, str(tmp_path / "store"), device="cpu")
    sweeper = antientropy.AntiEntropySweeper(srv, str(tmp_path / "disc.txt"))
    listener = socket.socket()
    listener.bind(("localhost", 0))
    listener.listen(1)
    stub = rpc.Client(0, "localhost", listener.getsockname()[1])
    return [
        ("listener", listener, None, None),
        ("engine", eng, "buffer_lock", "Index.buffer_lock"),
        ("engine", eng, "index_lock", "Index.index_lock"),
        ("engine", eng, "_pinned_lock", "Index._pinned_lock"),
        ("engine", eng, "_tombstone_io_lock", "Index._tombstone_io_lock"),
        ("server", srv, "indexes_lock", "IndexServer.indexes_lock"),
        ("server", srv, "_threads_lock", "IndexServer._threads_lock"),
        ("server", srv, "_mux_lock", "IndexServer._mux_lock"),
        ("conn", _ConnState(None, None), "wlock", "IndexServer.conn_wlock"),
        ("scheduler", srv.scheduler, "_cond", "SearchScheduler._cond"),
        ("rpc", stub, "_lock", "Client._lock"),
        ("membership", replication.MembershipTable([0]), "_lock", "MembershipTable._lock"),
        ("repair", replication.RepairQueue(), "_lock", "RepairQueue._lock"),
        ("health", antientropy.HealthTable(), "_lock", "HealthTable._lock"),
        ("sweeper", sweeper, "_lock", "AntiEntropySweeper._lock"),
        ("hlc", HLC(), "_lock", "HLC._lock"),
        ("spans", SpanBuffer(), "_lock", "SpanBuffer._lock"),
        ("counters", AtomicCounters(), "_lock", "AtomicCounters._lock"),
        ("batcher", SearchBatcher(lambda q, k: None), "_lock", "SearchBatcher._lock"),
        ("stats", LatencyStats(), "_lock", "LatencyStats._lock"),
        ("proxy", ChaosProxy("localhost", 1), "_lock", "ChaosProxy._lock"),
        ("harness", ServerHarness(1, str(tmp_path / "d"), str(tmp_path / "s"), 1), "_lock",
         "ServerHarness._lock"),
    ]


def _teardown(objs):
    for name, obj, _, _ in objs:
        if name == "engine":
            obj.retire()
        elif name == "server":
            obj.stop()
        elif name in ("rpc", "listener"):
            obj.close()


@pytest.mark.parametrize("knob", [None, "DFT_LOCKDEP", "DFT_RACECHECK"])
def test_port_locks_use_the_factory_under_the_jax_keys(monkeypatch, tmp_path, knob):
    """Knobs off: every pinned lock of the port is a plain threading
    primitive. DFT_LOCKDEP=1 (or DFT_RACECHECK=1): each is the witness's,
    under the JAX package's key."""
    for k in ("DFT_LOCKDEP", "DFT_RACECHECK"):
        monkeypatch.delenv(k, raising=False)
    if knob:
        monkeypatch.setenv(knob, "1")
    objs = _port_objects(tmp_path)
    try:
        for name, obj, attr, key in objs[1:]:
            lk = getattr(obj, attr)
            if knob is None:
                assert type(lk) in (type(threading.Lock()), threading.Condition), (name, attr)
            else:
                assert isinstance(lk, (lockdep._DepLock, lockdep._DepCondition)), (name, attr)
                assert lk.name == key
    finally:
        _teardown(objs)


def test_port_module_locks_have_keys_of_their_own(monkeypatch):
    """The port-only module-level locks follow the knob of the process that
    imported them (off in the tier-1 run) and carry their own keys."""
    from distributed_faiss_tpu_torch.models import hnsw
    from distributed_faiss_tpu_torch.observability import spans
    from distributed_faiss_tpu_torch.ops import adc_scan, cuda_build, flat_scan

    monkeypatch.setenv("DFT_LOCKDEP", "1")
    locks = [flat_scan._counter_lock, adc_scan._counter_lock, cuda_build._lock, hnsw._lock,
             spans._local_mu]
    keys = ["flat_scan._counter_lock", "adc_scan._counter_lock", "cuda_build._lock",
            "hnsw._lock", "spans._local_mu"]
    code = ("from distributed_faiss_tpu_torch.models import hnsw\n"
            "from distributed_faiss_tpu_torch.observability import spans\n"
            "from distributed_faiss_tpu_torch.ops import adc_scan, cuda_build, flat_scan\n"
            "print([l.name for l in (flat_scan._counter_lock, adc_scan._counter_lock, "
            "cuda_build._lock, hnsw._lock, spans._local_mu)])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, DFT_LOCKDEP="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(keys)
    if os.environ.get("DFT_LOCKDEP") != "1":  # this process imported them with the knob off
        for lk in locks:
            assert type(lk) is type(threading.Lock())


def test_scheduler_runs_clean_under_witness(monkeypatch):
    """The port scheduler's real lock choreography (condition, counters,
    per-request events, batcher thread) records no 2-cycle."""
    from distributed_faiss_tpu_torch.serving.scheduler import SearchScheduler
    from distributed_faiss_tpu_torch.utils.config import SchedulerCfg

    monkeypatch.setenv("DFT_LOCKDEP", "1")
    lockdep.reset()

    def search_fn(index_id, q, k, emb):
        return (np.zeros((q.shape[0], k), np.float32),
                [[None] * k for _ in range(q.shape[0])], None)

    sched = SearchScheduler(search_fn, SchedulerCfg(max_wait_ms=1.0))
    try:
        out = sched.submit("idx", np.zeros((2, 4), np.float32), 3)
        assert out[0].shape == (2, 3)
        assert sched.perf_stats()["counters"]["batches"] == 1
    finally:
        sched.stop()
    es = set(lockdep.edges())
    assert ("SearchScheduler._cond", "AtomicCounters._lock") in es
    assert not [e for e in es if (e[1], e[0]) in es]
    lockdep.reset()


def test_engine_locks_are_instrumented(monkeypatch):
    from distributed_faiss_tpu_torch.engine import Index
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    monkeypatch.setenv("DFT_LOCKDEP", "1")
    lockdep.reset()
    idx = Index(IndexCfg(dim=8, index_builder_type="flat"), device="cpu")
    try:
        assert isinstance(idx.buffer_lock, lockdep._DepLock)
        assert isinstance(idx.index_lock, lockdep._DepLock)
        idx.add_batch(np.zeros((4, 8), np.float32), None, train_async_if_triggered=False)
        assert ("Index.index_lock", "Index.buffer_lock") not in lockdep.edges()
    finally:
        idx.retire()
        lockdep.reset()


# ------------------------------------------------------ the union of the graphs

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve_workload(server, client_cls, cfg_cls, tmp_path, name):
    """A flat index on one in-process rank; 4 threads x 10 concurrent
    searches through the multiplexed client (the scheduler merges them),
    plus stats and a save."""
    port = _free_port()
    th = threading.Thread(target=server.start_blocking, args=(port,), daemon=True)
    th.start()
    disc = tmp_path / f"disc-{name}.txt"
    disc.write_text(f"1\nlocalhost,{port}\n")
    client = client_cls(str(disc))
    try:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, 8)).astype(np.float32)
        client.create_index("u", cfg_cls(index_builder_type="flat", dim=8, metric="l2",
                                         train_num=10))
        client.add_index_data("u", x, [(i,) for i in range(300)])
        client.sync_train("u")
        errors = []

        def worker():
            try:
                for _ in range(10):
                    client.search(x[:5], 3, "u")
            except Exception as e:  # re-raised below
                errors.append(e)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
        assert not errors, errors
        client.get_perf_stats()
        client.save_index("u")
    finally:
        client.close()
        server.stop()


def _acyclic(edges) -> bool:
    graph = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    state = {}

    def visit(n):
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m) == 1 or (m not in state and not visit(m)):
                return False
        state[n] = 2
        return True

    return all(n in state or visit(n) for n in list(graph))


def test_lock_order_union_with_the_jax_package_is_acyclic(monkeypatch, tmp_path):
    """The same scheduler + rpc-mux workload through the port and the JAX
    package under DFT_LOCKDEP=1: the union of the two edge graphs has no
    cycle, so the port takes no lock order the JAX package forbids."""
    from distributed_faiss_tpu.parallel.client import IndexClient as JClient
    from distributed_faiss_tpu.parallel.server import IndexServer as JServer
    from distributed_faiss_tpu.utils.config import IndexCfg as JCfg
    from distributed_faiss_tpu_torch.parallel.client import IndexClient
    from distributed_faiss_tpu_torch.parallel.server import IndexServer
    from distributed_faiss_tpu_torch.utils.config import IndexCfg

    monkeypatch.setenv("DFT_LOCKDEP", "1")
    lockdep.reset()
    jax_lockdep.reset()
    try:
        _serve_workload(IndexServer(0, str(tmp_path / "port"), device="cpu"), IndexClient,
                        IndexCfg, tmp_path, "port")
        _serve_workload(JServer(0, str(tmp_path / "jax")), JClient, JCfg, tmp_path, "jax")
        port, jax = set(lockdep.edges()), set(jax_lockdep.edges())
    finally:
        lockdep.reset()
        jax_lockdep.reset()
    assert port and jax
    assert ("Index.index_lock", "Index.buffer_lock") not in port
    assert _acyclic(port | jax), sorted(port | jax)


def test_acyclic_helper_finds_a_cycle():
    assert _acyclic({("a", "b"), ("b", "c")})
    assert not _acyclic({("a", "b"), ("b", "c"), ("c", "a")})


# ------------------------------------------------------------------ the tier

def _suite_under(knob: str, files, timeout=2400):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **{knob: "1"})
    return subprocess.run(
        [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", PLUGIN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.slow
def test_scheduler_rpc_and_versions_suites_under_witness():
    """The port's serving, selector, wire, batching and versions suites with
    DFT_LOCKDEP=1: every pinned lock on those paths instrumented."""
    proc = _suite_under("DFT_LOCKDEP", [
        "tests/test_torch_serving.py", "tests/test_torch_selector.py",
        "tests/test_torch_wire.py", "tests/test_torch_batching.py",
        "tests/test_torch_versions.py"])
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]


@pytest.mark.slow
def test_mesh_serving_suite_under_witness():
    proc = _suite_under("DFT_LOCKDEP", ["tests/test_torch_mesh_serving.py",
                                        "tests/test_torch_sharded_ivf.py"])
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
