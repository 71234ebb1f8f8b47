"""The kill cases of tests/test_chaos.py, ported: real port rank
processes (``device="cpu"``) driven by the port's ``ServerHarness``, slow
as in JAX:

(a) search(allow_partial=True) keeps serving from survivors under rank
    death, and the restarted rank serves the full corpus again;
(b) every batch acknowledged by add_index_data is present in get_ids()
    after recovery (reroute + restart);
(c) a shard killed at a random point during save() loads the latest
    complete generation — never a torn set — on restart, on one device
    and on the port's virtual CPU mesh.

The link-fault cases of tests/test_chaos.py are in tests/test_torch_chaos.py.
One fast case (tier-1) holds the two packages to each other: a storage dir
left by a SIGKILLed port saver loads in the JAX package and serves the
same rows as it does in the port.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.parallel.client import IndexClient, MultiRankError
from distributed_faiss_tpu_torch.testing.chaos import ServerHarness
from distributed_faiss_tpu_torch.utils import serialization
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

pytestmark = [pytest.mark.chaos]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO_ROOT}


def free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def flat_cfg(**kw):
    kw.setdefault("index_builder_type", "flat")
    kw.setdefault("dim", 16)
    kw.setdefault("metric", "l2")
    kw.setdefault("train_num", 50)
    return IndexCfg(**kw)


def wait_drained(client, index_id, n, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if (client.get_state(index_id) == IndexState.TRAINED
                and client.get_buffer_depth(index_id) == 0
                and client.get_ntotal(index_id) >= n):
            return
        time.sleep(0.2)
    raise AssertionError(f"cluster never drained to {n} indexed rows")


# --------------------------------------------------- (a) search under kill


@pytest.mark.slow
def test_search_survives_kill_and_restart(tmp_path):
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(3, disc, storage, base_port=free_port(), env=ENV,
                       device="cpu") as h:
        client = IndexClient(disc)
        client.create_index("cidx", flat_cfg())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, 16)).astype(np.float32)
        for s in range(0, 300, 50):
            client.add_index_data("cidx", x[s:s + 50],
                                  [(i,) for i in range(s, s + 50)])
        wait_drained(client, "cidx", 300)
        client.save_index("cidx")

        victim = 1
        h.kill(victim)
        scores, metas, missing = client.search(
            x[:20], 5, "cidx", allow_partial=True, partial_timeout=15.0)
        assert len(missing) == 1 and missing[0]["port"] == h.port(victim)
        assert scores.shape == (20, 5)

        h.restart(victim, load_index=True)
        h.wait_port(victim)
        deadline = time.time() + 60
        while True:
            try:
                assert client.load_index("cidx", force_reload=False)
                break
            except (OSError, MultiRankError):
                assert time.time() < deadline, "restarted rank never rejoined"
                time.sleep(0.3)
        scores, metas, missing = client.search(
            x[:20], 5, "cidx", allow_partial=True, partial_timeout=15.0)
        assert missing == []
        for i in range(20):
            assert metas[i][0] == (i,)  # full corpus self-hits again
        client.close()


# ------------------------------------ (b) ingest under mid-stream rank death


@pytest.mark.slow
def test_ingest_rank_death_zero_acked_batch_loss(tmp_path):
    """Kill a rank mid-ingest: batches placed on it REROUTE to survivors;
    after restarting the victim from its last save, every id whose batch
    was ACKNOWLEDGED is present in get_ids()."""
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "storage")
    with ServerHarness(3, disc, storage, base_port=free_port(), env=ENV,
                       device="cpu") as h:
        client = IndexClient(disc)
        client.create_index("zidx", flat_cfg())
        rng = np.random.default_rng(1)
        x = rng.standard_normal((900, 16)).astype(np.float32)

        acked = set()
        # phase 1: healthy ingest, then make it durable everywhere
        for s in range(0, 300, 50):
            ids = [(i,) for i in range(s, s + 50)]
            client.add_index_data("zidx", x[s:s + 50], ids)
            acked.update(i for (i,) in ids)
        wait_drained(client, "zidx", 300)
        client.save_index("zidx")

        # phase 2: kill one rank mid-stream; every add must still ack
        victim = 2
        h.kill(victim)
        for s in range(300, 900, 50):
            ids = [(i,) for i in range(s, s + 50)]
            client.add_index_data("zidx", x[s:s + 50], ids)  # never raises
            acked.update(i for (i,) in ids)
        assert client.reroutes, "dead rank was never skipped?"
        # discovery-file order (= stub id order) is registration order, not
        # rank order: identify the victim's stub by its port
        victim_stub = next(s.id for s in client.sub_indexes
                           if s.port == h.port(victim))
        assert {r["skipped_server"] for r in client.reroutes} == {victim_stub}
        assert all(r["port"] == h.port(victim) for r in client.reroutes)

        # recovery: restart the victim from its snapshot
        h.restart(victim, load_index=True)
        h.wait_port(victim)
        deadline = time.time() + 60
        while True:
            try:
                client.load_index("zidx", force_reload=False)
                break
            except (OSError, MultiRankError):
                assert time.time() < deadline
                time.sleep(0.3)
        deadline = time.time() + 120
        while client.get_buffer_depth("zidx") > 0:
            assert time.time() < deadline
            time.sleep(0.2)

        present = set(client.get_ids("zidx"))  # ids extracted from meta[0]
        lost = acked - present
        assert not lost, f"{len(lost)} acknowledged ids lost: {sorted(lost)[:10]}"
        client.close()


# -------------------------------------------- (c) kill -9 during save sweep

# a port shard that adds 40 rows, waits for the drain and saves, in a loop
SAVER = r"""
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from distributed_faiss_tpu_torch.engine import Index
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState
storage = sys.argv[1]
cfg = IndexCfg(index_builder_type='flat', dim=16, metric='l2',
               train_num=20, index_storage_dir=storage, **{extra!r})
idx = Index(cfg, device='cpu')
rng = np.random.default_rng(0)
rows = 0
x = rng.standard_normal((40, 16)).astype(np.float32)
idx.add_batch(x, [('m', rows + i) for i in range(40)],
              train_async_if_triggered=False)
rows += 40
while idx.get_state() != IndexState.TRAINED:
    time.sleep(0.01)
print('READY', flush=True)
while True:
    x = rng.standard_normal((40, 16)).astype(np.float32)
    idx.add_batch(x, [('m', rows + i) for i in range(40)],
                  train_async_if_triggered=False)
    rows += 40
    while idx.get_idx_data_num()[0] > 0:
        time.sleep(0.005)
    idx.save()
"""


def kill_saver(tmp_path, name, kill_rng, env=None, extra=None, first_timeout=60):
    """Start a saver, wait for its first committed generation, SIGKILL it
    at a random later moment; its storage dir."""
    saver = tmp_path / f"{name}.py"
    saver.write_text(SAVER.format(repo=REPO_ROOT, extra=extra or {}))
    storage = str(tmp_path / name)
    proc = subprocess.Popen([sys.executable, str(saver), storage],
                            stdout=subprocess.PIPE, text=True,
                            env={**os.environ, **ENV, **(env or {})})
    try:
        assert proc.stdout.readline().strip() == "READY"
        # wait until at least one generation has COMMITTED, then SIGKILL at
        # a random later moment — each trial lands at a different byte
        # offset of some in-flight save
        deadline = time.time() + first_timeout
        while not serialization.list_generations(storage):
            assert time.time() < deadline, "first save never committed"
            time.sleep(0.01)
        time.sleep(float(kill_rng.uniform(0.0, 0.8)))
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == -signal.SIGKILL
    return storage


def check_loaded(loaded, trial):
    """The loaded generation is internally consistent: saves only ever
    committed drained multiples of 40 rows, and ids join cleanly."""
    assert loaded is not None, f"trial {trial}: nothing loadable"
    n = loaded.model.ntotal
    assert n >= 40 and n % 40 == 0, (trial, n)
    assert len(loaded.id_to_metadata) == n
    scores, meta, _ = loaded.search(np.zeros((2, 16), np.float32), 3)
    assert all(m is None or m[0] == "m" for row in meta for m in row)
    return n


@pytest.mark.slow
def test_snapshot_kill9_sweep(tmp_path):
    """SIGKILL a saving shard at randomized points in the save; the restart
    must always load the latest COMPLETE generation (possibly the one being
    written, if its manifest landed) and serve consistent metadata."""
    kill_rng = np.random.default_rng(42)
    for trial in range(5):
        storage = kill_saver(tmp_path, f"shard-{trial}", kill_rng)
        loaded = Index.from_storage_dir(storage, device="cpu")
        check_loaded(loaded, trial)
        # a committed generation survived the kill (the torn one, if any,
        # is quarantined — never silently consumed)
        assert serialization.list_generations(storage)
        loaded.retire()


@pytest.mark.slow
@pytest.mark.mesh
def test_snapshot_kill9_mesh_sweep(tmp_path, monkeypatch):
    """Mesh-backed variant of the kill -9 sweep: a rank whose corpus is
    sharded over 8 virtual shards of the port's CPU mesh is SIGKILLed at
    random points during save; the restart must load the latest COMPLETE
    generation through the checksum-verified fallback and serve it from a
    (re-built) sharded index."""
    from distributed_faiss_tpu_torch.parallel.mesh import ShardedFlatIndex

    mesh_env = {"DFT_MESH_DEVICES": "8", "DFT_MESH_VIRTUAL": "1"}
    for k, v in mesh_env.items():
        monkeypatch.setenv(k, v)  # the restores here build the same mesh
    kill_rng = np.random.default_rng(7)
    for trial in range(3):
        storage = kill_saver(tmp_path, f"mesh-shard-{trial}", kill_rng, env=mesh_env,
                             extra={"mesh_shards": True}, first_timeout=120)
        loaded = Index.from_storage_dir(storage, device="cpu")
        check_loaded(loaded, trial)
        assert isinstance(loaded.model, ShardedFlatIndex)
        assert loaded.model.mesh.size == 8
        # the restored rank serves the merged-window contract: one launch
        s = loaded.perf.summary()
        assert s["device_launches"]["max_s"] == 1.0
        assert serialization.list_generations(storage)
        loaded.retire()


def test_killed_port_saver_dir_loads_in_jax_alike(tmp_path):
    """A dir left by a SIGKILLed port saver (killed at a random moment
    past its first commit) loads in the JAX package: the same generation,
    rows and metadata, and the same top-k rows and distances (within
    1e-3) as the port serves from it."""
    from distributed_faiss_tpu.engine import Index as JIndex

    kill_rng = np.random.default_rng(3)
    for trial in range(2):
        storage = kill_saver(tmp_path, f"parity-{trial}", kill_rng)
        t = Index.from_storage_dir(storage, device="cpu")
        j = JIndex.from_storage_dir(storage)
        try:
            n = check_loaded(t, trial)
            assert j.tpu_index.ntotal == n
            assert t.current_generation() == j.current_generation()
            assert t.id_to_metadata.tolist() == j.id_to_metadata.tolist()
            q = np.random.default_rng(trial).standard_normal((8, 16)).astype(np.float32)
            t_scores, t_meta, _ = t.search(q, 5)
            j_scores, j_meta, _ = j.search(q, 5)
            assert t_meta == j_meta
            np.testing.assert_allclose(t_scores, j_scores, rtol=1e-3, atol=1e-3)
        finally:
            t.retire()
            j.retire()
