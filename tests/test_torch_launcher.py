"""The port's SLURM launch and its command-line entry points on the CPU:
``launch_slurm`` against a stand-in submitit gives the JAX package's
executor parameters for the same arguments, refuses without submitit, and
its task body runs ``run_server`` from srun's environment; the
``server_launcher`` and ``load_data`` entry points parse the JAX scripts'
arguments plus ``--device`` and drive a cluster."""

import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from distributed_faiss_tpu.parallel import launcher as jlauncher
from distributed_faiss_tpu_torch.parallel import launcher, replication
from distributed_faiss_tpu_torch.parallel.client import IndexClient
from distributed_faiss_tpu_torch.parallel.server import IndexServer
from distributed_faiss_tpu_torch.scripts import load_data, server_launcher
from distributed_faiss_tpu_torch.utils.config import IndexCfg
from distributed_faiss_tpu_torch.utils.state import IndexState

from netutil import free_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fake_submitit(recorded, global_rank=5, local_rank=2):
    class JobEnvironment:
        pass

    JobEnvironment.global_rank = global_rank
    JobEnvironment.local_rank = local_rank

    class AutoExecutor:
        def __init__(self, folder):
            recorded["folder"] = folder

        def update_parameters(self, **kw):
            recorded["params"] = kw

        def submit(self, fn):
            recorded["task"] = fn
            return "fake-job"

    mod = types.ModuleType("submitit")
    mod.JobEnvironment = JobEnvironment
    mod.AutoExecutor = AutoExecutor
    return mod


@pytest.mark.parametrize("kwargs", [
    dict(num_servers=6, num_servers_per_node=2),
    dict(num_servers=7, num_servers_per_node=3, base_port=14000, partition="dev", mem_gb=64,
         timeout_min=30, log_dir="logs", load_index=True),
])
def test_slurm_parameters_match_jax(tmp_path, monkeypatch, kwargs):
    recorded, jrecorded = {}, {}
    monkeypatch.setitem(sys.modules, "submitit", fake_submitit(recorded))
    disc = str(tmp_path / "disc.txt")
    storage = str(tmp_path / "st")
    assert launcher.launch_slurm(discovery_path=disc, storage_dir=storage,
                                 **kwargs) == "fake-job"
    assert open(disc).readline().strip() == str(kwargs["num_servers"])
    monkeypatch.setitem(sys.modules, "submitit", fake_submitit(jrecorded))
    jlauncher.launch_slurm(discovery_path=str(tmp_path / "jdisc.txt"), storage_dir=storage,
                           **kwargs)
    assert recorded["params"] == jrecorded["params"]
    assert recorded["folder"] == jrecorded["folder"]
    p = recorded["params"]
    assert p["nodes"] == -(-kwargs["num_servers"] // kwargs["num_servers_per_node"])


def test_slurm_task_runs_run_server_on_the_device(tmp_path, monkeypatch):
    recorded, served = {}, {}
    monkeypatch.setitem(sys.modules, "submitit", fake_submitit(recorded))
    disc = str(tmp_path / "disc.txt")
    launcher.launch_slurm(6, 2, disc, str(tmp_path / "st"), base_port=14000, device="cpu")

    def fake_run_server(rank, port, dp, sd, load, device):
        served.update(rank=rank, port=port, disc=dp, storage=sd, load=load, device=device)

    monkeypatch.setattr(launcher, "run_server", fake_run_server)
    recorded["task"]()
    assert served == dict(rank=5, port=14002, disc=disc, storage=str(tmp_path / "st"),
                          load=False, device="cpu")


def test_slurm_without_submitit_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "submitit", None)
    with pytest.raises(RuntimeError, match="submitit is not installed"):
        launcher.launch_slurm(1, 1, str(tmp_path / "d.txt"), str(tmp_path / "s"))


def _wait_ntotal(client, iid, n, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if client.get_state(iid) == IndexState.TRAINED and client.get_ntotal(iid) == n:
            return True
        time.sleep(0.1)
    return False


def start_fake_srun(tmp_path, base_port, num_servers=2):
    """One process per task with srun's rank variables: each rebuilds (rank,
    port) through a JobEnvironment reading them, as launch_slurm's task
    does, and runs the port's run_server on the CPU, registering itself by
    host name. Returns the discovery file, the processes and their stderr
    files."""
    disc, storage = str(tmp_path / "disc.txt"), str(tmp_path / "storage")
    launcher.write_discovery_header(disc, num_servers)
    worker = tmp_path / "slurm_task.py"
    worker.write_text(
        "import os, sys, types\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "submitit = types.ModuleType('submitit')\n"
        "class JobEnvironment:\n"
        "    def __init__(self):\n"
        "        self.global_rank = int(os.environ['SLURM_PROCID'])\n"
        "        self.local_rank = int(os.environ['SLURM_LOCALID'])\n"
        "submitit.JobEnvironment = JobEnvironment\n"
        "sys.modules['submitit'] = submitit\n"
        "from distributed_faiss_tpu_torch.parallel.launcher import run_server\n"
        "env = submitit.JobEnvironment()\n"
        f"run_server(env.global_rank, {base_port} + env.local_rank, {disc!r}, {storage!r}, "
        "False, device='cpu')\n")
    procs, errs = [], []
    for rank in range(num_servers):
        errs.append(tmp_path / f"rank{rank}.err")
        with open(errs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, str(worker)],
                env={**os.environ, "PYTHONPATH": REPO, "SLURM_PROCID": str(rank),
                     "SLURM_LOCALID": str(rank), "SLURM_NTASKS": str(num_servers),
                     "SLURM_NODEID": "0", "DFT_ANTIENTROPY": "0"},
                stdout=subprocess.DEVNULL, stderr=err))
    return disc, procs, errs


def wait_for_ranks(disc, procs, errs, timeout=60.0):
    """Until the discovery file lists every rank. A rank that exits first,
    or a deadline that passes, fails with the ranks' stderr: the client's
    own wait for a rank that never registers is two hours long."""
    deadline = time.monotonic() + timeout
    while True:
        with open(disc) as f:
            num_servers, entries = replication.parse_discovery_lines(f)
        if len(entries) >= num_servers:
            return
        for rank, p in enumerate(procs):
            if p.poll() is not None:
                raise AssertionError(f"rank {rank} exited with code {p.returncode} before it "
                                     f"registered; its stderr:\n{errs[rank].read_text()}")
        if time.monotonic() > deadline:
            raise AssertionError(
                f"{len(entries)} of {num_servers} ranks registered within {timeout} s:\n"
                + "\n".join(f"rank {r} stderr:\n{e.read_text()}" for r, e in enumerate(errs)))
        time.sleep(0.1)


def drive_fake_srun(tmp_path, base_port):
    """The client drives the cluster of fake-srun tasks from the discovery
    file they filled, once both ranks are up."""
    disc, procs, errs = start_fake_srun(tmp_path, base_port)
    client = None
    try:
        wait_for_ranks(disc, procs, errs)
        client = IndexClient(disc)
        assert sorted(s.port for s in client.sub_indexes) == [base_port, base_port + 1]
        assert sorted(stub.get_rank() for stub in client.sub_indexes) == [0, 1]
        x = np.random.default_rng(0).standard_normal((600, 16)).astype(np.float32)
        client.create_index("srun", IndexCfg(index_builder_type="flat", dim=16, metric="l2",
                                             train_num=50))
        for s0 in range(0, 600, 200):
            client.add_index_data("srun", x[s0:s0 + 200],
                                  [(i, f"m{i}") for i in range(s0, s0 + 200)])
        assert _wait_ntotal(client, "srun", 600)
        _scores, metas = client.search(x[:5], 3, "srun")
        assert [metas[i][0] for i in range(5)] == [(i, f"m{i}") for i in range(5)]
    finally:
        if client is not None:
            client.close()
        for p in procs:
            p.kill()
            p.wait(timeout=10)


def test_slurm_task_body_via_fake_srun(tmp_path):
    drive_fake_srun(tmp_path, free_base(2))


def test_fake_srun_rank_that_cannot_bind_fails_within_a_minute(tmp_path, monkeypatch):
    """Rank 1's port is held by a listening socket: its bind fails, the
    rank exits, and the launch fails at once with the rank's error instead
    of waiting in read_server_list; no client is ever built."""
    built = []
    monkeypatch.setattr(sys.modules[__name__], "IndexClient", lambda *a, **k: built.append(a))
    base_port = free_base(2)
    t0 = time.monotonic()
    with socket.create_server(("", base_port + 1)):
        with pytest.raises(AssertionError, match="Address already in use"):
            drive_fake_srun(tmp_path, base_port)
    assert time.monotonic() - t0 < 60
    assert built == []


def test_server_launcher_arguments(tmp_path, monkeypatch):
    """The JAX script's arguments and defaults, plus --device (default
    cuda), reaching launch_slurm."""
    base = ["--discovery-config", "d.txt", "--num-servers", "4", "--index-storage-dir", "s"]
    args = server_launcher.get_args(base)
    assert (args.backend, args.num_servers_per_node, args.base_port, args.partition,
            args.mem_gb, args.timeout_min, args.log_dir, args.device, args.load_index) == (
        "local", 8, 12033, "learnlab", 400, 4320, "slurm_logs", "cuda", False)
    recorded = {}
    monkeypatch.setitem(sys.modules, "submitit", fake_submitit(recorded))
    disc = str(tmp_path / "disc.txt")
    assert server_launcher.main(["--backend", "slurm", "--discovery-config", disc,
                                 "--num-servers", "4", "--num-servers-per-node", "2",
                                 "--index-storage-dir", str(tmp_path / "s"),
                                 "--device", "cpu"]) == 0
    assert recorded["params"]["nodes"] == 2 and recorded["params"]["tasks_per_node"] == 2
    served = {}
    monkeypatch.setattr(launcher, "run_server",
                        lambda *a, device: served.update(args=a, device=device))
    recorded["task"]()
    assert served["device"] == "cpu"


def test_load_data_arguments_and_random_memmap(tmp_path):
    args = load_data.get_args(["--data", "x.mmap", "--discovery", "d.txt"])
    assert (args.dtype, args.dim, args.num_rows, args.bs, args.index_id, args.save_every_rows,
            args.make_random, args.device) == ("fp16", 768, -1, 1000, "default", 10_000_000,
                                               0, "cuda")
    path = str(tmp_path / "r.mmap")
    assert load_data.main(["--data", path, "--discovery", "unused", "--dim", "8",
                           "--make-random", "50", "--dtype", "fp32"]) == 0
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(50, 8))
    assert np.isfinite(mm).all() and os.path.getsize(path) == 50 * 8 * 4


def test_load_data_drives_a_cpu_cluster(tmp_path):
    """End to end: a memmap ingested into a CPU rank through the entry
    point, trained, searched and saved; asking for cuda servers stops
    before the first add."""
    srv = IndexServer(0, str(tmp_path / "store"), device="cpu")
    port = srv.bind(0)
    threading.Thread(target=srv.start_blocking, name="load-server", daemon=True).start()
    try:
        disc = tmp_path / "disc.txt"
        disc.write_text(f"1\nlocalhost,{port}\n")
        cfg = str(tmp_path / "cfg.json")
        IndexCfg(index_builder_type="flat", dim=16, metric="l2", train_num=100).save(cfg)
        data = str(tmp_path / "emb.mmap")
        load_data.save_random_mmap(data, 300, 16, np.float32)
        common = ["--data", data, "--dtype", "fp32", "--dim", "16", "--discovery", str(disc),
                  "--index-id", "ld", "--cfg", cfg, "--bs", "100"]
        with pytest.raises(RuntimeError, match="--device cuda"):
            load_data.main(common)
        assert "ld" not in srv.indexes
        assert load_data.main(common + ["--device", "cpu"]) == 0
        idx = srv.indexes["ld"]
        assert idx.get_state() == IndexState.TRAINED and idx.get_idx_data_num() == (0, 300)
        assert idx.current_generation() >= 1
    finally:
        srv.stop()
