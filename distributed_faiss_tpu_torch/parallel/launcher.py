"""Cluster launch and the discovery file (counterpart of
distributed_faiss_tpu/parallel/launcher.py; reference
scripts/server_launcher.py).

The discovery file's first line is the expected server count; each rank
appends ``host,port`` under an NFS-safe hardlink lock. ``launch_local``
starts N rank processes on this host (``python -m
distributed_faiss_tpu_torch.parallel.launcher``), each on its ``--device``
and with the discovery file as its anti-entropy peer source;
``launch_slurm`` submits them as SLURM tasks through submitit, rank from
the task's global rank and port ``base_port + local rank``.
"""

import argparse
import logging
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

logger = logging.getLogger()


def write_discovery_header(path: str, num_servers: int) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{num_servers}\n")


def acquire_file_lock(path: str, timeout: float = 60.0) -> str:
    """An NFS-safe lock: creating a hard link is atomic on NFS."""
    lock = path + ".lock"
    unique = f"{lock}.{os.getpid()}.{time.monotonic_ns()}"
    with open(unique, "w") as f:
        f.write(str(os.getpid()))
    deadline = time.time() + timeout
    try:
        while True:
            try:
                os.link(unique, lock)
                return lock
            except FileExistsError:
                if time.time() > deadline:
                    raise TimeoutError(f"could not acquire {lock}")
                time.sleep(0.05)
    finally:
        os.unlink(unique)


def release_file_lock(lock: str) -> None:
    try:
        os.unlink(lock)
    except FileNotFoundError:
        pass


def append_discovery_entry(path: str, host: str, port: int) -> None:
    lock = acquire_file_lock(path)
    try:
        with open(path, "a") as f:
            f.write(f"{host},{port}\n")
            f.flush()
            os.fsync(f.fileno())
    finally:
        release_file_lock(lock)


def run_server(rank: int, port: int, discovery_path: str, storage_dir: str,
               load_index: bool = False, host: Optional[str] = None,
               device: str = "cuda") -> None:
    """Bind, register in the discovery file, then serve until stopped (one
    rank). The discovery file is also the rank's anti-entropy peer source
    (DFT_ANTIENTROPY=0 turns the sweeper off)."""
    from distributed_faiss_tpu_torch.parallel.server import IndexServer, setup_server_logging

    setup_server_logging()
    server = IndexServer(rank, storage_dir, device=device, discovery_path=discovery_path)
    server.bind(port)
    append_discovery_entry(discovery_path, host or socket.gethostname(), port)
    server.start_blocking(port, load_index=load_index)


def launch_local(num_servers: int, discovery_path: str, storage_dir: str,
                 base_port: int = 12033, load_index: bool = False,
                 env: Optional[dict] = None, device: str = "cuda") -> List[subprocess.Popen]:
    """Start ``num_servers`` rank processes on this host, rank r on
    ``base_port + r``, each on ``device``."""
    write_discovery_header(discovery_path, num_servers)
    procs = []
    for rank in range(num_servers):
        cmd = [sys.executable, "-m", "distributed_faiss_tpu_torch.parallel.launcher",
               "--rank", str(rank), "--port", str(base_port + rank),
               "--discovery", discovery_path, "--storage-dir", storage_dir,
               "--device", device, "--host", "localhost"]
        if load_index:
            cmd.append("--load-index")
        procs.append(subprocess.Popen(cmd, env={**os.environ, **(env or {})}))
    return procs


def launch_slurm(num_servers: int, num_servers_per_node: int, discovery_path: str,
                 storage_dir: str, base_port: int = 12033, load_index: bool = False,
                 partition: str = "learnlab", mem_gb: int = 400, timeout_min: int = 4320,
                 log_dir: str = "slurm_logs", device: str = "cuda"):
    """Submit ``num_servers`` ranks as one SLURM job through submitit
    (reference server_launcher.py:111-129), ``num_servers_per_node`` tasks
    a node, each running ``run_server`` on ``device``. Returns the job."""
    try:
        import submitit
    except ImportError as e:
        raise RuntimeError(
            "submitit is not installed; use launch_local or install submitit") from e

    write_discovery_header(discovery_path, num_servers)

    def task():
        env = submitit.JobEnvironment()
        run_server(env.global_rank, base_port + env.local_rank, discovery_path, storage_dir,
                   load_index, device=device)

    executor = submitit.AutoExecutor(folder=log_dir)
    executor.update_parameters(
        nodes=-(-num_servers // num_servers_per_node),
        tasks_per_node=num_servers_per_node,
        slurm_partition=partition,
        mem_gb=mem_gb,
        timeout_min=timeout_min,
        name="dft_index_server",
    )
    return executor.submit(task)


def main(argv=None) -> None:
    """One rank that registers itself: python -m distributed_faiss_tpu_torch.parallel.launcher"""
    ap = argparse.ArgumentParser(description="run one index server rank and register it")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--discovery", required=True)
    ap.add_argument("--storage-dir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default=None)
    ap.add_argument("--load-index", action="store_true")
    args = ap.parse_args(argv)
    run_server(args.rank, args.port, args.discovery, args.storage_dir,
               load_index=args.load_index, host=args.host, device=args.device)


if __name__ == "__main__":
    main()
