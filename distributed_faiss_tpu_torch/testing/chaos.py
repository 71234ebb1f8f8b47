"""Process-level chaos for the port's clusters (counterpart of
``ServerHarness`` and ``QueryStorm`` in distributed_faiss_tpu/testing/chaos.py):
launch real rank processes, SIGKILL and restart them, and keep a query load
running across the fault.

Not ported yet: ``ChaosProxy`` and ``Fault`` (link-level faults).
"""

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from distributed_faiss_tpu_torch.parallel import launcher


class ServerHarness:
    """Launch (``launcher.launch_local``), SIGKILL and restart real rank
    processes, each on ``device``. ``restart`` brings a rank back on its
    own port without a new discovery entry: live clients' stubs redial the
    same address on their next call."""

    def __init__(self, num_servers: int, discovery_path: str, storage_dir: str,
                 base_port: int = 13700, env: Optional[dict] = None, device: str = "cuda"):
        self.num_servers = num_servers
        self.discovery_path = discovery_path
        self.storage_dir = storage_dir
        self.base_port = base_port
        self.env = dict(env) if env else {}
        self.device = device
        self._lock = threading.Lock()
        self.procs: Dict[int, subprocess.Popen] = {}

    def port(self, rank: int) -> int:
        return self.base_port + rank

    def start(self) -> "ServerHarness":
        procs = launcher.launch_local(self.num_servers, self.discovery_path, self.storage_dir,
                                      base_port=self.base_port, env=self.env,
                                      device=self.device)
        with self._lock:
            self.procs = dict(enumerate(procs))
        return self

    def __enter__(self) -> "ServerHarness":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def kill(self, rank: int) -> None:
        """SIGKILL one rank: no shutdown hook runs (the crash case)."""
        with self._lock:
            proc = self.procs[rank]
        proc.kill()
        proc.wait()

    def restart(self, rank: int, load_index: bool = False,
                extra_env: Optional[dict] = None) -> None:
        """Start a killed rank again on its port. ``extra_env`` overlays this
        start's environment, e.g. ``DFT_SHARD_GROUP`` so the rank comes back
        registered in its group."""
        cmd = [sys.executable, "-m", "distributed_faiss_tpu_torch.parallel.server",
               "--rank", str(rank), "--port", str(self.port(rank)),
               "--storage-dir", self.storage_dir, "--discovery", self.discovery_path,
               "--device", self.device]
        if load_index:
            cmd.append("--load-index")
        proc = subprocess.Popen(cmd, env={**os.environ, **self.env, **(extra_env or {})})
        with self._lock:
            self.procs[rank] = proc

    def wait_port(self, rank: int, timeout: float = 60.0) -> None:
        """Block until the rank's port accepts a connection."""
        deadline = time.time() + timeout
        while True:
            with self._lock:
                proc = self.procs.get(rank)
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(f"rank {rank} exited with code {proc.returncode}")
            try:
                socket.create_connection(("localhost", self.port(rank)), timeout=1).close()
                return
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError(f"rank {rank} (port {self.port(rank)}) never came up")
                time.sleep(0.1)

    def stop(self) -> None:
        with self._lock:
            procs, self.procs = list(self.procs.values()), {}
        for p in procs:
            try:
                p.kill()
            except OSError:
                pass
        for p in procs:  # reap: no zombie ranks left behind
            try:
                p.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass


class QueryStorm:
    """N client threads repeat one search in a loop while a fault is
    injected; ``stop()`` returns every (result, error) observed. Errors are
    collected, never raised into the threads. ``allow_partial`` picks the
    read contract under test."""

    def __init__(self, client, index_id: str, query, topk: int, threads: int = 4,
                 allow_partial: bool = False, interval: float = 0.0):
        self.client = client
        self.index_id = index_id
        self.query = query
        self.topk = topk
        self.allow_partial = allow_partial
        self.interval = interval
        self.num_threads = threads
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.results: List[tuple] = []
        self.errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []

    def start(self) -> "QueryStorm":
        for i in range(self.num_threads):
            t = threading.Thread(target=self._run, daemon=True, name=f"query-storm-{i}")
            self._threads.append(t)
            t.start()
        return self

    def __enter__(self) -> "QueryStorm":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                out = self.client.search(self.query, self.topk, self.index_id,
                                         allow_partial=self.allow_partial)
            except Exception as e:
                with self._lock:
                    self.errors.append(e)
            else:
                with self._lock:
                    self.results.append(out)
            if self.interval:
                time.sleep(self.interval)

    def stop(self) -> Tuple[List[tuple], List[BaseException]]:
        """End the storm; (results, errors) so far."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30.0)
        with self._lock:
            return list(self.results), list(self.errors)
