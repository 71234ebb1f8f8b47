"""Chaos harness for the port's clusters (counterpart of
distributed_faiss_tpu/testing/chaos.py): a TCP fault-injection proxy, a
rank kill/restart harness and a query load to run across a fault.

``ChaosProxy`` sits between ``rpc.Client`` and an ``IndexServer`` and
injects scripted link faults — added latency, connection reset (RST),
blackhole (accept, then stall), garbled bytes and a cut mid-frame — by
forwarding raw bytes, so it can never mask a protocol bug by repairing a
frame. Faults are assigned per accepted connection from a ``plan`` list
(connection 0 gets ``plan[0]``, ...); later connections get the settable
default fault (``set_fault``), pass-through to start with. The one
frame-aware fault, ``drop_kind``, reads only the DFT1 header's lengths and
kind byte and never unpickles a payload.

``ServerHarness`` launches, SIGKILLs and restarts real rank processes;
``QueryStorm`` keeps a search load running while a fault is injected.
"""

import logging
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributed_faiss_tpu_torch.parallel import launcher, rpc

logger = logging.getLogger()

_CHUNK = 65536


class Fault:
    """One scripted link fault.

    kinds:
      - ``latency``: sleep ``delay`` seconds before forwarding each chunk in
        ``direction``.
      - ``reset``: RST the client after ``after_bytes`` upstream bytes (0 =
        at accept).
      - ``blackhole``: accept, then never read or forward a byte.
      - ``garble``: XOR the bytes in [``after_bytes``, ``after_bytes +
        nbytes``) of ``direction`` with 0xFF (the stream keeps its length).
      - ``cut``: forward exactly ``after_bytes`` bytes of ``direction``,
        then close both sides mid-frame.
      - ``drop_kind``: read ``direction`` frame by frame (header lengths
        and the kind byte only) and swallow every frame whose kind byte is
        in ``drop_kinds``, forwarding the others untouched: e.g. the digest
        exchange blackholed while searches on the same link flow.
    """

    LATENCY = "latency"
    RESET = "reset"
    BLACKHOLE = "blackhole"
    GARBLE = "garble"
    CUT = "cut"
    DROP_KIND = "drop_kind"
    KINDS = frozenset({LATENCY, RESET, BLACKHOLE, GARBLE, CUT, DROP_KIND})

    def __init__(self, kind: str, delay: float = 0.05, after_bytes: int = 0,
                 nbytes: int = 8, direction: str = "up", drop_kinds=None):
        if kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if direction not in ("up", "down"):
            raise ValueError("direction must be 'up' (client->server) or 'down'")
        if kind == self.DROP_KIND and not drop_kinds:
            raise ValueError("drop_kind fault needs a non-empty drop_kinds set")
        self.kind = kind
        self.delay = delay
        self.after_bytes = after_bytes
        self.nbytes = nbytes
        self.direction = direction
        self.drop_kinds = frozenset(int(k) for k in (drop_kinds or ()))

    def __repr__(self):
        return (f"Fault({self.kind!r}, delay={self.delay}, after_bytes={self.after_bytes}, "
                f"nbytes={self.nbytes}, direction={self.direction!r}, "
                f"drop_kinds={set(self.drop_kinds)})")


def _rst_close(sock: socket.socket) -> None:
    """Close with SO_LINGER(1, 0): the kernel sends RST, not FIN."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _quiet_close(sock: socket.socket) -> None:
    """shutdown + close: a bare close() while another thread is blocked in
    recv() on the socket leaves the connection open, so the peer never sees
    the end; shutdown() ends it and wakes the blocked recv."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class ChaosProxy:
    """TCP interposer with a scripted fault plan (one fault per accepted
    connection; None = pass-through)."""

    # the DFT1 header (magic, kind u8, skel_len u32, narr u32), taken from
    # the RPC module so a format change cannot desync the frame pump
    _FRAME_HDR = rpc._HDR
    _FRAME_MAGIC = rpc.MAGIC

    def __init__(self, target_host: str, target_port: int, listen_port: int = 0,
                 plan: Optional[List[Optional[Fault]]] = None):
        self.target = (target_host, target_port)
        self._listen_port = listen_port
        self._lock = threading.Lock()
        self._plan: List[Optional[Fault]] = list(plan) if plan else []
        self._default_fault: Optional[Fault] = None
        self._accepted = 0
        self._conns: List[socket.socket] = []
        # the accept loop's and the pumps' threads, joined by stop()
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._listener: Optional[socket.socket] = None
        self.port: Optional[int] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "ChaosProxy":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", self._listen_port))
        s.listen(16)
        self._listener = s
        self.port = s.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name=f"chaos-accept:{self.port}")
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._listener is not None:
            _quiet_close(self._listener)
        with self._lock:
            conns, self._conns = self._conns, []
            threads, self._threads = self._threads, []
        for c in conns:
            _quiet_close(c)
        # the closed sockets wake every pump out of recv; the joins are
        # bounded
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------------- plan

    def set_fault(self, fault: Optional[Fault]) -> None:
        """The fault of connections past the scripted plan."""
        with self._lock:
            self._default_fault = fault

    def connections_seen(self) -> int:
        with self._lock:
            return self._accepted

    def _next_fault(self) -> Optional[Fault]:
        with self._lock:
            idx = self._accepted
            self._accepted += 1
            return self._plan[idx] if idx < len(self._plan) else self._default_fault

    # ------------------------------------------------------------ forwarding

    def _spawn(self, target, args, name: str) -> None:
        t = threading.Thread(target=target, args=args, daemon=True, name=name)
        with self._lock:
            self._threads.append(t)
        t.start()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                client, _addr = self._listener.accept()
            except OSError:
                break
            self._spawn(self._handle, (client, self._next_fault()), f"chaos-conn:{self.port}")

    def _handle(self, client: socket.socket, fault: Optional[Fault]) -> None:
        if fault is not None and fault.kind == Fault.RESET and fault.after_bytes == 0:
            _rst_close(client)
            return
        if fault is not None and fault.kind == Fault.BLACKHOLE:
            # the connection looks established, but nothing flows until the
            # proxy stops
            with self._lock:
                self._conns.append(client)
            self._stopping.wait()
            _quiet_close(client)
            return
        try:
            upstream = socket.create_connection(self.target, timeout=10)
            # the timeout bounds the dial only: a quiet serving connection
            # through the proxy stays up however long it idles
            upstream.settimeout(None)
        except OSError:
            _quiet_close(client)
            return
        with self._lock:
            self._conns += [client, upstream]
        up = fault if fault is not None and fault.direction == "up" else None
        down = fault if fault is not None and fault.direction == "down" else None
        self._spawn(self._pump, (client, upstream, up), f"chaos-pump:{self.port}")
        self._pump(upstream, client, down)

    def _pump(self, src: socket.socket, dst: socket.socket, fault: Optional[Fault]) -> None:
        if fault is not None and fault.kind == Fault.DROP_KIND:
            self._pump_frames(src, dst, fault)
            return
        sent = 0
        try:
            while True:
                data = src.recv(_CHUNK)
                if not data:
                    break
                if fault is not None:
                    if fault.kind == Fault.LATENCY:
                        time.sleep(fault.delay)
                    elif fault.kind == Fault.GARBLE:
                        data = self._garble(data, sent, fault)
                    elif fault.kind in (Fault.RESET, Fault.CUT) \
                            and sent + len(data) >= fault.after_bytes:
                        dst.sendall(data[:max(0, fault.after_bytes - sent)])
                        if fault.kind == Fault.RESET:
                            # only this thread reads src, so its close
                            # really sends the RST
                            _rst_close(src)
                        else:
                            _quiet_close(src)
                        _quiet_close(dst)
                        self._forget(src, dst)
                        return
                dst.sendall(data)
                sent += len(data)
        except OSError:
            pass
        # one direction ended: end both, so the peer sees EOF, not a
        # half-open connection
        _quiet_close(src)
        _quiet_close(dst)
        self._forget(src, dst)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(min(_CHUNK, n - len(buf)))
            if not chunk:
                raise EOFError("stream ended mid-frame")
            buf += chunk
        return bytes(buf)

    def _pump_frames(self, src: socket.socket, dst: socket.socket, fault: Fault) -> None:
        """The ``drop_kind`` pump: swallow whole frames of the targeted
        kinds and forward every other frame byte for byte. A stream that
        stops framing (bad magic) is forwarded raw from there on."""
        try:
            while True:
                head = self._read_exact(src, self._FRAME_HDR.size)
                magic, kind, skel_len, narr = self._FRAME_HDR.unpack(head)
                if magic != self._FRAME_MAGIC:
                    dst.sendall(head)
                    while True:
                        data = src.recv(_CHUNK)
                        if not data:
                            break
                        dst.sendall(data)
                    break
                parts = [head, self._read_exact(src, skel_len)]
                for _ in range(narr):
                    dl = self._read_exact(src, 1)
                    dt = self._read_exact(src, dl[0])
                    nd = self._read_exact(src, 1)
                    dims_raw = self._read_exact(src, 8 * nd[0])
                    nbytes = np.dtype(dt.decode()).itemsize
                    for d in struct.unpack(f"<{nd[0]}Q", dims_raw):
                        nbytes *= d
                    parts += [dl, dt, nd, dims_raw, self._read_exact(src, int(nbytes))]
                if kind in fault.drop_kinds:
                    continue  # swallowed: the peer never sees this frame
                for p in parts:
                    dst.sendall(p)
        except (OSError, EOFError, ValueError, TypeError):
            # ValueError/TypeError: a desynced stream fed garbage to
            # np.dtype; the cleanup below must still run
            pass
        _quiet_close(src)
        _quiet_close(dst)
        self._forget(src, dst)

    def _forget(self, *socks) -> None:
        """Drop finished sockets from the live list."""
        with self._lock:
            for s in socks:
                if s in self._conns:
                    self._conns.remove(s)

    @staticmethod
    def _garble(data: bytes, sent: int, fault: Fault) -> bytes:
        lo = max(fault.after_bytes, sent)
        hi = min(fault.after_bytes + fault.nbytes, sent + len(data))
        if lo >= hi:
            return data
        buf = bytearray(data)
        for i in range(lo - sent, hi - sent):
            buf[i] ^= 0xFF
        return bytes(buf)


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
