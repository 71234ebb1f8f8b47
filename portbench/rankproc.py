"""The harness's side of the rank (``rank.py``): its process, its work dir
under TMPDIR and its command channel. Imports nothing heavy, so a run can
start the rank's process first and let it import while the harness draws
its data; the rank touches the card only on ``start``.
"""

import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class RunError(RuntimeError):
    """The run cannot give a result."""


def rank_env(root: str = ROOT) -> dict:
    """The rank's environment: the checkout on the path (the port builds
    its kernels with nvcc into the checkout's ``build/torch_kernels``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def harness_cpus(cpus: list, siblings_of=None) -> list:
    """The CPUs the harness keeps of ``cpus``: the hyperthreads of the
    first one's physical core where there are two or more of them among
    ``cpus``, else the first two; all of them where fewer than 4."""
    if len(cpus) < 4:
        return list(cpus)
    if siblings_of is None:
        siblings_of = _siblings
    core = [c for c in siblings_of(cpus[0]) if c in cpus]
    return core if len(core) >= 2 else list(cpus[:2])


def _siblings(cpu: int) -> list:
    path = f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list"
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return [cpu]
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def pin_apart(rank_pid: int) -> None:
    """This process (its calling thread and the threads it starts after)
    on ``harness_cpus``, the rank's process on every other CPU of ours. The
    clients stand for model workers on other hosts: their CPU work stays
    off the rank's cores, and the rank keeps all but one core (it uses
    1.3-1.5 of them at its highest rate). Where the rank may also run on
    the clients' cores, sift1m-ivfsq.r95's p95_ms spread twice as wide
    on an 8-CPU host of one H100."""
    cpus = sorted(os.sched_getaffinity(0))
    mine = harness_cpus(cpus)
    rest = [c for c in cpus if c not in mine]
    if rest:
        os.sched_setaffinity(rank_pid, rest)
    os.sched_setaffinity(0, mine)


class RankProcess:
    """Spawned on construction (it imports, then waits); ``start`` brings up
    the server on ``device`` and returns its discovery file; ``close``
    stops it, waits for the process and removes the work dir."""

    def __init__(self, device: str, root: str = ROOT):
        self.device = device
        self.work = tempfile.mkdtemp(prefix="portbench-")
        cmd = [sys.executable, os.path.join(HERE, "rank.py"), "--dir", self.work,
               "--device", device]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True, cwd=root, env=rank_env(root))
        pin_apart(self.proc.pid)
        self._lines = queue.Queue()
        self._reader = threading.Thread(target=self._read, name="rank-channel", daemon=True)
        self._reader.start()
        self.hello = None

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def _reply(self, what: str, timeout: float) -> dict:
        try:
            line = self._lines.get(timeout=timeout)
        except queue.Empty:
            raise RunError(f"rank: no answer to {what} in {timeout:.0f} s") from None
        if line is None:
            raise RunError(f"rank exited (code {self.proc.wait()}) during {what}")
        out = json.loads(line)
        if "error" in out:
            raise RunError(f"rank: {what} failed: {out['error']}")
        return out

    def call(self, cmd: str, timeout: float = 300.0, **kw) -> dict:
        self.proc.stdin.write(json.dumps({"cmd": cmd, **kw}) + "\n")
        self.proc.stdin.flush()
        return self._reply(cmd, timeout)

    def start(self) -> dict:
        """Bring the server up (the first start builds the kernels)."""
        self.hello = self.call("start", timeout=1200.0)
        return self.hello

    def close(self) -> None:
        """Stop the rank, wait for its process to end, remove its dir."""
        if self.proc.poll() is None:
            try:
                self.call("stop", timeout=120.0)
            except (RunError, OSError, ValueError):
                pass
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._reader.join(timeout=10)
        shutil.rmtree(self.work, ignore_errors=True)
