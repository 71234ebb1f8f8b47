"""The rank of a benchmark run: the port's ``IndexServer`` in a process of
its own, as ``distributed_faiss_tpu_torch/scripts/server_launcher.py``
starts one, serving on a free loopback port listed in a discovery file.

    python3 portbench/rank.py --dir <work dir> [--device cuda]

It imports first and touches the card only on ``start`` (which brings the
server up and answers its port and discovery file). Then it answers one
JSON command a line on standard input with one JSON line on its standard
output (anything else the process prints goes to standard error):
``memory`` (the card's peak reserved and allocated bytes),
``programs`` (an index's ``program_stats()``), ``trace_start`` and
``trace_stop`` (a ``torch.profiler`` window over the card, summarized by
``devtrace.summarize``), ``snapshot`` (an index's centroids and its lists'
live rows from the assignment vector), ``modules`` (the JAX modules
loaded here) and ``stop`` (drops the indexes unsaved, stops the server and
exits).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_faiss_tpu")
COMMANDS = ("memory", "programs", "trace_start", "trace_stop", "snapshot", "modules", "stop")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Rank:
    def __init__(self, work: str, device: str, imports_s: float):
        import torch

        from distributed_faiss_tpu_torch.parallel.server import IndexServer

        self.torch = torch
        self.device = device
        self.times = {"imports_s": imports_s}
        t = time.perf_counter()
        if device == "cuda":
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        self.times["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if device == "cuda":
            from distributed_faiss_tpu_torch.ops import cuda_build

            for name in cuda_build.sources():
                cuda_build.load(name)
        self.times["kernel_load_s"] = time.perf_counter() - t
        self.server = IndexServer(0, os.path.join(work, "store"), device=device)
        self.port = self.server.bind(0)
        self.thread = threading.Thread(target=self.server.start_blocking, name="rank-accept",
                                       daemon=True)
        self.thread.start()
        self.disc = os.path.join(work, "discovery.txt")
        with open(self.disc, "w") as f:
            f.write(f"1\nlocalhost,{self.port}\n")
        self.prof = None
        self.prof_t0 = 0.0

    def _model(self, index_id: str):
        with self.server.indexes_lock:
            return self.server.indexes[index_id].model

    def memory(self, _cmd) -> dict:
        cuda = self.device == "cuda"
        return {"max_reserved": self.torch.cuda.max_memory_reserved() if cuda else 0,
                "max_allocated": self.torch.cuda.max_memory_allocated() if cuda else 0}

    def programs(self, cmd) -> dict:
        return self._model(cmd["index"]).program_stats()

    def trace_start(self, _cmd) -> dict:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.prof_t0 = time.perf_counter()
        return {}

    def trace_stop(self, cmd) -> dict:
        """Stop the profiler and summarize its window, which ends at
        ``until`` (the host clock, shared by the processes of one host) when
        given: the harness stops its clients there and lets their last
        requests finish first, so the profiler never stops under load."""
        from portbench import devtrace

        if self.device == "cuda":
            self.torch.cuda.synchronize()
        window_s = cmd.get("until", time.perf_counter()) - self.prof_t0
        self.prof.stop()
        out = devtrace.summarize(devtrace.profile_spans(self.prof), window_s)
        self.prof = None
        return out

    def snapshot(self, cmd) -> dict:
        import numpy as np

        model = self._model(cmd["index"])
        sizes = np.bincount(np.asarray(model.get_assignments(), np.int64),
                            minlength=model.nlist)
        np.savez(cmd["path"], centroids=model.get_centroids(), sizes=sizes)
        return {"path": cmd["path"]}

    def modules(self, _cmd) -> dict:
        return {"forbidden": forbidden_modules()}

    def stop(self, _cmd) -> dict:
        # dropped first, so stop() saves nothing to disk
        for index_id in list(self.server.indexes):
            self.server.drop_index(index_id)
        self.server.stop()
        self.thread.join(timeout=30)
        return {"stopped": not self.thread.is_alive()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="work dir: discovery file and index storage")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    # the command channel is the original stdout; stray prints go to stderr
    channel = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    import torch  # noqa: F401  (the imports, before the card is touched)

    from distributed_faiss_tpu_torch.parallel import server  # noqa: F401

    imports_s = time.perf_counter() - T0
    rank = None
    for line in sys.stdin:
        cmd = json.loads(line)
        name = cmd.get("cmd")
        try:
            if name == "start" and rank is None:
                rank = Rank(args.dir, args.device, imports_s)
                reply = {"ready": True, "port": rank.port, "disc": rank.disc, **rank.times}
            elif name == "stop" and rank is None:
                reply = {"stopped": True}
            elif rank is None or name not in COMMANDS:
                raise ValueError(f"command {name!r} before start or unknown")
            else:
                reply = getattr(rank, name)(cmd)
        except Exception as e:  # reported to the harness, which fails the run
            logging.exception("rank command %s failed", name)
            reply = {"error": f"{type(e).__name__}: {e}"}
        channel.write(json.dumps(reply) + "\n")
        if name == "stop":
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
