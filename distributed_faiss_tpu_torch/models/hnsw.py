"""HNSW-SQ index: the repo's host C++ graph behind the model surface
(counterpart of distributed_faiss_tpu/models/hnsw.py).

The reference's ``hnswsq`` builder is FAISS IndexHNSWSQ over SQ8 codes, L2
only, with nprobe mapped to efSearch (distributed_faiss/index.py:51-60,
487-495). Graph traversal is pointer chasing, so this family runs on the
host in both packages: the graph is ``native/hnsw.cpp``, the same source
the JAX package drives, so a state written by either package walks the
same graph in the other.

Build: ``g++ -O3 -march=native -shared -fPIC -std=c++17`` at first use
into ``build/torch_native/libdfthnsw-<sha12>.so`` at the root of the
checkout, named by a hash of the source, the flags and the host CPU's
feature flags (``-march=native`` selects the source's AVX-512 distance
loop where the host has it, as the JAX package's build does, so a build
directory carried to another host is not reused there). The JAX
package's artifact beside the source is never loaded. There is no
fallback: without a working compiler the build raises with the
compiler's error, so nothing serves a flat scan under the ``hnswsq``
name.

The SQ8 codec and the codes stay on the host, as the graph reads them.
With ``refine_k_factor > 0`` the top ``k * refine_k_factor`` graph
candidates are rescored exactly against fp16 copies of the rows; those
rows and the rerank live on the model's device (torch ops), as the IVF
family's refine does.

Concurrency (the native library's contract): construction is
multi-threaded, concurrent ``search`` calls on one instance are safe, and
``add`` must not overlap ``search`` or ``state_dict`` on the same instance
(the engine's index lock keeps that). Thread count: DFT_HNSW_THREADS or
``set_threads``.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from distributed_faiss_tpu_torch.models import base
from distributed_faiss_tpu_torch.utils import compilecheck, lockdep, xfercheck

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "hnsw.cpp"
BUILD_DIR = _REPO / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

# queries per exact-rerank step: bounds the (rows, k * refine, d) gather
_RERANK_BLOCK = 1024

_lock = lockdep.lock("hnsw._lock")
_lib = None


def _cpu_features() -> str:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> Path:
    """The library's path, named by a hash of the source, the flags and the
    host CPU's features."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_features().encode())
    return BUILD_DIR / f"libdfthnsw-{h.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile ``native/hnsw.cpp`` unless this source is built already.
    Raises with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the hnswsq graph (native/hnsw.cpp) is built "
                           "from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compilecheck.record("g++:hnsw")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out.stdout + out.stderr)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native hnsw build failed (g++ exit {out.returncode}):\n"
                           f"{out.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded graph library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build_library()
        compilecheck.record("load:hnsw")
        lib = ctypes.CDLL(str(path))
        lib.dft_hnsw_create.restype = ctypes.c_void_p
        lib.dft_hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_uint]
        lib.dft_hnsw_free.restype = None
        lib.dft_hnsw_free.argtypes = [ctypes.c_void_p]
        lib.dft_hnsw_set_codec.restype = None
        lib.dft_hnsw_set_codec.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.dft_hnsw_set_threads.restype = None
        lib.dft_hnsw_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dft_hnsw_add.restype = None
        lib.dft_hnsw_add.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.dft_hnsw_size.restype = ctypes.c_int
        lib.dft_hnsw_size.argtypes = [ctypes.c_void_p]
        lib.dft_hnsw_search.restype = None
        lib.dft_hnsw_search.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
        lib.dft_hnsw_save.restype = ctypes.c_int
        lib.dft_hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dft_hnsw_load.restype = ctypes.c_void_p
        lib.dft_hnsw_load.argtypes = [ctypes.c_char_p]
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class HNSWSQIndex(base.TorchIndex):
    """SQ8 codec + C++ HNSW graph; nprobe doubles as efSearch."""

    def __init__(self, dim: int, metric: str = "l2", M: int = 32, ef_construction: int = 100,
                 seed: int = 0, refine_k_factor: int = 0, device="cuda"):
        super().__init__(dim, metric, device)
        if metric != "l2":
            raise RuntimeError("hnswsq only supports the l2 metric")
        if int(refine_k_factor) != refine_k_factor or int(refine_k_factor) < 0:
            raise ValueError(
                f"refine_k_factor must be a non-negative int, got {refine_k_factor!r}")
        self.M = int(M)
        self.ef_construction = int(ef_construction)
        self.seed = int(seed)
        self.nprobe = 64  # efSearch
        self.refine_k_factor = int(refine_k_factor)
        self._lib = load_library()
        self._h = self._lib.dft_hnsw_create(dim, self.M, self.ef_construction, self.seed)
        self.sq_params = None  # {"vmin": (d,), "step": (d,)} fp32, host
        self._host_codes = []  # insertion-order SQ8 codes, for reconstruct
        # fp16 raw rows in insertion order, on the model's device
        self._refine = base.DeviceVectorStore((dim,), torch.float16, self.device)

    def set_threads(self, n: int) -> None:
        """Cap the native thread count (<= 0 restores the default:
        DFT_HNSW_THREADS or the hardware concurrency)."""
        self._lib.dft_hnsw_set_threads(self._h, int(n))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and getattr(self, "_lib", None):
            self._lib.dft_hnsw_free(h)

    # ------------------------------------------------------------- lifecycle

    @property
    def is_trained(self) -> bool:
        return self.sq_params is not None

    @property
    def ntotal(self) -> int:
        return self._lib.dft_hnsw_size(self._h)

    def _set_codec(self, vmin: np.ndarray, step: np.ndarray) -> None:
        self.sq_params = {"vmin": np.ascontiguousarray(vmin, np.float32),
                          "step": np.ascontiguousarray(step, np.float32)}
        self._lib.dft_hnsw_set_codec(self._h, _ptr(self.sq_params["vmin"]),
                                     _ptr(self.sq_params["step"]))

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        vmin = x.min(axis=0)
        span = np.maximum(x.max(axis=0) - vmin, 1e-12)
        self._set_codec(vmin, (span / 255.0).astype(np.float32))

    def _encode(self, x: np.ndarray) -> np.ndarray:
        q = np.round((x - self.sq_params["vmin"]) / self.sq_params["step"] / 1.0)
        return np.clip(q, 0, 255).astype(np.uint8)

    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError("hnswsq index must be trained before add")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"rows must be (n, {self.dim}), got {x.shape}")
        codes = np.ascontiguousarray(self._encode(x))
        self._host_codes.append(codes)
        if self.refine_k_factor:
            self._refine.add(torch.from_numpy(x.astype(np.float16)))
        self._lib.dft_hnsw_add(self._h, codes.shape[0], _ptr(codes))

    # ------------------------------------------------------------- query

    def search(self, q: np.ndarray, k: int):
        q = np.ascontiguousarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {q.shape}")
        nq = q.shape[0]
        ntotal = self.ntotal
        if ntotal == 0:
            return np.full((nq, k), np.inf, np.float32), np.full((nq, k), -1, np.int64)
        kk = k
        if self.refine_k_factor:
            # the shortlist is clamped to the corpus but never below k: the
            # (nq, k) result shape holds even when ntotal < k (the graph pads
            # missing slots with inf / -1)
            kk = max(k, min(k * self.refine_k_factor, ntotal))
        out_d = np.empty((nq, kk), np.float32)
        out_i = np.empty((nq, kk), np.int64)
        ef = max(int(self.nprobe), kk)
        self._lib.dft_hnsw_search(self._h, nq, _ptr(q), kk, ef, _ptr(out_d), _ptr(out_i))
        if kk > k:
            return self._rerank_exact(q, out_i, k)
        return out_d, out_i  # l2 distances ascending, FAISS-style

    def _rerank_exact(self, q: np.ndarray, cand: np.ndarray, k: int):
        """Exact rescore of the graph's shortlist against the fp16 rows, on
        the model's device; a stable sort keeps the graph's order on ties,
        as the JAX package's host rerank does."""
        rows = self._refine.data
        out_d = np.empty((q.shape[0], k), np.float32)
        out_i = np.empty((q.shape[0], k), np.int64)
        for s in range(0, q.shape[0], _RERANK_BLOCK):
            with xfercheck.explicit("hnsw rerank shortlist upload"):
                qb = torch.from_numpy(q[s:s + _RERANK_BLOCK]).to(self.device)
                cb = torch.from_numpy(cand[s:s + _RERANK_BLOCK]).to(self.device)
            rec = rows[cb.clamp(min=0)].float()  # (b, kk, d)
            d2 = ((qb[:, None, :] - rec) ** 2).sum(-1)
            d2 = d2.masked_fill(cb < 0, float("inf"))
            d2, order = torch.sort(d2, dim=1, stable=True)
            with xfercheck.explicit("hnsw rerank result fetch"):
                out_d[s:s + qb.shape[0]] = d2[:, :k].cpu().numpy()
                out_i[s:s + qb.shape[0]] = torch.gather(cb, 1, order[:, :k]).cpu().numpy()
        return out_d, out_i

    def _codes_array(self) -> np.ndarray:
        if len(self._host_codes) > 1:
            self._host_codes = [np.concatenate(self._host_codes)]
        return self._host_codes[0] if self._host_codes else np.zeros((0, self.dim), np.uint8)

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        codes = self._codes_array()[np.asarray(ids, np.int64)]
        return (self.sq_params["vmin"][None, :]
                + codes.astype(np.float32) * self.sq_params["step"][None, :])

    # ------------------------------------------------------------- persistence

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The JAX package's keys, so either package's snapshot loads in the
        other."""
        state = {
            "kind": "hnswsq",
            "dim": self.dim,
            "metric": self.metric,
            "M": self.M,
            "ef_construction": self.ef_construction,
            "nprobe": int(self.nprobe),
            "trained": self.is_trained,
            "refine_k_factor": self.refine_k_factor,
        }
        if self.is_trained:
            state["sq_vmin"] = self.sq_params["vmin"]
            state["sq_step"] = self.sq_params["step"]
            state["codes"] = self._codes_array()
            if self.refine_k_factor:
                state["refine_rows"] = (base.to_numpy(self._refine.data[:self._refine.ntotal])
                                        if self._refine.ntotal
                                        else np.zeros((0, self.dim), np.float16))
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "graph.hnsw")
                if not self._lib.dft_hnsw_save(self._h, path.encode()):
                    raise RuntimeError("hnsw graph serialization failed")
                state["graph"] = np.fromfile(path, dtype=np.uint8)
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "HNSWSQIndex":
        idx = cls(int(state["dim"]), str(state["metric"]), M=int(state["M"]),
                  ef_construction=int(state["ef_construction"]),
                  refine_k_factor=int(state.get("refine_k_factor", 0)), device=device)
        idx.nprobe = int(state["nprobe"])
        if not bool(state["trained"]):
            return idx
        idx.sq_params = {"vmin": np.ascontiguousarray(state["sq_vmin"], np.float32),
                         "step": np.ascontiguousarray(state["sq_step"], np.float32)}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "graph.hnsw")
            np.asarray(state["graph"], np.uint8).tofile(path)
            h = idx._lib.dft_hnsw_load(path.encode())
        if not h:
            raise RuntimeError("hnsw graph deserialization failed")
        idx._lib.dft_hnsw_free(idx._h)
        idx._h = h
        codes = np.asarray(state["codes"], np.uint8)
        if codes.shape[0]:
            idx._host_codes = [codes]
        if idx.refine_k_factor:
            if "refine_rows" not in state:
                raise ValueError("hnswsq state has refine_k_factor set but no refine_rows")
            idx._refine.add(torch.from_numpy(np.asarray(state["refine_rows"], np.float16)))
        return idx
