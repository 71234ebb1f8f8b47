"""Linear pre-transform wrapper, FAISS ``IndexPreTransform`` (counterpart of
distributed_faiss_tpu/models/pretransform.py).

The wrapper maps every vector to ``(x - mean) @ matrix`` before it hands
it to the inner index, for train, add and search, and maps reconstructed
rows back with ``y @ matrix.T + mean``. The inner index may be any ported
core: flat, IVF-Flat/SQ, IVF-PQ or flat PQ.

Transforms:
- OPQ (``opq_m`` set): an orthonormal rotation trained by ``ops/opq.py``
  to minimize the inner PQ's reconstruction error, fit on the first
  ``train`` call;
- PCA (``pca`` set): mean-centred projection onto the top d_out right
  singular vectors of the centred training rows (``torch.linalg.svd`` on
  the index's device), fit on the first ``train`` call;
- fixed: a caller-supplied matrix (already fit).

The matrix and mean live on the index's device and the products run
there; the transformed rows cross to the host once, into the inner index's
numpy API, whose search programs (``utils/programs.py``) then serve them:
the product itself is not part of a program, so a search keeps that host
round trip. ``state_dict`` writes the JAX package's keys (``kind``
"pretransform", ``opq_m``, ``pca``, ``fit``, ``matrix``, ``mean`` and the
inner index's state under ``inner.``), so a snapshot of either package
loads in the other.
"""

from typing import Dict, Optional

import numpy as np
import torch

from distributed_faiss_tpu_torch.models import base
from distributed_faiss_tpu_torch.ops import opq


class PreTransformIndex(base.TorchIndex):
    def __init__(self, inner: base.TorchIndex, d_in: int, opq_m: Optional[int] = None,
                 pca: bool = False, matrix: Optional[np.ndarray] = None,
                 mean: Optional[np.ndarray] = None, opq_iters: int = 8, pq_iters: int = 6):
        super().__init__(d_in, inner.metric, inner.device)
        if (opq_m is not None) + bool(pca) + (matrix is not None) != 1:
            raise ValueError("exactly one of opq_m / pca / matrix must be given")
        self.inner = inner
        self.d_out = inner.dim
        self.opq_m = opq_m
        self.pca = bool(pca)
        self.opq_iters = opq_iters
        self.pq_iters = pq_iters
        self.matrix = None if matrix is None else self._tensor(matrix)  # (d_in, d_out)
        self.mean = None if mean is None else self._tensor(mean)  # (d_in,)
        if self.matrix is not None and tuple(self.matrix.shape) != (d_in, self.d_out):
            raise ValueError(f"transform matrix shape {tuple(self.matrix.shape)} != "
                             f"({d_in}, {self.d_out})")

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # --- transform --------------------------------------------------------

    def _fit(self, x: torch.Tensor) -> None:
        if self.opq_m is not None:
            self.matrix, _ = opq.opq_train(x, self.opq_m, d_out=self.d_out,
                                           opq_iters=self.opq_iters, pq_iters=self.pq_iters)
            return
        if x.shape[0] < self.d_out:
            # the basis has min(n, d_in) vectors; fewer would silently
            # truncate it and desync dims with the inner index
            raise RuntimeError(f"PCA to {self.d_out} dims needs >= {self.d_out} training "
                               f"rows, got {x.shape[0]}")
        self.mean = x.mean(0)
        _, _, vh = torch.linalg.svd(x - self.mean, full_matrices=False)
        self.matrix = vh[: self.d_out].T.contiguous()

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.matrix is None:
            raise RuntimeError("transform is not fit; call train() first")
        if self.mean is not None:
            x = x - self.mean
        return x @ self.matrix

    def apply(self, x: np.ndarray) -> np.ndarray:
        """(n, d_in) host rows -> (n, d_out) transformed host rows."""
        return base.to_numpy(self._apply(self._tensor(x)))

    def apply_inverse(self, y: np.ndarray) -> np.ndarray:
        """Orthonormal-column pseudo-inverse: y @ matrix.T (+ mean)."""
        x = self._tensor(y) @ self.matrix.T
        if self.mean is not None:
            x = x + self.mean
        return base.to_numpy(x)

    # --- lifecycle (delegate) --------------------------------------------

    @property
    def is_trained(self) -> bool:
        return self.matrix is not None and self.inner.is_trained

    @property
    def ntotal(self) -> int:
        return self.inner.ntotal

    def train(self, x: np.ndarray) -> None:
        xt = self._tensor(x)
        if self.matrix is None:
            self._fit(xt)
        self.inner.train(base.to_numpy(self._apply(xt)))

    def add(self, x: np.ndarray) -> None:
        self.inner.add(self.apply(x))

    def search(self, q: np.ndarray, k: int):
        return self.inner.search(self.apply(q), k)

    def supports_remove_rows(self) -> bool:
        return self.inner.supports_remove_rows()

    def remove_rows(self, rows: np.ndarray) -> None:
        # the transform maps vectors, not positions: the mask is the inner
        # index's
        self.inner.remove_rows(rows)

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        return self.apply_inverse(self.inner.reconstruct_batch(ids))

    def set_nprobe(self, nprobe: int) -> None:
        self.nprobe = int(nprobe)
        self.inner.set_nprobe(nprobe)

    def release_programs(self) -> None:
        self.inner.release_programs()

    def program_stats(self) -> dict:
        return self.inner.program_stats()

    def get_centroids(self):
        return self.inner.get_centroids()

    # --- persistence ------------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = {
            "kind": "pretransform",
            "dim": self.dim,
            "metric": self.metric,
            "opq_m": -1 if self.opq_m is None else int(self.opq_m),
            "pca": self.pca,
            "fit": self.matrix is not None,
        }
        if self.matrix is not None:
            state["matrix"] = base.to_numpy(self.matrix)
        if self.mean is not None:
            state["mean"] = base.to_numpy(self.mean)
        for k, v in self.inner.state_dict().items():
            state[f"inner.{k}"] = v
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "PreTransformIndex":
        from distributed_faiss_tpu_torch.models.factory import index_from_state_dict

        inner = index_from_state_dict(
            {k[len("inner."):]: v for k, v in state.items() if k.startswith("inner.")},
            device=device)
        opq_m = int(state["opq_m"])
        if bool(state["fit"]):
            # a fit matrix enters as 'fixed' (the one-of check); the fit
            # mode's flags are restored below
            idx = cls(inner, int(state["dim"]), matrix=state["matrix"],
                      mean=state["mean"] if "mean" in state else None)
        else:
            idx = cls(inner, int(state["dim"]), opq_m=None if opq_m < 0 else opq_m,
                      pca=bool(state["pca"]))
        idx.opq_m = None if opq_m < 0 else opq_m
        idx.pca = bool(state["pca"])
        idx.nprobe = inner.nprobe
        return idx
