"""Brute-force exact index (counterpart of distributed_faiss_tpu/models/flat.py;
FAISS IndexFlatIP/IndexFlatL2 parity).

Honors the configured metric (the reference's ``flat`` builder always
built IndexFlatIP; the JAX package fixed that and so does the port).
Storage codecs: fp32 / fp16 / bf16 (cast to fp32 inside the scan) and sq8
(per-dim affine, decoded in the scan). Deleted rows are masked by the
store's ``live`` mask inside the scan. This is the port's recall ground
truth.

A search is one program a query block (``ops.distance.knn``), or one for
a batch of several blocks (``_flat_search_fused``), captured and replayed
through the model's program cache (``models.base.blocked_search``).
"""

from typing import Dict

import numpy as np
import torch

from distributed_faiss_tpu_torch.models import base
from distributed_faiss_tpu_torch.ops import distance, sq

_CODEC_DTYPES = {
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "sq8": torch.uint8,
}


def _flat_search_fused(q3, data, ntotal: int, k: int, metric: str, codec: str,
                       vmin=None, span=None, live=None):
    """The exact scan over stacked (nblocks, block, d) query blocks, block
    after block, as one program (the JAX package's ``_flat_search_fused``).
    ``live`` is the optional (cap,) tombstone mask."""
    kwargs = {} if codec != "sq8" else {"codec": "sq8", "vmin": vmin, "span": span}
    return base.map_blocks(
        lambda qb: distance.knn(qb, data, k, metric=metric, ntotal=ntotal, live=live,
                                **kwargs), q3)


class FlatIndex(base.TorchIndex):
    def __init__(self, dim: int, metric: str = "l2", codec: str = "f32", device="cuda"):
        super().__init__(dim, metric, device)
        if codec not in _CODEC_DTYPES:
            raise ValueError(f"unknown flat codec {codec!r}")
        self.codec = codec
        self.store = base.DeviceVectorStore((dim,), _CODEC_DTYPES[codec], self.device)
        self.sq_params = None  # sq8 only: {"vmin", "span"} device tensors
        self._trained = codec != "sq8"

    @property
    def is_trained(self) -> bool:
        return self._trained

    @property
    def ntotal(self) -> int:
        return self.store.ntotal

    def train(self, x: np.ndarray) -> None:
        if self.codec == "sq8":
            xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            self.sq_params = sq.sq8_train(xt)
        self._trained = True

    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError("sq8 flat index must be trained before add")
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        if self.codec == "sq8":
            xt = sq.sq8_encode(xt, self.sq_params["vmin"], self.sq_params["span"])
        self.store.add(xt)

    def search(self, q: np.ndarray, k: int):
        nq = q.shape[0]
        if self.ntotal == 0:
            empty_d = np.full((nq, k), np.inf if self.metric == "l2" else -np.inf, np.float32)
            return empty_d, np.full((nq, k), -1, np.int64)
        vmin = span = None
        if self.codec == "sq8":
            vmin, span = self.sq_params["vmin"], self.sq_params["span"]
        data, ntotal, live = self.store.data, self.store.ntotal, self.store.live
        # per-query transient: the (block, chunk) score block of the scan
        nb = base.pick_query_block(65536 * 4)

        def run_fused(q3):
            return _flat_search_fused(q3, data, ntotal, k, self.metric, self.codec, vmin, span,
                                      live)

        programs = self.programs.bind("flat", (k, self.metric, self.codec),
                                      (data, ntotal, live, vmin, span))
        return base.blocked_search(q, k, self.metric, base.per_block(run_fused), self.device,
                                   block=nb, fused_fn=run_fused, programs=programs)

    def remove_rows(self, rows: np.ndarray) -> None:
        self.store.mask_rows(rows)

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        rows = self.store.rows(ids)
        if self.codec == "sq8":
            codes = torch.as_tensor(rows, device=self.device)
            return base.to_numpy(sq.sq8_decode(codes, self.sq_params["vmin"],
                                               self.sq_params["span"]))
        return np.asarray(rows, np.float32)

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = {
            "kind": "flat",
            "dim": self.dim,
            "metric": self.metric,
            "codec": self.codec,
            "trained": self._trained,
            "ntotal": self.store.ntotal,
            "data": self.store.all_rows(),
        }
        if self.sq_params is not None:
            state["sq_vmin"] = base.to_numpy(self.sq_params["vmin"])
            state["sq_span"] = base.to_numpy(self.sq_params["span"])
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "FlatIndex":
        idx = cls(int(state["dim"]), str(state["metric"]), str(state["codec"]), device)
        if "sq_vmin" in state:
            idx.sq_params = {
                "vmin": torch.as_tensor(np.asarray(state["sq_vmin"], np.float32),
                                        device=idx.device),
                "span": torch.as_tensor(np.asarray(state["sq_span"], np.float32),
                                        device=idx.device),
            }
        idx._trained = bool(state["trained"])
        data = np.asarray(state["data"])
        if data.shape[0]:
            if idx.codec == "bf16":
                data = data.astype(np.float32)  # bf16 snapshots hold fp32 values
            idx.store.add(data)
        return idx
