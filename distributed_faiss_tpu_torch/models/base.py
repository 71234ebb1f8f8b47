"""Index model interface + device-resident storage primitives (counterpart
of distributed_faiss_tpu/models/base.py).

- ``DeviceVectorStore``: a flat corpus as one (capacity, ...) device tensor,
  grown by power-of-two reallocation; rows past ``ntotal`` are masked in
  every scan, and so are the rows ``mask_rows`` tombstones (the ``live``
  mask, allocated at the first delete).
- ``PaddedLists``: ``nlist`` inverted lists as rectangular (nlist, cap, ...)
  device tensors with a per-list fill count. Capacity starts at
  ``MIN_CAP`` = 64 and doubles when the fullest list would overflow, as in
  the JAX package, so both packages place every row in the same
  (list, slot). The ids plane starts at -1, so every never-written slot is
  masked by ``id < 0`` in the scan, and so is every cell ``mask_cells``
  tombstones. Appends are planned on the host (``plan_append``) and land
  as one scatter.

The JAX package's write/append/mask bucketing and pow2 query-block padding
existed to bound XLA recompiles; PyTorch runs eagerly, so they are not
carried over. The masks scatter exactly the addresses given, checked on
the host first: the JAX package pads its scatters with an address one
past the end that XLA drops, where a CUDA index kernel would trip a
device-side assert instead.

Convention: models speak FAISS-style at their boundary — ``search`` returns
(D, I) with D ascending for l2 / descending inner products for dot, ids are
int64, missing results are id -1.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distributed_faiss_tpu_torch.ops import distance
from distributed_faiss_tpu_torch.utils import xfercheck
from distributed_faiss_tpu_torch.utils.device import resolve_device

row_norms_f32 = distance.row_norms_f32


def _next_pow2(n: int, minimum: int) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor. bf16 has no numpy dtype: it comes back as the
    fp32 values it represents exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    with xfercheck.explicit("to_numpy host copy"):
        return t.cpu().numpy()


class DeviceVectorStore:
    """Growable row store in device memory (rows: vectors or codes)."""

    MIN_CAP = 4096

    def __init__(self, row_shape: Tuple[int, ...], dtype: torch.dtype, device,
                 min_cap: int = None):
        self.row_shape = tuple(row_shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.min_cap = min_cap or self.MIN_CAP
        self.cap = 0
        self.ntotal = 0
        self.data: Optional[torch.Tensor] = None  # (cap, *row_shape)
        # (cap,) bool tombstone mask, False = deleted; None until the first
        # delete, so an index nothing was deleted from scans without it
        self.live: Optional[torch.Tensor] = None

    def _ensure(self, needed_rows: int) -> None:
        target = self.ntotal + needed_rows
        if self.cap >= target:
            return
        newcap = _next_pow2(target, self.min_cap)
        new = torch.zeros((newcap,) + self.row_shape, dtype=self.dtype, device=self.device)
        if self.data is not None:
            new[: self.ntotal] = self.data[: self.ntotal]
        self.data = new
        if self.live is not None:
            live = torch.ones(newcap, dtype=torch.bool, device=self.device)
            live[: self.cap] = self.live
            self.live = live
        self.cap = newcap

    def mask_rows(self, rows) -> None:
        """Tombstone ``rows`` (positions < ntotal): one scatter of False
        into the live mask. Idempotent; ``ntotal`` does not shrink, so
        every position stays stable."""
        rows = _checked_addresses(rows, self.ntotal, "row")
        if rows.size == 0:
            return
        if self.live is None:
            self.live = torch.ones(self.cap, dtype=torch.bool, device=self.device)
        self.live[torch.as_tensor(rows, device=self.device)] = False

    def add(self, rows) -> Tuple[int, int]:
        """Append rows (array or tensor); returns the (start, end) id range."""
        rows = torch.as_tensor(rows)
        n = rows.shape[0]
        if n == 0:
            return self.ntotal, self.ntotal
        self._ensure(n)
        start = self.ntotal
        self.data[start:start + n] = rows.to(device=self.device, dtype=self.dtype)
        self.ntotal += n
        return start, self.ntotal

    def rows(self, ids) -> np.ndarray:
        if self.data is None:
            return np.zeros((0,) + self.row_shape, np.float32)
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return to_numpy(self.data[idx])

    def all_rows(self) -> np.ndarray:
        if self.data is None:
            return np.zeros((0,) + self.row_shape, np.float32)
        return to_numpy(self.data[: self.ntotal])


class PaddedLists:
    """nlist growable inverted lists as rectangular padded device tensors."""

    MIN_CAP = 64

    def __init__(self, nlist: int, payload_shape: Tuple[int, ...], dtype: torch.dtype,
                 device, min_cap: int = None):
        self.nlist = nlist
        self.payload_shape = tuple(payload_shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.cap = min_cap or self.MIN_CAP
        self.data = torch.zeros((nlist, self.cap) + self.payload_shape, dtype=dtype,
                                device=self.device)
        self.ids = torch.full((nlist, self.cap), -1, dtype=torch.int32, device=self.device)
        self.sizes_host = np.zeros(nlist, np.int64)
        self.sizes = torch.zeros(nlist, dtype=torch.int32, device=self.device)

    @property
    def ntotal(self) -> int:
        return int(self.sizes_host.sum())

    def _grow(self, needed_cap: int) -> None:
        newcap = _next_pow2(needed_cap, self.cap)
        if newcap == self.cap:
            return
        data = torch.zeros((self.nlist, newcap) + self.payload_shape, dtype=self.dtype,
                           device=self.device)
        data[:, : self.cap] = self.data
        ids = torch.full((self.nlist, newcap), -1, dtype=torch.int32, device=self.device)
        ids[:, : self.cap] = self.ids
        self.data, self.ids, self.cap = data, ids, newcap

    def slot_of(self, l):
        """Global list id -> the list's slot in the padded layout (the list
        itself here; the mesh-sharded lists use strided ownership)."""
        return l

    def rows_at(self, assign, pos) -> np.ndarray:
        """Host rows at (list, within-list position) pairs."""
        flat = torch.as_tensor(np.asarray(assign, np.int64) * self.cap
                               + np.asarray(pos, np.int64), device=self.device)
        return to_numpy(self.data.reshape((-1,) + self.payload_shape)[flat])

    def mask_cells(self, cells) -> None:
        """Tombstone list cells (flat ``list * cap + pos`` addresses): one
        scatter of -1 into the ids plane. Sizes are not decremented: a dead
        slot stays occupied, and masked, until compaction rewrites the
        list, so every live (list, pos) address stays stable."""
        cells = _checked_addresses(cells, self.nlist * self.cap, "list cell")
        if cells.size == 0:
            return
        self.ids.view(-1)[torch.as_tensor(cells, device=self.device)] = -1

    @staticmethod
    def plan_append(list_idx: np.ndarray, nlist: int, cap: int, sizes_host: np.ndarray,
                    slot_fn=None):
        """Host-side offset planning: sort the batch by target list and give
        each row the write position ``slot * cap + size + within-batch
        offset``, where a list's slot is ``slot_fn(list)`` (the list itself
        by default; the mesh-sharded lists pass their strided ownership).
        Returns (counts, order, pos, within): ``order`` sorts the batch by
        list (stable), ``pos`` are the flat cell addresses in that sorted
        order, ``within`` the within-list positions in INPUT order — the
        id -> (list, slot) map persistence reads rows back through."""
        n = list_idx.shape[0]
        counts = np.bincount(list_idx, minlength=nlist)
        order = np.argsort(list_idx, kind="stable")
        sorted_li = list_idx[order]
        group_start = np.zeros(nlist + 1, np.int64)
        group_start[1:] = np.cumsum(counts)
        offs = np.arange(n, dtype=np.int64) - group_start[sorted_li]
        within_sorted = sizes_host[sorted_li] + offs
        slots = sorted_li.astype(np.int64)
        pos = (slot_fn(slots) if slot_fn is not None else slots) * cap + within_sorted
        within = np.empty(n, np.int32)
        within[order] = within_sorted.astype(np.int32)
        return counts, order, pos, within

    def append(self, list_idx: np.ndarray, payload, gids: np.ndarray) -> np.ndarray:
        """Append payload rows (array or tensor, (n, *payload_shape)) to
        their lists. list_idx, gids: (n,) host ints. Returns the (n,) int32
        within-list positions in input order."""
        list_idx = np.asarray(list_idx, np.int64)
        if list_idx.shape[0] == 0:
            return np.zeros(0, np.int32)
        counts = np.bincount(list_idx, minlength=self.nlist)
        new_sizes = self.sizes_host + counts
        if new_sizes.max() > self.cap:
            self._grow(int(new_sizes.max()))
        counts, order, pos, within = self.plan_append(
            list_idx, self.nlist, self.cap, self.sizes_host)
        payload = torch.as_tensor(payload).to(device=self.device, dtype=self.dtype)
        order_t = torch.as_tensor(order, device=self.device)
        pos_t = torch.as_tensor(pos, device=self.device)
        flat_data = self.data.view((self.nlist * self.cap,) + self.payload_shape)
        flat_ids = self.ids.view(self.nlist * self.cap)
        flat_data[pos_t] = payload[order_t]
        flat_ids[pos_t] = torch.as_tensor(np.asarray(gids)[order].astype(np.int32),
                                          device=self.device)
        self.sizes_host = new_sizes
        self.sizes = torch.as_tensor(new_sizes.astype(np.int32), device=self.device)
        return within


def _checked_addresses(addresses, end: int, what: str) -> np.ndarray:
    """int64 addresses, each checked to lie in [0, end) on the host."""
    a = np.asarray(addresses, np.int64).reshape(-1)
    if a.size and (a.min() < 0 or a.max() >= end):
        raise IndexError(f"{what} address out of range [0, {end}): "
                         f"{int(a.min())}..{int(a.max())}")
    return a


def gather_list_rows(lists, assign, pos) -> np.ndarray:
    """Host rows at (list, within-list position) pairs — how persistence
    reads the payload back from the device lists (``PaddedLists`` or the
    mesh-sharded lists, through their ``rows_at``)."""
    assign = np.asarray(assign, np.int64)
    if assign.shape[0] == 0:
        return to_numpy(torch.zeros((0,) + tuple(lists.payload_shape), dtype=lists.dtype))
    return lists.rows_at(assign, pos)


class TorchIndex:
    """Abstract index model (the FAISS-index-equivalent surface)."""

    def __init__(self, dim: int, metric: str, device="cuda"):
        if metric not in ("dot", "l2"):
            raise RuntimeError("Only dot and l2 metrics are supported.")
        self.dim = dim
        self.metric = metric
        self.nprobe = 1
        self.device = resolve_device(device)

    @property
    def is_trained(self) -> bool:
        raise NotImplementedError

    @property
    def ntotal(self) -> int:
        raise NotImplementedError

    def train(self, x: np.ndarray) -> None:
        raise NotImplementedError

    def add(self, x: np.ndarray) -> None:
        """Append vectors; ids are sequential (positional metadata join)."""
        raise NotImplementedError

    def search(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def search_batched(self, q: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The serving scheduler's launch target (one coalesced window)."""
        return self.search(q, k)

    def set_nprobe(self, nprobe: int) -> None:
        self.nprobe = int(nprobe)

    def get_centroids(self) -> Optional[np.ndarray]:
        return None

    def supports_remove_rows(self) -> bool:
        """True when this model carries a tombstone mask (overrides
        ``remove_rows``). The engine asks before it records any tombstone,
        also for rows still in the add buffer."""
        return type(self).remove_rows is not TorchIndex.remove_rows

    def remove_rows(self, rows: np.ndarray) -> None:
        """Tombstone rows (positional ids) out of every scan: a masked row
        never surfaces in a top-k, even when k exceeds the live rows.
        ``ntotal`` does not shrink (the positional metadata join);
        compaction reclaims the rows. Idempotent."""
        raise RuntimeError(
            f"{type(self).__name__} does not support remove/upsert "
            "(no tombstone mask for this index kind)")

    def state_dict(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "TorchIndex":
        raise NotImplementedError


def finalize_results(scores: np.ndarray, ids: np.ndarray, metric: str):
    """ops-convention (bigger-better scores, int32 ids) -> FAISS-style (D, I)."""
    ids = ids.astype(np.int64)
    if metric == "l2":
        return -scores, ids
    return scores, ids


MAX_QUERY_BLOCK = 1024
# bound on one query block's gathered per-probe payload (the JAX package's
# 2x-the-group-budget rule, models/ivf.py _GROUP_BYTE_BUDGET)
_QUERY_PAYLOAD_BUDGET = 256 * 1024 * 1024


def pick_query_block(probe_bytes_per_query: int, minimum: int = 256) -> int:
    """Largest power-of-two query block (<= MAX_QUERY_BLOCK) whose gathered
    per-probe payload fits the byte budget. Kept from the JAX package so
    the probe grouping — and with it the top-k merge order — matches."""
    block = MAX_QUERY_BLOCK
    while block > minimum and block * probe_bytes_per_query > _QUERY_PAYLOAD_BUDGET:
        block //= 2
    return block


def blocked_search(q: np.ndarray, k: int, metric: str, fn, device, block: int = 256):
    """One ``fn`` call per query block: ``fn(q_block_tensor)`` returns
    bigger-is-better (scores, ids) tensors; results land in host arrays.
    Query rows are independent, so blocks need no padding."""
    q = np.asarray(q, np.float32)
    nq = q.shape[0]
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    for s in range(0, nq, block):
        with xfercheck.explicit("blocked_search query block upload"):
            qb = torch.from_numpy(np.ascontiguousarray(q[s:s + block])).to(device)
        vals, ids = fn(qb)
        with xfercheck.explicit("blocked_search block result fetch"):
            out_s[s:s + qb.shape[0]] = vals.cpu().numpy()
            out_i[s:s + qb.shape[0]] = ids.cpu().numpy()
    return finalize_results(out_s, out_i, metric)
