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
  (list, slot). Where a card cannot hold the doubled planes beside the
  old ones, the old ones wait on the host while the doubled ones are
  made. The ids plane starts at -1, so every never-written slot
  is masked by ``id < 0`` in the scan, and so is every cell
  ``mask_cells`` tombstones. Appends are planned on the host
  (``plan_append``) and land as one scatter.

Searches run through ``blocked_search``, the JAX package's block loop:
query blocks padded to their pow2 bucket, and a batch of several blocks
as one program over the stacked blocks, each a program of the model's
``utils/programs.py`` cache (a CUDA graph on a card). The JAX package's
write/append/mask bucketing existed to bound XLA recompiles of the
mutation programs, which the port runs op by op, so it is not carried
over. The masks scatter exactly the addresses given, checked on the host
first: the JAX package pads its scatters with an address one past the
end that XLA drops, where a CUDA index kernel would trip a device-side
assert instead.

Convention: models speak FAISS-style at their boundary — ``search`` returns
(D, I) with D ascending for l2 / descending inner products for dot, ids are
int64, missing results are id -1.
"""

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distributed_faiss_tpu_torch.ops import distance
from distributed_faiss_tpu_torch.utils import programs as programs_mod
from distributed_faiss_tpu_torch.utils import xfercheck
from distributed_faiss_tpu_torch.utils.device import resolve_device

logger = logging.getLogger()

# _grow copies the old planes into the doubled ones this many bytes at a
# time (a piece from the host passes through a contiguous device buffer)
GROW_CHUNK_BYTES = 1 << 30
# the card memory _grow leaves free beside the doubled planes (the chunk
# buffer, and whatever runs beside the add)
GROW_HEADROOM_BYTES = 2 << 30

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
        """Double the capacity until ``needed_cap`` fits, copying the old
        planes in list by list, GROW_CHUNK_BYTES at a time. Where the card
        cannot hold the doubled planes beside the old ones, the old ones
        wait on the host meanwhile (``_grow_waits_on``). If the doubled
        planes cannot be made, the old ones are put back as they were and
        the error is raised."""
        newcap = _next_pow2(needed_cap, self.cap)
        if newcap == self.cap:
            return
        t0 = time.perf_counter()
        slot_bytes = (int(np.prod(self.payload_shape, dtype=np.int64)) * self.data.element_size()
                      + 4)
        waits_on = self._grow_waits_on(self.nlist * newcap * slot_bytes)
        old_data, old_ids = self.data.to(waits_on), self.ids.to(waits_on)
        self.data = self.ids = None
        data = ids = None
        try:
            data = torch.zeros((self.nlist, newcap) + self.payload_shape, dtype=self.dtype,
                               device=self.device)
            ids = torch.full((self.nlist, newcap), -1, dtype=torch.int32, device=self.device)
            step = max(1, GROW_CHUNK_BYTES // (self.cap * slot_bytes))
            for s in range(0, self.nlist, step):
                data[s:s + step, : self.cap] = old_data[s:s + step]
                ids[s:s + step, : self.cap] = old_ids[s:s + step]
        except BaseException:
            data = ids = None
            self.data, self.ids = old_data.to(self.device), old_ids.to(self.device)
            raise
        self.data, self.ids, self.cap = data, ids, newcap
        if self.device.type == "cuda":  # the copies done, for the time logged
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        logger.info("padded lists %s grown to cap %d in %.3f s, the old planes waiting on %s",
                    tuple(data.shape), newcap, time.perf_counter() - t0, waits_on)

    def _grow_waits_on(self, new_bytes: int) -> torch.device:
        """Where the old planes wait while ``new_bytes`` of doubled ones are
        made: on the device, unless it is a card whose driver reports less
        free memory than those bytes and GROW_HEADROOM_BYTES; then on the
        host. (At 262,144 lists of 768 sq8 bytes the step from cap 128 to
        256 would hold 77.3 GB on the card.)"""
        if self.device.type != "cuda":
            return self.device
        free, _ = torch.cuda.mem_get_info(self.device)
        if free >= new_bytes + GROW_HEADROOM_BYTES:
            return self.device
        return torch.device("cpu")

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
        # the captured search programs (utils/programs.py)
        self.programs = programs_mod.ProgramCache()

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

    def release_programs(self) -> None:
        """Free the captured search programs and their memory pool (the
        engine swapped this model out)."""
        self.programs.clear()

    def program_stats(self) -> dict:
        """The program cache's counters (``ProgramCache.stats``)."""
        return self.programs.stats()

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


def query_blocks(q: np.ndarray, block: int = 256):
    """Split a query batch into blocks, each padded with zero rows to its
    ``bucket_size``, so a block of 100 rows and one of 120 share a
    program: yields (start, rows, padded block)."""
    nq = q.shape[0]
    for s in range(0, nq, block):
        chunk = q[s:s + block]
        yield s, chunk.shape[0], distance.pad_rows(chunk, distance.bucket_size(chunk.shape[0]))


def map_blocks(body, q3: torch.Tensor):
    """``lax.map``'s counterpart: ``body`` over each (block, d) block of
    the stacked (nblocks, block, d) queries in turn, the (scores, ids)
    stacked. Blocks run one after another, so the transients sized for one
    block still bound the program."""
    outs = [body(qb) for qb in q3]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def per_block(fused):
    """The per-block program of a fused one: the same body over one
    (bucket, d) block."""
    return lambda qb: tuple(t[0] for t in fused(qb[None]))


def blocked_search(q: np.ndarray, k: int, metric: str, fn, device, block: int = 256,
                   fused_fn=None, programs=None):
    """THE blocked search loop (the JAX package's ``base.blocked_search``,
    shared by the flat, IVF and mesh models so the bucketing and padding
    policy cannot drift between them).

    ``fn`` maps a (bucket, d) device block to bigger-is-better (scores,
    ids) tensors; ``fused_fn`` maps stacked (nblocks, block, d) blocks to
    (nblocks, block, k) results. Default: one program a query block, the
    block padded to its ``bucket_size``. When the batch spans more than one
    block and ``fused_fn`` is given, the batch is padded to
    ``_next_pow2(ceil(nq / block), 1)`` blocks and runs as ONE program, so
    the set of window programs stays O(log max batch). Padded rows are
    zeros, and their results are cut.

    ``programs`` (``ProgramCache.bind``: the model's cache with this
    search's static arguments and read state) runs each block or window as
    a captured program; None runs it op by op. Either way a block or a
    window is one upload and one fetch of scores and ids."""
    q = np.asarray(q, np.float32)
    nq = q.shape[0]
    run = programs.run if programs is not None else (
        lambda name, f, x, dev: programs_mod.run_eager(f, x, dev))
    if fused_fn is not None and nq > block:
        nblocks = _next_pow2(-(-nq // block), 1)
        qp = np.pad(q, ((0, nblocks * block - nq), (0, 0)))
        vals, ids = run("fused", fused_fn, qp.reshape(nblocks, block, -1), device)
        return finalize_results(vals.reshape(nblocks * block, -1)[:nq],
                                ids.reshape(nblocks * block, -1)[:nq], metric)
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    for s, n, chunk in query_blocks(q, block):
        vals, ids = run("block", fn, chunk, device)
        out_s[s:s + n] = vals[:n]
        out_i[s:s + n] = ids[:n]
    return finalize_results(out_s, out_i, metric)
