"""Mesh parallelism in one process: the corpus sharded over an ordered list
of devices (counterpart of distributed_faiss_tpu/parallel/mesh.py).

The JAX package lets one server rank own a whole ``jax.sharding.Mesh``:
one program, the corpus sharded over the ``shard`` axis, the cross-chip
traffic XLA collectives (``all_gather``, ``psum``). The port keeps that
shape. A ``Mesh`` is an ordered list of ``torch.device``s along ``AXIS``;
each shard's tensors live on its device; ``all_gather`` stacks the shards'
tensors on the mesh's first device and ``psum`` sums them there (a peer
copy between cards, nothing on one card). It does not use
``torch.distributed``: the mesh is one process, as in the JAX package, and
NCCL refuses two ranks of one communicator on one card.

``make_mesh(n, device, virtual=True)`` places n shards round-robin over
the visible devices: n shards on one CPU in the tests (the counterpart of
the JAX tests' 8 forced host devices), n shards on one card in
``chip_smoke.py``. Sharding on one device adds no capacity; it runs the
mesh's code path, its merge and its kernels.

Components (the JAX package's names):
- ``make_mesh``, ``all_gather``, ``psum``;
- ``local_scan_merge`` / ``sharded_knn``: each shard scans its row block
  (``ops.distance._knn_scan``), local ids become global (shard *
  cap_local + pos), the (nq, k) candidates are gathered and merged;
- ``sharded_kmeans``: Lloyd steps accumulated per shard
  (``ops.kmeans.accumulate_clusters``) and reduced with ``psum``;
- ``ShardedFlatIndex``: exact search over a row-sharded corpus;
- ``IvfTpuIndex``: IVF-Flat whose coarse k-means trains sharded; its scan
  is the single-device IVF-Flat path (K1);
- ``ShardedPaddedLists``: inverted lists partitioned over the shards
  (strided ownership: list l on shard l % S at slot l // S);
- ``ShardedIVFFlatIndex`` / ``ShardedIVFPQIndex``: IVF over sharded lists.

The sharded IVF scans run the port's hand kernels on every shard, where
the JAX package scores with an XLA einsum. Masked mode: for shard s the
probed lists ``li`` become ``li_local = where(li % S == s, li // S, 0)``
and their sizes ``where(owned, sizes_local[li_local], 0)``, so K1
(``ops.flat_scan.flat_list_scan``) and K3 over the lists
(``ops.adc_scan.adc_scan_lists``) compute exactly the JAX body's masked
scores and skip the pairs the shard does not own; in the other PQ
geometry the gathered codes go through K2 (``adc_scan``) and are masked
after it. Routed mode (the JAX package's ``_routed_pairs_local``): each
shard compacts the (query, probe) pairs it owns into a fixed bucket of
``routed_pair_bucket`` slots, in query order, scores them in pieces of
whole pair groups (``_routed_piece``) with K1 (the gathered query rows,
one probe each) or K3 (one LUT per pair), and reduces them per query;
owned pairs past the bucket are dropped and counted, and
``_routed_search_blocks`` runs such a block again with the bucket doubled
until none drops.

One "launch" (``index.launches``): in masked mode one call of a model's
search entry, which loops over the query blocks of the call, scans every
shard and merges on the mesh's first device before the results reach the
host; in routed mode, as the JAX package counts them (``_counted``), one
a query block of ``_routed_block_size`` rows and one more for each
relaunch at a grown bucket. The engine diffs the counter around each
scheduler window into ``device_launches`` / ``rows_per_launch``. The
kernels' own launches a shard are in ``index.shard_launches`` (tallied
around that shard's calls, and added again by each replay of a captured
program).

Programs: on a mesh whose shards all lie on one device (the card
machine's virtual shards), a query block's search and a multi-block batch
(``_sharded_knn_fused``, ``_sharded_ivf_flat_search_fused``,
``_sharded_ivf_pq_search_fused``) are captured and replayed through the
model's program cache, as the JAX package runs its fused masked entries;
so is each routed block (``_sharded_ivf_flat_search_routed``,
``_sharded_ivf_pq_search_routed``: one program a block bucket and pair
bucket, as the JAX package compiles one a shape and ``pair_bucket``), its
real-row count uploaded with the queries and its drop count fetched with
the results. A mesh over several devices runs op by op (``_programs``).
"""

import functools
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from distributed_faiss_tpu_torch.models import base
from distributed_faiss_tpu_torch.models import ivf as ivfmod
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.ops import adc_scan, distance, flat_scan, pq
from distributed_faiss_tpu_torch.ops import kmeans as km
from distributed_faiss_tpu_torch.utils import programs as programs_mod
from distributed_faiss_tpu_torch.utils.config import MeshCfg
from distributed_faiss_tpu_torch.utils.device import resolve_device

AXIS = "shard"

# the JAX package's sync bucket (models/base.py DeviceVectorStore.WRITE_BUCKET):
# the flat corpus grows so that the next bucket of rows fits, as there
_WRITE_BUCKET = 1024
# the JAX package's bound on a routed block's per-shard transients
_ROUTED_TRANSIENT_BUDGET = 256 * 1024 * 1024
# bound on one routed scoring call's transients (scores, LUTs, gathered codes)
_ROUTED_PIECE_BYTES = 256 * 1024 * 1024

logger = logging.getLogger()


class Mesh:
    """An ordered list of devices along ``AXIS`` (shard s lives on
    ``devices[s]``); ``shape[AXIS]`` is the shard count."""

    def __init__(self, devices):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        """Where ``all_gather`` and ``psum`` land: the first shard's device."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, device="cuda", virtual: bool = False) -> Mesh:
    """1D mesh over the visible devices of ``device``'s type.

    ``n_devices=None`` applies the per-host ``MeshCfg`` default
    (DFT_MESH_DEVICES), so snapshot restores (``from_state_dict`` builds
    with ``mesh=None``) honor the same host sizing as factory builds; 0
    means every visible device. More shards than visible devices raise,
    unless ``virtual`` or the host's DFT_MESH_VIRTUAL (which, like the JAX
    tests' forced host device count, holds for every mesh of the process):
    then the shards take the devices round-robin."""
    cfg = MeshCfg.from_env()
    if n_devices is None:
        n_devices = cfg.devices
    virtual = virtual or cfg.virtual
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device("cpu")]
    n = int(n_devices) or len(visible)
    if n > len(visible) and not virtual:
        raise ValueError(f"requested {n} devices, have {len(visible)}")
    return Mesh([visible[i % len(visible)] for i in range(n)])


def all_gather(mesh: Mesh, parts) -> torch.Tensor:
    """The shards' tensors stacked (S, ...) on the mesh's first device."""
    return torch.stack([p.to(mesh.root) for p in parts])


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """The sum of the shards' tensors, on the mesh's first device."""
    out = parts[0].to(mesh.root).clone()
    for p in parts[1:]:
        out += p.to(mesh.root)
    return out


def shard_rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """Split a (S * per, ...) array into its S contiguous row blocks, each
    on its shard's device (the JAX package's row sharding)."""
    x = torch.as_tensor(x)
    per = x.shape[0] // mesh.size
    if per * mesh.size != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split into {mesh.size} shards")
    return [x[s * per:(s + 1) * per].to(dev).contiguous() for s, dev in enumerate(mesh.devices)]


def merge_shards(mesh: Mesh, vals, ids, k: int):
    """All-gather the shards' (nq, k) candidates and keep the top k of
    each query; -inf slots come back with id -1."""
    av = all_gather(mesh, vals)  # (S, nq, k)
    ai = all_gather(mesh, ids)
    nq = av.shape[1]
    fv = av.permute(1, 0, 2).reshape(nq, -1)
    fi = ai.permute(1, 0, 2).reshape(nq, -1)
    best, pos = torch.topk(fv, k, dim=1)
    out = torch.gather(fi, 1, pos)
    return best, torch.where(torch.isneginf(best), torch.full_like(out, -1), out)


def _index_device(mesh: Optional[Mesh], device):
    """A sharded model's device: the mesh's first one when a mesh is given,
    else ``device`` (default cuda)."""
    if device is None:
        return mesh.root if mesh is not None else "cuda"
    return device


def _counted_search(index, q: np.ndarray, k: int, run, block: int, fused_fn=None,
                    programs=None):
    """One counted launch (module docstring) over every query block of
    ``q``: ``run(q_block)`` returns bigger-is-better (scores, ids);
    ``fused_fn`` and ``programs`` as ``models.base.blocked_search``."""
    index.launches += 1
    return base.blocked_search(q, k, index.metric, run, index.device, block=block,
                               fused_fn=fused_fn, programs=programs)


def _programs(index, prefix: str, static: tuple, reads: tuple):
    """The model's programs for a search on a mesh whose shards all lie on
    one device; None (op by op) across devices."""
    if len(set(index.mesh.devices)) > 1:
        return None
    return index.programs.bind(prefix, static, reads)


# --------------------------------------------------------------------- search


def local_scan_merge(mesh: Mesh, q: torch.Tensor, x, ntotals, k: int, metric: str,
                     chunk: int, live=None):
    """Per-shard exact scan + all_gather merge, the body of every sharded
    exact search: shard s scans its block ``x[s]`` (rows >= ``ntotals[s]``
    and rows ``live[s]`` marks False are masked), its local ids become
    global (shard * cap_local + pos), and the (nq, k) candidates merge."""
    vals, ids = [], []
    for s, dev in enumerate(mesh.devices):
        x_local = x[s]
        cap_local = x_local.shape[0]
        v, i = distance._knn_scan(q.to(dev), x_local, int(ntotals[s]), k, metric,
                                  min(chunk, cap_local),
                                  live=None if live is None else live[s])
        vals.append(v)
        ids.append(torch.where(i >= 0, i + s * cap_local, i))
    return merge_shards(mesh, vals, ids, k)


def _sharded_knn_fused(mesh: Mesh, q3, x, ntotals, k: int, metric: str, chunk: int,
                       live=None):
    """The sharded exact search of each block of the stacked (nblocks,
    block, d) queries, block after block, as one program (the JAX
    package's ``_sharded_knn_fused``)."""
    return base.map_blocks(
        lambda qb: local_scan_merge(mesh, qb, x, ntotals, k, metric, chunk, live=live), q3)


def _knn_chunk(cap_local: int, chunk: int = 65536) -> int:
    """Largest power-of-two scan chunk that divides the per-shard capacity."""
    c = 1
    while c * 2 <= min(chunk, cap_local) and cap_local % (c * 2) == 0:
        c *= 2
    return c


def sharded_knn(mesh: Mesh, q, x, ntotals, k: int, metric: str = "l2", chunk: int = 65536,
                live=None):
    """Exact k-nn over a row-sharded corpus (``x``: one (cap_local, d)
    block a shard, ``ntotals``: the shards' fill counts) with the merge on
    the mesh. ``chunk`` is clamped to the largest power-of-two divisor of
    the per-shard capacity. Returns bigger-is-better (scores, ids int32)."""
    q = torch.as_tensor(q, dtype=torch.float32, device=mesh.root)
    return local_scan_merge(mesh, q, x, ntotals, k, metric, _knn_chunk(x[0].shape[0], chunk),
                            live=live)


# --------------------------------------------------------------------- kmeans


def kmeans_step(mesh: Mesh, xs, ws, cent: torch.Tensor, k: int) -> torch.Tensor:
    """One sharded Lloyd iteration: each shard accumulates its chunked rows
    (``xs[s]``: (nchunks, chunk, d), ``ws[s]``: 0/1 weights), ``psum``
    reduces the sums and counts, and an empty cluster keeps its centroid."""
    sums, counts = [], []
    for s, dev in enumerate(mesh.devices):
        a, b = km.accumulate_clusters(xs[s], ws[s], cent.to(dev), k)
        sums.append(a)
        counts.append(b)
    sums, counts = psum(mesh, sums), psum(mesh, counts)
    return torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], cent)


def sharded_kmeans(mesh: Mesh, x, k: int, iters: int = 10, seed: int = 0,
                   chunk: int = None) -> torch.Tensor:
    """Lloyd k-means over a mesh-sharded training set -> (k, d) fp32
    centroids on the mesh's first device.

    x (an array, or a tensor anywhere) is padded to a shard multiple with
    zero-weight rows, ``chunk`` dividing each shard's rows, and split over
    the shards. Init: for k <= 16384, k-means++ (``ops.kmeans.kmeans`` with
    no Lloyd step) on a subsample drawn with numpy from ``seed``; past
    that, k random rows. The subsample and the random rows are the JAX
    package's; the ++ draws are torch's (its draws are threefry's)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.device.type == "cpu" and mesh.root.type != "cpu":
        x = x.to(mesh.root)
    n, d = x.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    S = mesh.size
    per = -(-n // S)
    chunk = min(km.auto_chunk(k, chunk), per)
    per = -(-per // chunk) * chunk  # chunk must divide the per-shard rows
    npad = per * S
    w = torch.zeros(npad, dtype=torch.float32, device=x.device)
    w[:n] = 1.0
    xp = torch.nn.functional.pad(x, (0, 0, 0, npad - n)) if npad != n else x
    xs = [xp[s * per:(s + 1) * per].to(dev).reshape(per // chunk, chunk, d)
          for s, dev in enumerate(mesh.devices)]
    ws = [w[s * per:(s + 1) * per].to(dev).reshape(per // chunk, chunk)
          for s, dev in enumerate(mesh.devices)]
    rng = np.random.default_rng(seed)
    if k <= 16384:
        sample_n = min(n, max(4 * k, 16384))
        pick = torch.as_tensor(rng.permutation(n)[:sample_n], device=x.device)
        cent = km.kmeans(x[pick], k, iters=0, seed=seed, init="kmeans++")
    else:
        cent = x[torch.as_tensor(rng.permutation(n)[:k], device=x.device)].clone()
    cent = cent.to(mesh.root)
    for _ in range(iters):
        cent = kmeans_step(mesh, xs, ws, cent, k)
    return cent


# --------------------------------------------------------------- index models


class ShardedFlatIndex(base.TorchIndex):
    """Exact-search index whose corpus is sharded over a mesh.

    Rows are packed in contiguous blocks: global id = shard * cap_local +
    local position = insertion order. Host-pending rows land on the shards
    at the next search (incremental: only new rows are copied, unless the
    capacity grows, geometrically, and the blocks are re-split). The
    search is ``sharded_knn``; deleted rows are masked by a per-shard live
    mask, allocated at the first delete."""

    def __init__(self, dim: int, metric: str = "l2", mesh: Optional[Mesh] = None,
                 device=None):
        super().__init__(dim, metric, _index_device(mesh, device))
        self.mesh = mesh or make_mesh(device=self.device)
        self.device = self.mesh.root
        self.nshards = self.mesh.size
        self._pending: list = []
        self._n = 0
        self.launches = 0
        self._dev: Optional[List[torch.Tensor]] = None  # S x (cap_local, d)
        self._ntotals: List[int] = []
        self._cap_local = 0
        self._synced_n = 0
        self._live: Optional[List[torch.Tensor]] = None  # S x (cap_local,) bool
        self._pending_dead: list = []

    @property
    def is_trained(self) -> bool:
        return True

    @property
    def ntotal(self) -> int:
        return self._n

    def train(self, x: np.ndarray) -> None:
        pass

    def add(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        if x.shape[0] == 0:
            return
        self._pending.append(x)
        self._n += x.shape[0]

    def _flat(self, parts) -> torch.Tensor:
        return torch.cat([p.to(self.mesh.root) for p in parts])

    def _split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        per = self._cap_local
        return [flat[s * per:(s + 1) * per].to(dev).clone()
                for s, dev in enumerate(self.mesh.devices)]

    def _sync(self) -> None:
        if self._synced_n == self._n and self._dev is not None:
            return
        S, per = self.nshards, self._cap_local
        n_new = self._n - self._synced_n
        bucket = base._next_pow2(max(n_new, 1), _WRITE_BUCKET)
        if self._dev is None or self._n + bucket > S * per:
            per = base._next_pow2(max(1, -(-(self._n + bucket) // S)), 8)
            flat = torch.zeros((S * per, self.dim), dtype=torch.float32, device=self.mesh.root)
            live = None
            if self._dev is not None:
                flat[: self._synced_n] = self._flat(self._dev)[: self._synced_n]
            if self._live is not None:
                live = torch.ones(S * per, dtype=torch.bool, device=self.mesh.root)
                live[: S * self._cap_local] = self._flat(self._live)
            self._cap_local = per
            self._dev = self._split(flat)
            self._live = None if live is None else self._split(live)
        if n_new:
            rows = torch.as_tensor(np.concatenate(self._pending))
            for s, dev in enumerate(self.mesh.devices):
                lo = max(self._synced_n, s * per)
                hi = min(self._n, (s + 1) * per)
                if lo < hi:
                    self._dev[s][lo - s * per:hi - s * per] = \
                        rows[lo - self._synced_n:hi - self._synced_n].to(dev)
        self._pending = []
        self._synced_n = self._n
        self._ntotals = [int(c) for c in np.clip(self._n - np.arange(S) * per, 0, per)]
        if self._pending_dead:
            dead, self._pending_dead = self._pending_dead, []
            self._mask_now(np.concatenate(dead))

    def _mask_now(self, rows: np.ndarray) -> None:
        per = self._cap_local
        if self._live is None:
            self._live = [torch.ones(per, dtype=torch.bool, device=dev)
                          for dev in self.mesh.devices]
        for s, dev in enumerate(self.mesh.devices):
            local = rows[rows // per == s] % per
            if local.size:
                self._live[s][torch.as_tensor(local, device=dev)] = False

    def remove_rows(self, rows: np.ndarray) -> None:
        """Tombstone rows (global ids == flat positions) in the live mask;
        rows still host-pending are masked by the sync that lands them."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        if rows.min() < 0 or rows.max() >= self._n:
            raise IndexError(f"row out of range [0, {self._n})")
        pending = rows[rows >= self._synced_n]
        synced = rows[rows < self._synced_n]
        if pending.size:
            self._pending_dead.append(pending)
        if synced.size and self._dev is not None:
            self._mask_now(synced)

    def search(self, q: np.ndarray, k: int):
        if self._n == 0:
            d = np.full((q.shape[0], k), np.inf if self.metric == "l2" else -np.inf, np.float32)
            return d, np.full((q.shape[0], k), -1, np.int64)
        self._sync()
        chunk = _knn_chunk(self._cap_local)
        reads = (self._dev, self._ntotals, self._live)

        def run_fused(q3):
            return _sharded_knn_fused(self.mesh, q3, self._dev, self._ntotals, k, self.metric,
                                      chunk, live=self._live)

        return _counted_search(self, q, k, base.per_block(run_fused),
                               base.pick_query_block(65536 * 4), fused_fn=run_fused,
                               programs=_programs(self, "sharded_flat",
                                                  (k, self.metric, chunk), reads))

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        out = np.zeros((ids.size, self.dim), np.float32)
        if ids.size == 0 or self._n == 0:
            return out
        self._sync()
        per = self._cap_local
        for s, dev in enumerate(self.mesh.devices):
            sel = np.nonzero(ids // per == s)[0]
            if sel.size:
                out[sel] = base.to_numpy(self._dev[s][torch.as_tensor(ids[sel] % per,
                                                                      device=dev)])
        return out

    def state_dict(self) -> Dict[str, np.ndarray]:
        if self._n:
            self._sync()
            rows = base.to_numpy(self._flat(self._dev)[: self._n])
        else:
            rows = np.zeros((0, self.dim), np.float32)
        return {"kind": "sharded_flat", "dim": self.dim, "metric": self.metric,
                "trained": True, "rows": rows}

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "ShardedFlatIndex":
        idx = cls(int(state["dim"]), str(state["metric"]), device=device)
        rows = np.asarray(state["rows"], np.float32)
        if rows.shape[0]:
            idx.add(rows)
        return idx


class IvfTpuIndex(IVFFlatIndex):
    """The ``ivf_tpu`` builder: IVF whose coarse k-means trains sharded over
    the mesh; the list scan is the single-device IVF-Flat path (K1). Its
    snapshots are of kind ``ivf_flat``, as in the JAX package."""

    def __init__(self, dim: int, nlist: int, metric: str = "l2", codec: str = "f32", *,
                 mesh: Optional[Mesh] = None, kmeans_iters: int = 10, device=None, **kwargs):
        super().__init__(dim, nlist, metric, codec, kmeans_iters=kmeans_iters,
                         device=_index_device(mesh, device), **kwargs)
        self.mesh = mesh or make_mesh(device=self.device)

    def _train_centroids(self, x) -> None:
        self.centroids = sharded_kmeans(self.mesh, x, self.nlist,
                                        iters=self.kmeans_iters).to(self.device)


# ----------------------------------------------------- sharded inverted lists


class ShardedPaddedLists:
    """Inverted lists partitioned over the mesh (strided ownership: list l
    lives on shard l % S at local slot l // S). The same append / mask /
    rows surface as ``models.base.PaddedLists``, with ``data``, ``ids`` and
    ``sizes`` held as one tensor a shard: ``data[s]`` (nlist_local, cap,
    ...), ``ids[s]`` (nlist_local, cap) int32 (-1: empty or deleted),
    ``sizes[s]`` (nlist_local,) int32; the shards' padding slots (past
    ``nlist``) stay empty. Flat cell addresses run over the padded slots:
    ``slot_of(l) * cap + pos``."""

    MIN_CAP = 64

    def __init__(self, nlist: int, payload_shape, dtype: torch.dtype, mesh: Mesh,
                 min_cap: int = None):
        self.mesh = mesh
        self.S = mesh.size
        self.nlist = nlist
        self.nlist_local = -(-nlist // self.S)
        self.nlist_pad = self.nlist_local * self.S
        self.payload_shape = tuple(payload_shape)
        self.dtype = dtype
        self.device = mesh.root
        self.cap = min_cap or self.MIN_CAP
        self._check_cell_space(self.cap)
        self.data = [torch.zeros((self.nlist_local, self.cap) + self.payload_shape, dtype=dtype,
                                 device=dev) for dev in mesh.devices]
        self.ids = [torch.full((self.nlist_local, self.cap), -1, dtype=torch.int32, device=dev)
                    for dev in mesh.devices]
        self.sizes_host = np.zeros(nlist, np.int64)
        self.sizes = [torch.zeros(self.nlist_local, dtype=torch.int32, device=dev)
                      for dev in mesh.devices]

    @property
    def ntotal(self) -> int:
        return int(self.sizes_host.sum())

    def slot_of(self, l):
        """Global list id -> flat padded slot (strided ownership)."""
        return (l % self.S) * self.nlist_local + l // self.S

    def _sizes_padded(self) -> np.ndarray:
        out = np.zeros(self.nlist_pad, np.int64)
        out[self.slot_of(np.arange(self.nlist))] = self.sizes_host
        return out

    def _check_cell_space(self, cap: int) -> None:
        """Cell addresses over the whole padded space (``nlist_pad * cap``)
        are int32 in the JAX package's layout; past int32 they would wrap.
        Refuse the configuration, as the JAX package does."""
        total = self.nlist_pad * cap
        if total > np.iinfo(np.int32).max:
            raise ValueError(
                f"sharded cell space nlist_pad({self.nlist_pad}) * cap({cap}) "
                f"= {total} overflows int32 addressing; shard over more devices "
                f"or split the index")

    def _grow(self, needed_cap: int) -> None:
        newcap = base._next_pow2(needed_cap, self.cap)
        if newcap == self.cap:
            return
        self._check_cell_space(newcap)
        for s, dev in enumerate(self.mesh.devices):
            data = torch.zeros((self.nlist_local, newcap) + self.payload_shape,
                               dtype=self.dtype, device=dev)
            data[:, : self.cap] = self.data[s]
            ids = torch.full((self.nlist_local, newcap), -1, dtype=torch.int32, device=dev)
            ids[:, : self.cap] = self.ids[s]
            self.data[s], self.ids[s] = data, ids
        self.cap = newcap

    def append(self, list_idx: np.ndarray, payload, gids: np.ndarray) -> np.ndarray:
        """Append payload rows to their lists; each shard takes the rows
        whose cells fall in its range and drops the rest. Returns the (n,)
        int32 within-list positions in input order."""
        list_idx = np.asarray(list_idx, np.int64)
        if list_idx.shape[0] == 0:
            return np.zeros(0, np.int32)
        new_sizes = self.sizes_host + np.bincount(list_idx, minlength=self.nlist)
        if new_sizes.max() > self.cap:
            self._grow(int(new_sizes.max()))
        _, order, pos, within = base.PaddedLists.plan_append(
            list_idx, self.nlist, self.cap, self.sizes_host, slot_fn=self.slot_of)
        payload = torch.as_tensor(payload)
        gids_sorted = np.asarray(gids)[order].astype(np.int32)
        per = self.nlist_local * self.cap
        for s, dev in enumerate(self.mesh.devices):
            sel = np.nonzero((pos >= s * per) & (pos < (s + 1) * per))[0]
            if sel.size == 0:
                continue
            lpos = torch.as_tensor(pos[sel] - s * per, device=dev)
            rows = payload[torch.as_tensor(order[sel], device=payload.device)]
            self.data[s].view((per,) + self.payload_shape)[lpos] = rows.to(dev, self.dtype)
            self.ids[s].view(per)[lpos] = torch.as_tensor(gids_sorted[sel], device=dev)
        self.sizes_host = new_sizes
        padded = self._sizes_padded().astype(np.int32)
        nl = self.nlist_local
        self.sizes = [torch.as_tensor(padded[s * nl:(s + 1) * nl], device=dev)
                      for s, dev in enumerate(self.mesh.devices)]
        return within

    def _split_cells(self, cells: np.ndarray):
        """(shard, shard-local cell) of each flat padded cell address."""
        per = self.nlist_local * self.cap
        return cells // per, cells % per

    def mask_cells(self, cells) -> None:
        """Tombstone list cells (flat ``slot * cap + pos`` addresses over the
        padded space): -1 into the owning shard's ids plane. Sizes are not
        decremented, so every live address stays stable until compaction."""
        cells = base._checked_addresses(cells, self.nlist_pad * self.cap, "list cell")
        if cells.size == 0:
            return
        shard, local = self._split_cells(cells)
        for s, dev in enumerate(self.mesh.devices):
            mine = local[shard == s]
            if mine.size:
                self.ids[s].view(-1)[torch.as_tensor(mine, device=dev)] = -1

    def rows_at(self, assign, pos) -> np.ndarray:
        """Host rows at (list, within-list position) pairs."""
        cells = self.slot_of(np.asarray(assign, np.int64)) * self.cap + np.asarray(pos, np.int64)
        shard, local = self._split_cells(cells)
        per = self.nlist_local * self.cap
        out = torch.empty((cells.size,) + self.payload_shape, dtype=self.dtype)
        for s, dev in enumerate(self.mesh.devices):
            sel = np.nonzero(shard == s)[0]
            if sel.size:
                flat = self.data[s].view((per,) + self.payload_shape)
                out[torch.as_tensor(sel)] = flat[torch.as_tensor(local[sel], device=dev)].cpu()
        return base.to_numpy(out)


# --------------------------------------------------------- masked IVF search


def _owned(li: torch.Tensor, sizes_local: torch.Tensor, S: int, s: int):
    """Shard s's view of a probe group ``li`` (global list ids): the local
    slots (0 where another shard owns the list) and their fill counts (0
    there), so a masked scan scores exactly the owned pairs."""
    mine = (li % S) == s
    slot = torch.where(mine, li // S, torch.zeros_like(li)).contiguous()
    sizes = torch.where(mine, sizes_local[slot.long()], torch.zeros_like(li)).contiguous()
    return slot, sizes


def _empty_topk(nq: int, k: int, dev):
    return (torch.full((nq, k), distance.NEG_INF, dtype=torch.float32, device=dev),
            torch.full((nq, k), -1, dtype=torch.int32, device=dev))


def _merge_cells(carry, s: torch.Tensor, slot: torch.Tensor, k: int):
    """Merge a group's (nq, g, cap) scores into the running top-k of LOCAL
    cell positions (slot * cap + pos): one position addresses the ids
    plane and the raw refine rows alike."""
    nq, g, cap = s.shape
    cv, pos = distance.segmented_argtopk(s.reshape(nq, g * cap), k)
    safe = torch.where(pos >= 0, pos, torch.zeros_like(pos))
    cells = torch.gather(slot.long(), 1, safe // cap) * cap + safe % cap
    cells = torch.where(pos >= 0, cells, torch.full_like(cells, -1)).to(torch.int32)
    return distance.merge_topk(carry[0], carry[1], cv, cells, k)


def _finish_local(q, vals, cells, ids_local, raw_local, k: int, metric: str):
    """A shard's (nq, k) result from its top-k of cell positions: their ids;
    with ``raw_local`` (exact refine), the shortlist rescored exactly
    against the shard's fp16 raw rows first."""
    c = cells.long()
    safe = torch.where(c >= 0, c, torch.zeros_like(c))
    ids = torch.where(c >= 0, ids_local.reshape(-1)[safe], torch.full_like(cells, -1))
    if raw_local is None:
        return vals, ids
    rows = raw_local.reshape(-1, raw_local.shape[-1])[safe]
    s = ivfmod.exact_candidate_scores(q, rows, metric)
    s = torch.where(c >= 0, s, torch.full_like(s, distance.NEG_INF))
    best, pick = torch.topk(s, k, dim=1)
    out = torch.gather(ids, 1, pick)
    return best, torch.where(torch.isneginf(best), torch.full_like(out, -1), out)


def _add_shard_launches(shard_launches, s: int, n: int) -> None:
    shard_launches[s] += n


def _shard_launches(shard_launches, s: int, launched) -> None:
    """Add the launches ``launched`` (a ``programs.tally``) counted on
    shard s, now or at each replay of the program being captured."""
    n = sum(launched.values())
    if shard_launches is not None and n:
        programs_mod.count(functools.partial(_add_shard_launches, shard_launches, s, n))


def _sharded_ivf_flat_search(mesh: Mesh, centroids, lists: ShardedPaddedLists, q, k: int,
                             nprobe: int, g: int, metric: str, list_norms=None,
                             scan_bf16: bool = False, adc_k: int = 0, raw_data=None,
                             shard_launches=None):
    """Masked sharded IVF-Flat of one query block -> (scores, ids int32).

    Each probe group runs K1 on every shard over the shard's own lists
    (``_owned``: non-owned pairs have size 0); each shard keeps a running
    top-k of its cell positions. With ``raw_data`` (the fp16 raw rows,
    laid out as the lists) each shard keeps ``adc_k`` candidates and
    rescores them exactly before the merge."""
    q = q.float()
    nq = q.shape[0]
    S = mesh.size
    local_k = adc_k if raw_data is not None else k
    qs = [q.to(dev) for dev in mesh.devices]
    carries = [_empty_topk(nq, local_k, dev) for dev in mesh.devices]
    for li in ivfmod._probe_groups(centroids, q, nprobe, g, metric):
        for s, dev in enumerate(mesh.devices):
            slot, sizes = _owned(li.to(dev), lists.sizes[s], S, s)
            with programs_mod.tally() as launched:
                sc = flat_scan.flat_list_scan(
                    qs[s], lists.data[s], lists.ids[s], slot, sizes,
                    None if list_norms is None else list_norms[s],
                    metric=metric, codec="f32", scan_bf16=scan_bf16)
            _shard_launches(shard_launches, s, launched)
            carries[s] = _merge_cells(carries[s], sc, slot, local_k)
    vals, ids = zip(*[_finish_local(qs[s], *carries[s], lists.ids[s],
                                    None if raw_data is None else raw_data[s], k, metric)
                      for s in range(S)])
    return merge_shards(mesh, vals, ids, k)


def _pq_wrapper(m: int, ksub: int):
    """The ADC kernel a PQ geometry runs: K3 over the lists, or K2."""
    return adc_scan.adc_scan_lists if adc_scan.nibble_supported(m, ksub) else adc_scan.adc_scan


def _pq_scores(lut, codes_local, ids_local, slot, sizes):
    """(P, g, cap) masked ADC scores of one shard's probe pairs: K3 over
    the shard's lists in the nibble geometry, else K2 over the gathered
    codes, masked after it."""
    P, g = slot.shape
    _, cap, m = codes_local.shape
    if adc_scan.nibble_supported(m, lut.shape[2]):
        return adc_scan.adc_scan_lists(lut, codes_local, slot, sizes, ids_local)
    codes = codes_local[slot.long()].reshape(P * g, cap, m)
    return adc_scan.mask_lists(adc_scan.adc_scan(lut, codes).reshape(P, g, cap), slot, sizes,
                               ids_local)


def _sharded_ivf_pq_search(mesh: Mesh, centroids, codebooks, lists: ShardedPaddedLists, q,
                           k: int, nprobe: int, g: int, metric: str, lut_bf16: bool = False,
                           adc_k: int = 0, raw_data=None, shard_launches=None):
    """Masked sharded IVF-PQ of one query block -> (scores, ids int32):
    each probe group's per-pair LUTs (residual for l2) are built once and
    scored on every shard over its own lists; then as
    ``_sharded_ivf_flat_search``."""
    q = q.float()
    nq = q.shape[0]
    S = mesh.size
    local_k = adc_k if raw_data is not None else k
    shared_lut = None if metric == "l2" else pq.adc_lut(q, codebooks, metric=metric)
    qs = [q.to(dev) for dev in mesh.devices]
    carries = [_empty_topk(nq, local_k, dev) for dev in mesh.devices]
    for li in ivfmod._probe_groups(centroids, q, nprobe, g, metric):
        lut = ivfmod._pq_group_lut(centroids, codebooks, q, li, metric, lut_bf16, shared_lut)
        for s, dev in enumerate(mesh.devices):
            slot, sizes = _owned(li.to(dev), lists.sizes[s], S, s)
            with programs_mod.tally() as launched:
                sc = _pq_scores(lut.to(dev), lists.data[s], lists.ids[s], slot, sizes)
            _shard_launches(shard_launches, s, launched)
            carries[s] = _merge_cells(carries[s], sc, slot, local_k)
    vals, ids = zip(*[_finish_local(qs[s], *carries[s], lists.ids[s],
                                    None if raw_data is None else raw_data[s], k, metric)
                      for s in range(S)])
    return merge_shards(mesh, vals, ids, k)


def _sharded_ivf_flat_search_fused(mesh: Mesh, centroids, lists: ShardedPaddedLists, q3,
                                   k: int, nprobe: int, g: int, metric: str, list_norms=None,
                                   scan_bf16: bool = False, adc_k: int = 0, raw_data=None,
                                   shard_launches=None):
    """The masked sharded IVF-Flat search of each block of the stacked
    (nblocks, block, d) queries, block after block, as one program (the
    JAX package's ``_sharded_ivf_flat_search_fused``)."""
    return base.map_blocks(
        lambda qb: _sharded_ivf_flat_search(
            mesh, centroids, lists, qb, k, nprobe, g, metric, list_norms=list_norms,
            scan_bf16=scan_bf16, adc_k=adc_k, raw_data=raw_data,
            shard_launches=shard_launches), q3)


def _sharded_ivf_pq_search_fused(mesh: Mesh, centroids, codebooks, lists: ShardedPaddedLists,
                                 q3, k: int, nprobe: int, g: int, metric: str,
                                 lut_bf16: bool = False, adc_k: int = 0, raw_data=None,
                                 shard_launches=None):
    """The multi-block masked sharded IVF-PQ program (see
    ``_sharded_ivf_flat_search_fused``)."""
    return base.map_blocks(
        lambda qb: _sharded_ivf_pq_search(
            mesh, centroids, codebooks, lists, qb, k, nprobe, g, metric, lut_bf16=lut_bf16,
            adc_k=adc_k, raw_data=raw_data, shard_launches=shard_launches), q3)


def _list_reads(lists: ShardedPaddedLists, *extra) -> tuple:
    """The state a sharded IVF program reads: every shard's lists, ids and
    sizes, then ``extra`` (centroids, codebooks, norms, refine rows)."""
    return (lists.data, lists.ids, lists.sizes) + extra


# --------------------------------------------------------- routed IVF search


def routed_pair_bucket(nq: int, nprobe: int, S: int, group: int, slack: float = 2.0) -> int:
    """Fixed per-shard pair budget: slack x the uniform share, group-aligned
    (the JAX package's)."""
    b = max(group, int(-(-nq * nprobe * slack // S)))
    return -(-b // group) * group


def _routed_block_size(nprobe: int, S: int, group: int, slack: float, local_k: int,
                       budget: int = _ROUTED_TRANSIENT_BUDGET) -> int:
    """Largest query block whose routed per-shard transients fit the budget:
    the JAX package's estimate (3 arrays * 4 bytes * pair_bucket * kk *
    (QB + 1), its QB=16 masked reduce) at the bucket the block would start
    with, kept so that blocks, buckets and drops are the JAX package's."""
    block = base.MAX_QUERY_BLOCK
    while block > 256:
        bucket = routed_pair_bucket(block, nprobe, S, group, slack)
        if 3 * 4 * bucket * local_k * (16 + 1) <= budget:
            break
        block //= 2
    return block


def _routed_piece(pair_bucket: int, group: int, per_pair_bytes: int) -> int:
    """Pairs a routed scoring call takes: whole groups (the JAX package's
    scan step, sized for its gathered (group, cap, d) block), as many as
    keep the call's transients within ``_ROUTED_PIECE_BYTES``; the kernels
    read the lists in place, so a call of many groups is one launch where
    a group a call is hundreds."""
    groups = max(1, _ROUTED_PIECE_BYTES // max(1, group * per_pair_bytes))
    return min(pair_bucket, groups * group)


def _routed_pairs_local(probes: torch.Tensor, nq_real, s: int, S: int, pair_bucket: int,
                        piece: int, local_k: int, cap: int, score_pairs):
    """Shard s's part of a probe-routed search of one query block (the JAX
    package's ``_routed_pairs_local``), with no read of the device.

    The pairs it owns (``li % S == s`` of a real query row, ``< nq_real``:
    padded rows own none) are compacted stably, in query order, into
    ``pair_bucket`` slots (a cumsum of the mask and a scatter; owned pairs
    past the bucket are dropped, as the JAX package's ``top_k`` keeps the
    lowest pair indices). The slots are scored ``piece`` at a time with
    ``score_pairs(qi, li, slot, valid)`` -> (piece, cap) masked scores (qi:
    query rows, li: global list ids, slot: local slots, valid: False for
    an empty slot, which must score -inf); each pair keeps its top-kk cell
    positions (slot * cap + pos) at its (query, probe) place of a dense
    (nq, nprobe, kk) block, which a query reduces to its (nq, local_k)
    top-k. Returns (scores, cells int32, dropped: max(owned - bucket, 0))."""
    nq, nprobe = probes.shape
    dev = probes.device
    n_pairs = nq * nprobe
    flat_li = probes.reshape(-1).long()
    pidx = torch.arange(n_pairs, device=dev)
    mine = ((flat_li % S) == s) & ((pidx // nprobe) < nq_real)
    owned = mine.sum()
    rank = torch.cumsum(mine.long(), 0) - 1
    dest = torch.where(mine & (rank < pair_bucket), rank, torch.full_like(rank, pair_bucket))
    sel = torch.zeros(pair_bucket + 1, dtype=torch.long, device=dev).scatter_(
        0, dest, pidx)[:pair_bucket]
    valid = torch.arange(pair_bucket, device=dev) < owned
    pair_qi = sel // nprobe
    pair_li = flat_li[sel]
    pair_slot = torch.where(valid, pair_li // S, torch.zeros_like(pair_li))
    # an empty slot lands in a dump row past the block
    pair_row = torch.where(valid, pair_qi, torch.full_like(pair_qi, nq))
    pair_j = sel % nprobe
    kk = min(local_k, cap)
    dv = torch.full((nq + 1, nprobe, kk), distance.NEG_INF, dtype=torch.float32, device=dev)
    dc = torch.full((nq + 1, nprobe, kk), -1, dtype=torch.int32, device=dev)
    for g0 in range(0, pair_bucket, piece):
        part = slice(g0, g0 + piece)
        slot = pair_slot[part]
        sc = score_pairs(pair_qi[part], pair_li[part], slot, valid[part])
        v, p = torch.topk(sc, kk, dim=1)
        c = torch.where(torch.isneginf(v), torch.full_like(p, -1), slot[:, None] * cap + p)
        dv[pair_row[part], pair_j[part]] = v
        dc[pair_row[part], pair_j[part]] = c.to(torch.int32)
    best, pos = distance.segmented_argtopk(dv[:nq].reshape(nq, nprobe * kk), local_k)
    safe = torch.where(pos >= 0, pos, torch.zeros_like(pos))
    cells = torch.gather(dc[:nq].reshape(nq, nprobe * kk), 1, safe)
    cells = torch.where(torch.isneginf(best) | (pos < 0), torch.full_like(cells, -1), cells)
    carry = _empty_topk(nq, local_k, dev)
    vals, cells = distance.merge_topk(carry[0], carry[1], best, cells, local_k)
    return vals, cells, torch.clamp(owned - pair_bucket, min=0)


def _routed_finish(mesh: Mesh, parts, k: int):
    """Merge the shards' (scores, ids, dropped) into the block's (scores,
    ids, the most any shard dropped)."""
    vals, ids = merge_shards(mesh, [p[0] for p in parts], [p[1] for p in parts], k)
    return vals, ids, all_gather(mesh, [p[2] for p in parts]).max()


def _sharded_ivf_flat_search_routed(mesh: Mesh, centroids, lists: ShardedPaddedLists, q,
                                    nq_real, k: int, nprobe: int, pair_bucket: int,
                                    group: int, metric: str, list_norms=None,
                                    scan_bf16: bool = False, adc_k: int = 0, raw_data=None,
                                    shard_launches=None):
    """Probe-routed sharded IVF-Flat of one query block -> (scores, ids
    int32, dropped): each shard scores only the pairs it owns
    (``_routed_pairs_local``), K1 over the gathered query rows (one probe
    each), rescoring its shortlist exactly first with ``raw_data``, then
    the merge. ``nq_real``: the block's real rows (a tensor or an int);
    ``group``: the JAX package's pair group, which aligns the bucket."""
    q = q.float()
    S = mesh.size
    cap = lists.cap
    local_k = adc_k if raw_data is not None else k
    piece = _routed_piece(pair_bucket, group, cap * 4 + q.shape[1] * 4)
    _, probes = distance.segmented_argtopk(distance.pairwise_scores(q, centroids, metric), nprobe)
    parts = []
    for s, dev in enumerate(mesh.devices):
        qd = q.to(dev)
        norms = None if list_norms is None else list_norms[s]
        sizes_local = lists.sizes[s]

        def score(qi, li, slot, valid, s=s, qd=qd, norms=norms, sizes_local=sizes_local):
            slot = slot[:, None].to(torch.int32).contiguous()
            sizes = torch.where(valid[:, None], sizes_local[slot.long()],
                                torch.zeros_like(slot)).contiguous()
            with programs_mod.tally() as launched:
                sc = flat_scan.flat_list_scan(qd[qi].contiguous(), lists.data[s], lists.ids[s],
                                              slot, sizes, norms, metric=metric, codec="f32",
                                              scan_bf16=scan_bf16)
            _shard_launches(shard_launches, s, launched)
            return sc[:, 0]

        v, c, dropped = _routed_pairs_local(probes.to(dev), torch.as_tensor(nq_real, device=dev),
                                            s, S, pair_bucket, piece, local_k, cap, score)
        parts.append(_finish_local(qd, v, c, lists.ids[s],
                                   None if raw_data is None else raw_data[s], k, metric)
                     + (dropped,))
    return _routed_finish(mesh, parts, k)


def _sharded_ivf_pq_search_routed(mesh: Mesh, centroids, codebooks, lists: ShardedPaddedLists,
                                  q, nq_real, k: int, nprobe: int, pair_bucket: int, group: int,
                                  metric: str, lut_bf16: bool = False, adc_k: int = 0,
                                  raw_data=None, shard_launches=None):
    """Probe-routed sharded IVF-PQ of one query block -> (scores, ids int32,
    dropped): per owned pair its LUT (of the residual to the probed
    centroid for l2), K3 over the lists (or K2 over the gathered codes,
    masked), then as the flat variant."""
    q = q.float()
    S = mesh.size
    cap = lists.cap
    m, ksub, _ = codebooks.shape
    local_k = adc_k if raw_data is not None else k
    # a pair's LUT in fp32 and its bf16 copy, its scores, K2's gathered codes
    gathered = 0 if _pq_wrapper(m, ksub) is adc_scan.adc_scan_lists else cap * m
    piece = _routed_piece(pair_bucket, group, m * ksub * 6 + cap * 4 + gathered)
    _, probes = distance.segmented_argtopk(distance.pairwise_scores(q, centroids, metric), nprobe)
    parts = []
    for s, dev in enumerate(mesh.devices):
        qd, cents, books = q.to(dev), centroids.to(dev), codebooks.to(dev)
        sizes_local = lists.sizes[s]

        def score(qi, li, slot, valid, s=s, qd=qd, cents=cents, books=books,
                  sizes_local=sizes_local):
            r = qd[qi]
            if metric == "l2":
                r = r - cents[li]
            lut = pq.adc_lut(r, books, metric=metric)
            lut = lut.to(torch.bfloat16 if lut_bf16 else torch.float32).contiguous()
            slot = slot[:, None].to(torch.int32).contiguous()
            sizes = torch.where(valid[:, None], sizes_local[slot.long()],
                                torch.zeros_like(slot)).contiguous()
            with programs_mod.tally() as launched:
                sc = _pq_scores(lut, lists.data[s], lists.ids[s], slot, sizes)
            _shard_launches(shard_launches, s, launched)
            return sc[:, 0]

        v, c, dropped = _routed_pairs_local(probes.to(dev), torch.as_tensor(nq_real, device=dev),
                                            s, S, pair_bucket, piece, local_k, cap, score)
        parts.append(_finish_local(qd, v, c, lists.ids[s],
                                   None if raw_data is None else raw_data[s], k, metric)
                     + (dropped,))
    return _routed_finish(mesh, parts, k)


def _routed_search_blocks(index, q: np.ndarray, k: int, nprobe: int, group: int, call,
                          local_k: int = None):
    """The block loop of a probe-routed search (the JAX package's).

    ``call(block, n, bucket)`` -> host (scores, ids, dropped) of one padded
    block with ``n`` real rows at pair bucket ``bucket``
    (``_routed_call``). Each block of ``_routed_block_size`` rows is one
    counted launch (``index.launches``). Dropped pairs are candidates left
    unscanned, so while a block drops any it runs again with the bucket
    doubled, one more counted launch (``index.routed_relaunches`` too; a
    new program: the JAX package's one extra compile), up to the bucket
    that holds every pair of the block;
    the grown slack stays on the index (``_routed_slack``) for later
    blocks and searches."""
    S = index.mesh.size
    q = np.asarray(q, np.float32)
    nq = q.shape[0]
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    slack = index._routed_slack
    nb = _routed_block_size(nprobe, S, group, slack, local_k if local_k is not None else k)
    for s0, n, block in base.query_blocks(q, nb):
        bq = block.shape[0]
        # every pair on one shard: a bucket this big cannot drop, so the
        # loop below ends
        hard_cap = -(-bq * nprobe // group) * group
        bucket = min(routed_pair_bucket(bq, nprobe, S, group, slack), hard_cap)
        while True:
            index.launches += 1
            vals, ids, dropped = call(block, n, bucket)
            if dropped == 0 or bucket >= hard_cap:
                break
            bucket = min(2 * bucket, hard_cap)
            slack = min(2.0 * slack, float(S))
            index.routed_relaunches += 1
            logger.info("probe routing dropped %d pairs (skewed list ownership); "
                        "retrying block with bucket=%d", dropped, bucket)
        out_s[s0:s0 + n] = vals[:n]
        out_i[s0:s0 + n] = ids[:n]
    index._routed_slack = slack
    return base.finalize_results(out_s, out_i, index.metric)


def _routed_call(index, prefix: str, static: tuple, reads: tuple, body):
    """``call`` of ``_routed_search_blocks``: ``body(bucket)``, a block's
    search ``(queries, nq_real) -> (scores, ids, dropped)``, run as the
    program ``<prefix>.routed`` of its bucket on a mesh whose shards all
    lie on one device (``_programs``), else op by op; the queries and the
    real-row count go up in one upload, the three outputs come back in
    one fetch."""
    programs = _programs(index, prefix, static, reads)

    def call(block: np.ndarray, n: int, bucket: int):
        x = (block, np.array([n], np.int32))
        if programs is None:
            return programs_mod.run_eager(body(bucket), x, index.device)
        return programs.run("routed", body(bucket), x, index.device, static=(bucket,))

    return call


# ------------------------------------------------------ sharded IVF models


def _refine_rows_state(index) -> np.ndarray:
    """The fp16 raw refine rows in id order, streamed back from the
    sharded raw-row lists through the id -> (list, pos) map."""
    return index._rows_in_insertion_order(lists=index.raw_lists)


def _refine_data(index):
    """The shards' fp16 raw-row lists a refining search rescores from (laid
    out as the payload lists), or None when the index does not refine."""
    if not (index.refine_k_factor and index.raw_lists is not None):
        return None
    if index.raw_lists.cap != index.lists.cap:
        raise RuntimeError("raw/payload list capacities diverged")
    return index.raw_lists.data


class ShardedIVFFlatIndex(IVFFlatIndex):
    """IVF-Flat with mesh-sharded inverted lists: coarse k-means trains with
    ``psum``, fp32 lists (and the stored-norms sidecar) are partitioned over
    the shards, search runs K1 on every shard and merges on the mesh. The
    ``ivf_tpu`` builder's ``shard_lists=True``.

    ``scan_bf16`` is legal only with ``refine_k_factor`` (the parent's
    rule); the refine rows live in sharded fp16 lists laid out as the
    payload lists, rescored on each shard before the merge.
    ``probe_routing`` selects the routed scan (module docstring)."""

    def __init__(self, dim: int, nlist: int, metric: str = "l2", mesh: Optional[Mesh] = None,
                 kmeans_iters: int = 10, probe_routing: bool = False, refine_k_factor: int = 0,
                 scan_bf16: bool = False, device=None):
        super().__init__(dim, nlist, metric, "f32", kmeans_iters=kmeans_iters,
                         refine_k_factor=refine_k_factor, scan_bf16=scan_bf16,
                         device=_index_device(mesh, device))
        self.refine_store = None
        self.raw_lists: Optional[ShardedPaddedLists] = None
        self.mesh = mesh or make_mesh(device=self.device)
        self.device = self.mesh.root
        self.probe_routing = bool(probe_routing)
        self._routed_slack = 2.0
        self.routed_relaunches = 0
        self.launches = 0
        self.shard_launches = np.zeros(self.mesh.size, np.int64)

    def _train_centroids(self, x) -> None:
        self.centroids = sharded_kmeans(self.mesh, x, self.nlist, iters=self.kmeans_iters)

    def _make_lists(self) -> ShardedPaddedLists:
        if self.metric == "l2":
            self.norm_lists = ShardedPaddedLists(self.nlist, (), torch.float32, self.mesh)
        if self.refine_k_factor:
            self.raw_lists = ShardedPaddedLists(self.nlist, (self.dim,), torch.float16,
                                                self.mesh)
        return ShardedPaddedLists(self.nlist, (self.dim,), torch.float32, self.mesh)

    def _append_extra(self, x, assign, gids, rows) -> None:
        if self.norm_lists is not None:
            self.norm_lists.append(assign, self._row_norms(rows), gids)
        if self.raw_lists is not None:
            self.raw_lists.append(assign, ivfmod.clip_f16(x), gids)

    def search(self, q: np.ndarray, k: int):
        if self._n == 0:
            return self._empty_results(q.shape[0], k)
        nprobe, nb, g = self._score_plan()
        norms = self._scan_norms()
        raw = _refine_data(self)
        adc_k = k * self.refine_k_factor if raw is not None else 0

        if self.probe_routing:
            # the JAX package's pair group: a (group, cap, d) fp32 block <= 64 MB
            group = max(8, min(1024, (64 << 20) // max(1, self.lists.cap * self.dim * 4)))

            def body(bucket):
                return lambda qb, nq_real: _sharded_ivf_flat_search_routed(
                    self.mesh, self.centroids, self.lists, qb, nq_real, k, nprobe, bucket, group,
                    self.metric, list_norms=norms, scan_bf16=self.scan_bf16, adc_k=adc_k,
                    raw_data=raw, shard_launches=self.shard_launches)

            call = _routed_call(self, "sharded_ivf_flat",
                                (k, nprobe, group, self.metric, self.scan_bf16, adc_k),
                                _list_reads(self.lists, self.centroids, norms, raw), body)
            return _routed_search_blocks(self, q, k, nprobe, group, call, local_k=adc_k or k)

        def run_fused(q3):
            return _sharded_ivf_flat_search_fused(
                self.mesh, self.centroids, self.lists, q3, k, nprobe, g, self.metric,
                list_norms=norms, scan_bf16=self.scan_bf16, adc_k=adc_k, raw_data=raw,
                shard_launches=self.shard_launches)

        programs = _programs(self, "sharded_ivf_flat",
                             (k, nprobe, g, self.metric, self.scan_bf16, adc_k),
                             _list_reads(self.lists, self.centroids, norms, raw))
        return _counted_search(self, q, k, base.per_block(run_fused), nb, fused_fn=run_fused,
                               programs=programs)

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = super().state_dict()
        state["kind"] = "sharded_ivf_flat"
        state["probe_routing"] = self.probe_routing
        if self.raw_lists is not None and self._n:
            state["refine_rows"] = _refine_rows_state(self)
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "ShardedIVFFlatIndex":
        idx = cls(int(state["dim"]), int(state["nlist"]), str(state["metric"]),
                  probe_routing=bool(state.get("probe_routing", False)),
                  refine_k_factor=int(state.get("refine_k_factor", 0)),
                  scan_bf16=bool(state.get("scan_bf16", False)), device=device)
        idx.nprobe = int(state["nprobe"])
        if not bool(state["trained"]):
            return idx
        dev = idx.device
        idx.centroids = torch.as_tensor(np.asarray(state["centroids"], np.float32), device=dev)
        idx.lists = idx._make_lists()
        rows = np.asarray(state["rows"], np.float32)
        assign = np.asarray(state["assign"]).astype(np.int64)
        if rows.shape[0]:
            gids = np.arange(rows.shape[0], dtype=np.int64)
            rows_t = torch.as_tensor(rows, device=dev)
            idx._host_pos = [idx.lists.append(assign, rows_t, gids)]
            idx._host_assign = [assign.astype(np.int32)]
            idx._n = rows.shape[0]
            if idx.norm_lists is not None:
                norms = (torch.as_tensor(np.asarray(state["list_norms"], np.float32), device=dev)
                         if "list_norms" in state else idx._row_norms(rows_t))
                idx.norm_lists.append(assign, norms, gids)
            if idx.raw_lists is not None:
                if "refine_rows" not in state:
                    raise ValueError("sharded IVF-flat state has refine_k_factor set but "
                                     "no refine_rows payload")
                idx.raw_lists.append(assign, np.asarray(state["refine_rows"], np.float16), gids)
        return idx


class ShardedIVFPQIndex(IVFPQIndex):
    """IVF-PQ with mesh-sharded code lists: coarse k-means trains with
    ``psum``, the PQ codebooks are shared, the code lists (and the fp16 raw
    refine rows, laid out alike) are partitioned over the shards. Search
    runs K3 over each shard's lists (ksub 256, m % 8 == 0) or K2 over the
    gathered codes, rescoring each shard's shortlist exactly before the
    merge when refining. The ``knnlm`` builder's ``shard_lists=True``."""

    def __init__(self, dim: int, nlist: int, m: int = 64, nbits: int = 8, metric: str = "l2",
                 mesh: Optional[Mesh] = None, kmeans_iters: int = 10, pq_iters: int = 15,
                 probe_routing: bool = False, use_pallas: bool = False,
                 refine_k_factor: int = 0, adc_lut_bf16: bool = False, device=None):
        super().__init__(dim, nlist, m=m, nbits=nbits, metric=metric,
                         kmeans_iters=kmeans_iters, pq_iters=pq_iters, use_pallas=use_pallas,
                         refine_k_factor=refine_k_factor, adc_lut_bf16=adc_lut_bf16,
                         device=_index_device(mesh, device))
        self.refine_store = None
        self.raw_lists: Optional[ShardedPaddedLists] = None
        self.mesh = mesh or make_mesh(device=self.device)
        self.device = self.mesh.root
        self.probe_routing = bool(probe_routing)
        self._routed_slack = 2.0
        self.routed_relaunches = 0
        self.launches = 0
        self.shard_launches = np.zeros(self.mesh.size, np.int64)

    def _train_centroids(self, x) -> None:
        self.centroids = sharded_kmeans(self.mesh, x, self.nlist, iters=self.kmeans_iters)

    def _make_lists(self) -> ShardedPaddedLists:
        if self.refine_k_factor:
            self.raw_lists = ShardedPaddedLists(self.nlist, (self.dim,), torch.float16,
                                                self.mesh)
        return ShardedPaddedLists(self.nlist, (self.m,), torch.uint8, self.mesh)

    def _append_extra(self, x, assign, gids, rows) -> None:
        if self.raw_lists is not None:
            self.raw_lists.append(assign, ivfmod.clip_f16(x), gids)

    def search(self, q: np.ndarray, k: int):
        if self._n == 0:
            return self._empty_results(q.shape[0], k)
        nprobe, nb, g = self._search_plan()
        raw = _refine_data(self)
        adc_k = k * self.refine_k_factor if raw is not None else 0

        if self.probe_routing:
            # the JAX package's pair group: codes and transients bounded
            group = max(8, min(512, (32 << 20) // max(1, self.lists.cap * self.m)))

            def body(bucket):
                return lambda qb, nq_real: _sharded_ivf_pq_search_routed(
                    self.mesh, self.centroids, self.codebooks, self.lists, qb, nq_real, k,
                    nprobe, bucket, group, self.metric, lut_bf16=self.lut_bf16, adc_k=adc_k,
                    raw_data=raw, shard_launches=self.shard_launches)

            call = _routed_call(self, "sharded_ivf_pq",
                                (k, nprobe, group, self.metric, self.lut_bf16, adc_k),
                                _list_reads(self.lists, self.centroids, self.codebooks, raw), body)
            return _routed_search_blocks(self, q, k, nprobe, group, call, local_k=adc_k or k)

        def run_fused(q3):
            return _sharded_ivf_pq_search_fused(
                self.mesh, self.centroids, self.codebooks, self.lists, q3, k, nprobe, g,
                self.metric, lut_bf16=self.lut_bf16, adc_k=adc_k, raw_data=raw,
                shard_launches=self.shard_launches)

        programs = _programs(self, "sharded_ivf_pq",
                             (k, nprobe, g, self.metric, self.lut_bf16, adc_k),
                             _list_reads(self.lists, self.centroids, self.codebooks, raw))
        return _counted_search(self, q, k, base.per_block(run_fused), nb, fused_fn=run_fused,
                               programs=programs)

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = super().state_dict()
        state["kind"] = "sharded_ivf_pq"
        state["probe_routing"] = self.probe_routing
        if self.raw_lists is not None and self._n:
            state["refine_rows"] = _refine_rows_state(self)
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "ShardedIVFPQIndex":
        idx = cls(int(state["dim"]), int(state["nlist"]), m=int(state["m"]),
                  nbits=int(state["nbits"]), metric=str(state["metric"]),
                  probe_routing=bool(state.get("probe_routing", False)),
                  use_pallas=bool(state.get("use_pallas", False)),
                  refine_k_factor=int(state.get("refine_k_factor", 0)),
                  adc_lut_bf16=bool(state.get("adc_lut_bf16", False)), device=device)
        idx.nprobe = int(state["nprobe"])
        if not bool(state["trained"]):
            return idx
        dev = idx.device
        idx.centroids = torch.as_tensor(np.asarray(state["centroids"], np.float32), device=dev)
        idx.codebooks = torch.as_tensor(np.asarray(state["codebooks"], np.float32), device=dev)
        idx.lists = idx._make_lists()
        rows = np.asarray(state["rows"], np.uint8)
        assign = np.asarray(state["assign"]).astype(np.int64)
        if rows.shape[0]:
            gids = np.arange(rows.shape[0], dtype=np.int64)
            idx._host_pos = [idx.lists.append(assign, torch.as_tensor(rows, device=dev), gids)]
            idx._host_assign = [assign.astype(np.int32)]
            idx._n = rows.shape[0]
            if idx.raw_lists is not None:
                if "refine_rows" not in state:
                    raise ValueError("sharded IVF-PQ state has refine_k_factor set but no "
                                     "refine_rows payload")
                idx.raw_lists.append(assign, np.asarray(state["refine_rows"], np.float16), gids)
        return idx
