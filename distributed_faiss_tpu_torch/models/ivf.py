"""IVF index family: coarse k-means quantizer + padded inverted lists
(counterpart of distributed_faiss_tpu/models/ivf.py: ``_IVFBase``,
``IVFFlatIndex`` and ``IVFPQIndex``; the multi-block fused searches are not
ported).

Search: coarse scores (nq, nlist) -> top-nprobe lists -> a loop over probe
groups; each group's (nq, g, cap) masked score block merges into a running
top-k. IVF-Flat scores a group with ``ops.flat_scan.flat_list_scan``,
IVF-PQ with a per-(query, probe) ADC lookup table and, in the
nibble geometry (ksub 256, m % 8 == 0), ``ops.adc_scan.adc_scan_lists``,
which reads the probed lists itself and applies the size and id mask; in
the other geometry the probed lists' code rows are gathered and scored by
``ops.adc_scan.adc_scan`` (K2), then masked. An IVF-PQ index with one list (flat PQ,
the factory's ``PQ<m>``) takes ``_pq_shared_search`` instead: one LUT per
query and ``ops.adc_scan.adc_scan_shared`` over chunks of the one list that
every query shares, with no per-query copy of the codes; it computes the
function the JAX package computes for a one-list IVF-PQ. On a CUDA device
those blocks always come from the hand-written kernels
(``csrc/flat_scan.cu``, ``csrc/adc_scan.cu``): the ``use_pallas`` knob
(``pallas_flat`` / ``pallas_adc`` in the cfg) is still read, stored in
``state_dict`` and round-tripped so configs and snapshots stay
compatible; for IVF-PQ it still selects the bf16 LUT together with
``adc_lut_bf16``, as in the JAX package, so one cfg computes one function
in both. On the card a kernel
fault raises — the JAX package's first-use oracle and ``pallas_guarded``
demotion ladder are not ported. On the CPU the same wrappers run their
plain PyTorch versions.

The probe grouping (``probe_group_size`` over ``pick_query_block``'s query
block) is the JAX package's, so the top-k merges happen in the same order.

Coarse assignment: argmax inner product for metric=dot, argmin L2
otherwise (reference get_quantizer). PQ encoding is residual for l2 (FAISS
IVFPQ by_residual) and raw for dot. Host state is the id -> (list,
within-list position) map only; the payload lives in the device lists and
persistence gathers it back through that map.
"""

import logging
from typing import Dict, Optional

import numpy as np
import torch

from distributed_faiss_tpu_torch.models import base
from distributed_faiss_tpu_torch.ops import adc_scan, distance, flat_scan, kmeans, pq, sq
from distributed_faiss_tpu_torch.utils import sanitize

logger = logging.getLogger()


def _coarse_assign(centroids: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    return torch.argmax(distance.pairwise_scores(x, centroids, metric), dim=1)


def exact_candidate_scores(q: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    """Exact (nq, R) bigger-is-better scores of gathered candidate rows:
    dot = ip, l2 = -(qn - 2 ip + rn), fp32."""
    q = q.float()
    rows = rows.float()
    ip = torch.einsum("qd,qrd->qr", q, rows)
    if metric == "dot":
        return ip
    qn = (q * q).sum(1, keepdim=True)
    rn = (rows * rows).sum(2)
    return -(qn - 2.0 * ip + rn)


def _rerank_exact(store: torch.Tensor, q: torch.Tensor, cand_ids: torch.Tensor,
                  k: int, metric: str):
    """Exact refine of a shortlist: gather the fp16 raw rows of the (nq, R)
    candidates (-1 padding), rescore in fp32, return the top-k subset."""
    cand = cand_ids.long()
    safe = torch.where(cand >= 0, cand, torch.zeros_like(cand))
    s = exact_candidate_scores(q, store[safe], metric)
    s = torch.where(cand >= 0, s, torch.full_like(s, distance.NEG_INF))
    best, pos = torch.topk(s, k, dim=1)
    return best, torch.gather(cand_ids, 1, pos)


# the JAX package's group budget: probe grouping bounds the gathered block
# a non-kernel scan would materialize
_GROUP_BYTE_BUDGET = 128 * 1024 * 1024


def probe_group_size(nprobe: int, per_probe_bytes: int) -> int:
    """Largest divisor of nprobe whose group payload fits the byte budget."""
    g = max(1, min(nprobe, _GROUP_BYTE_BUDGET // max(1, per_probe_bytes)))
    while nprobe % g:
        g -= 1
    return g


def pq_probe_payload_bytes(cap: int, m: int, ksub: int = 256, nq_block: int = 256) -> int:
    """Per-probed-list payload for the ADC group sizing (the JAX package's
    formula): gathered codes + ids for an ``nq_block``-query block plus the
    per-probe LUT block."""
    return nq_block * cap * (m + 8) + nq_block * m * ksub * 4


def _merge_group(carry, s: torch.Tensor, li: torch.Tensor, list_ids: torch.Tensor,
                 k: int):
    """Merge one group's (nq, g, cap) scores into the running (nq, k) top-k.

    The JAX package gathers the whole (nq, g, cap) ids block and selects
    from it; here only the ids of the selected positions are gathered from
    the list layout (same ids: position p of the flattened group is slot
    p % cap of list li[:, p // cap])."""
    nq, g, cap = s.shape
    cv, pos = distance.segmented_argtopk(s.reshape(nq, g * cap), k)
    safe = torch.where(pos >= 0, pos, torch.zeros_like(pos))
    lists = torch.gather(li.long(), 1, safe // cap)
    cids = list_ids[lists, safe % cap]
    cids = torch.where(pos >= 0, cids, torch.full_like(cids, -1))
    return distance.merge_topk(carry[0], carry[1], cv, cids, k)


def _probe_groups(centroids, q: torch.Tensor, nprobe: int, g: int,
                  metric: str) -> torch.Tensor:
    """(nprobe // g, nq, g) int32: the top-nprobe lists of each query of a
    block, in the groups of g a search scans them in."""
    coarse = distance.pairwise_scores(q, centroids, metric)
    _, probes = distance.segmented_argtopk(coarse, nprobe)  # (nq, nprobe)
    nq = q.shape[0]
    return probes.to(torch.int32).reshape(nq, nprobe // g, g).permute(1, 0, 2)


def _pq_group_lut(centroids, codebooks, q: torch.Tensor, li: torch.Tensor, metric: str,
                  lut_bf16: bool, shared_lut=None) -> torch.Tensor:
    """The ADC scan's (nq*g, m, ksub) LUT for one probe group ``li`` (nq,
    g), one per (query, probe) pair (l2: of the query's residual to the
    probed centroid; dot: the query's own, ``shared_lut`` when given,
    repeated over its probes), cast to bf16 with ``lut_bf16``."""
    nq, g = li.shape
    m, ksub, _ = codebooks.shape
    if metric == "l2":
        r = q[:, None, :] - centroids[li.long()]  # (nq, g, d) residuals
        lut = pq.adc_lut(r.reshape(nq * g, -1), codebooks, metric="l2")
    else:
        if shared_lut is None:
            shared_lut = pq.adc_lut(q, codebooks, metric=metric)  # (nq, m, ksub)
        lut = shared_lut[:, None].expand(nq, g, m, ksub).reshape(nq * g, m, ksub)
    return lut.to(torch.bfloat16 if lut_bf16 else torch.float32).contiguous()


def _pq_group_inputs(centroids, codebooks, list_codes, q: torch.Tensor, li: torch.Tensor,
                     metric: str, lut_bf16: bool, shared_lut=None):
    """K2's inputs for one probe group ``li`` (nq, g): ``_pq_group_lut``'s
    LUT and the probed lists' (nq*g, cap, m) code rows, gathered."""
    nq, g = li.shape
    lut = _pq_group_lut(centroids, codebooks, q, li, metric, lut_bf16, shared_lut)
    codes = list_codes[li.long()].reshape(nq * g, list_codes.shape[1], list_codes.shape[2])
    return lut, codes


def shared_chunk_rows(nb: int) -> int:
    """Rows of the shared list one K4 launch scores for an ``nb``-query
    block: its (nb, rows) fp32 score block fits the query block's payload
    budget (262,144 rows at nb = 256)."""
    return max(1, base._QUERY_PAYLOAD_BUDGET // (4 * nb))


def _pq_shared_inputs(centroids, codebooks, list_codes, size: int, q: torch.Tensor,
                      metric: str, lut_bf16: bool):
    """The shared ADC scan's inputs for a query block of a one-list index:
    its (nq, m, ksub) LUT (l2: of the query's residual to the one centroid;
    dot: the query's own), cast to bf16 with ``lut_bf16``; and the list's
    ``size`` live (size, m) code rows, a view of the list."""
    r = q - centroids[0] if metric == "l2" else q
    lut = pq.adc_lut(r, codebooks, metric=metric)
    lut = lut.to(torch.bfloat16 if lut_bf16 else torch.float32).contiguous()
    return lut, list_codes[0, :size]


def _pq_shared_search(centroids, codebooks, list_codes, list_ids, size: int, q, k: int,
                      chunk: int, metric: str, lut_bf16: bool = False):
    """Flat-PQ scan of one query block -> (scores, ids int32): K4 over the
    live rows of the one list in chunks of ``chunk`` rows, each chunk's
    top-k (rows with id < 0 masked) merged into the running top-k."""
    q = q.float()
    nq = q.shape[0]
    lut, codes = _pq_shared_inputs(centroids, codebooks, list_codes, size, q, metric,
                                   lut_bf16)
    ids0 = list_ids[0]
    carry = (torch.full((nq, k), distance.NEG_INF, dtype=torch.float32, device=q.device),
             torch.full((nq, k), -1, dtype=torch.int32, device=q.device))
    for s in range(0, size, chunk):
        e = min(size, s + chunk)
        sc = adc_scan.adc_scan_shared(lut, codes[s:e])
        chunk_ids = ids0[s:e]
        sc.masked_fill_((chunk_ids < 0)[None, :], distance.NEG_INF)
        cv, pos = distance.segmented_argtopk(sc, k)
        safe = torch.where(pos >= 0, pos, torch.zeros_like(pos))
        cids = chunk_ids[safe]
        cids = torch.where(pos >= 0, cids, torch.full_like(cids, -1))
        carry = distance.merge_topk(carry[0], carry[1], cv, cids, k)
    return carry


def _ivf_flat_search(centroids, list_data, list_ids, list_sizes, q, k: int,
                     nprobe: int, g: int, metric: str, codec: str, vmin=None,
                     span=None, list_norms=None, scan_bf16: bool = False):
    """IVF-Flat/SQ8 probe scan of one query block -> (scores, ids int32)."""
    q = q.float()
    nq = q.shape[0]
    carry = (torch.full((nq, k), distance.NEG_INF, dtype=torch.float32, device=q.device),
             torch.full((nq, k), -1, dtype=torch.int32, device=q.device))
    for li in _probe_groups(centroids, q, nprobe, g, metric):
        li = li.contiguous()
        sizes = list_sizes[li.long()].contiguous()
        s = flat_scan.flat_list_scan(q, list_data, list_ids, li, sizes, list_norms,
                                     vmin, span, metric=metric, codec=codec,
                                     scan_bf16=scan_bf16)
        carry = _merge_group(carry, s, li, list_ids, k)
    return carry


def _ivf_pq_search(centroids, codebooks, list_codes, list_ids, list_sizes, q, k: int,
                   nprobe: int, g: int, metric: str, lut_bf16: bool = False):
    """IVF-PQ probe scan of one query block -> (scores, ids int32).

    Per probe group each (query, probe) pair gets its LUT (l2: of the
    query's residual to the probed centroid; dot: the query's own LUT,
    shared by its probes), cast to bf16 with ``lut_bf16``. In the nibble
    geometry ``adc_scan_lists`` (K3) scores the probed lists in place and
    masks pos >= size and id < 0; otherwise the probed lists' code rows
    are gathered, ``adc_scan`` (K2) scores them and the mask is applied
    here, as in the JAX package."""
    q = q.float()
    nq = q.shape[0]
    cap = list_codes.shape[1]
    m, ksub, _ = codebooks.shape
    fused = adc_scan.nibble_supported(m, ksub)
    shared_lut = None if metric == "l2" else pq.adc_lut(q, codebooks, metric=metric)
    carry = (torch.full((nq, k), distance.NEG_INF, dtype=torch.float32, device=q.device),
             torch.full((nq, k), -1, dtype=torch.int32, device=q.device))
    for li in _probe_groups(centroids, q, nprobe, g, metric):
        li = li.contiguous()
        sizes = list_sizes[li.long()].contiguous()
        if fused:
            lut = _pq_group_lut(centroids, codebooks, q, li, metric, lut_bf16, shared_lut)
            s = adc_scan.adc_scan_lists(lut, list_codes, li, sizes, list_ids)
        else:
            lut, codes = _pq_group_inputs(centroids, codebooks, list_codes, q, li, metric,
                                          lut_bf16, shared_lut)
            s = adc_scan.mask_lists(adc_scan.adc_scan(lut, codes).reshape(nq, g, cap), li,
                                    sizes, list_ids)
        carry = _merge_group(carry, s, li, list_ids, k)
    return carry


class _IVFBase(base.TorchIndex):
    """Shared coarse-quantizer + list bookkeeping for IVF variants."""

    def __init__(self, dim: int, nlist: int, metric: str, kmeans_iters: int = 10,
                 device="cuda"):
        super().__init__(dim, metric, device)
        if nlist < 1:
            raise ValueError("nlist must be >= 1")
        self.nlist = nlist
        self.kmeans_iters = kmeans_iters
        self.centroids: Optional[torch.Tensor] = None  # (nlist, d)
        self.lists: Optional[base.PaddedLists] = None
        # id -> (list, within-list position): the only per-row host state
        self._host_assign = []  # np int32 chunks, list idx in id order
        self._host_pos = []  # np int32 chunks, within-list slot in id order
        self._n = 0

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    @property
    def ntotal(self) -> int:
        return self._n

    def get_centroids(self) -> Optional[np.ndarray]:
        return None if self.centroids is None else base.to_numpy(self.centroids)

    def get_assignments(self) -> np.ndarray:
        return self._host_assign_array()

    def _assign(self, x: torch.Tensor) -> torch.Tensor:
        # bound the (chunk, nlist) fp32 score block
        chunk = kmeans.auto_chunk(self.nlist)
        return torch.cat([_coarse_assign(self.centroids, x[s:s + chunk], self.metric)
                          for s in range(0, x.shape[0], chunk)])

    def _train_centroids(self, x: torch.Tensor) -> None:
        self.centroids = kmeans.kmeans(x, self.nlist, iters=self.kmeans_iters)

    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError("IVF index must be trained before add")
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        if xt.shape[0] == 0:
            return
        assign_t = self._assign(xt)
        assign = assign_t.cpu().numpy()
        rows = self._encode(xt, assign_t)
        gids = np.arange(self._n, self._n + xt.shape[0], dtype=np.int64)
        pos = self.lists.append(assign, rows, gids)
        self._append_extra(xt, assign, gids, rows)
        self._host_assign.append(assign.astype(np.int32))
        self._host_pos.append(pos)
        self._n += xt.shape[0]

    def _host_assign_array(self) -> np.ndarray:
        if len(self._host_assign) > 1:
            self._host_assign = [np.concatenate(self._host_assign)]
        return self._host_assign[0] if self._host_assign else np.zeros((0,), np.int32)

    def _host_pos_array(self) -> np.ndarray:
        if len(self._host_pos) > 1:
            self._host_pos = [np.concatenate(self._host_pos)]
        return self._host_pos[0] if self._host_pos else np.zeros((0,), np.int32)

    def remove_rows(self, rows: np.ndarray) -> None:
        """Tombstone rows out of the inverted lists: -1 into the ids plane
        at each row's (slot, pos) cell, from the host map. K1 and K3 mask
        id < 0 inside the kernel, K2's and K4's paths right after it, so a
        dead cell is padding to every scan; this covers flat ``PQ<m>`` (one
        list) too."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0 or self.lists is None:
            return
        if rows.min() < 0 or rows.max() >= self._n:
            raise IndexError(f"row out of range [0, {self._n})")
        assign = self._host_assign_array()[rows].astype(np.int64)
        pos = self._host_pos_array()[rows].astype(np.int64)
        self.lists.mask_cells(self.lists.slot_of(assign) * self.lists.cap + pos)

    def _rows_in_insertion_order(self, chunk: int = 1 << 20, lists=None) -> np.ndarray:
        """Stream the stored payload back from the device in id order
        (persistence); ``lists`` selects a sidecar with the payload lists'
        layout (the stored norms)."""
        lists = lists if lists is not None else self.lists
        assign, pos = self._host_assign_array(), self._host_pos_array()
        parts = [base.gather_list_rows(lists, assign[s:s + chunk], pos[s:s + chunk])
                 for s in range(0, self._n, chunk)]
        if not parts:
            return base.gather_list_rows(lists, assign[:0], pos[:0])
        return np.concatenate(parts)

    def _empty_results(self, nq: int, k: int):
        d = np.full((nq, k), np.inf if self.metric == "l2" else -np.inf, np.float32)
        return d, np.full((nq, k), -1, np.int64)

    # subclass hooks
    def _encode(self, x: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _append_extra(self, x, assign, gids, rows) -> None:
        """Hook: side-car payloads (raw rows for exact refine, stored norms)."""


def clip_f16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp16 with clipping: an out-of-range component would store inf
    and poison that row's refined score forever."""
    f16max = float(torch.finfo(torch.float16).max)
    return torch.clamp(x.float(), -f16max, f16max).to(torch.float16)


class IVFFlatIndex(_IVFBase):
    """IVF with raw/fp16/sq8 vector payloads.

    codec 'f32' == ``ivf_simple`` (IndexIVFFlat); 'f16' == ``ivfsq``
    (IndexIVFScalarQuantizer QT_fp16); 'sq8' == factory "IVF<n>,SQ8".
    """

    def __init__(self, dim: int, nlist: int, metric: str = "l2", codec: str = "f32",
                 kmeans_iters: int = 10, refine_k_factor: int = 0,
                 use_pallas: bool = False, scan_bf16: bool = False, device="cuda"):
        super().__init__(dim, nlist, metric, kmeans_iters, device)
        if codec not in flat_scan.CODECS:
            raise ValueError(f"unknown ivf_flat codec {codec!r}")
        self.codec = codec
        self._dtype = flat_scan.CODECS[codec][1]  # the lists' storage dtype
        self.sq_params = None
        # exact fp16 rerank of the top k * refine_k_factor: meaningful for
        # the sq8 codec and under scan_bf16; otherwise the stored lists are
        # already as precise as the refine store (the JAX package's rule)
        if refine_k_factor and codec != "sq8" and not scan_bf16:
            logger.warning("refine_k_factor on the %s codec adds no precision over "
                           "the stored lists; disabled", codec)
            refine_k_factor = 0
        if scan_bf16 and not refine_k_factor:
            raise ValueError(
                "scan_bf16 perturbs scan scores (bf16 products) and is only "
                "legal with refine_k_factor > 0 so the shortlist is rescored exactly")
        self.refine_k_factor = int(refine_k_factor)
        self.refine_store = (base.DeviceVectorStore((dim,), torch.float16, self.device)
                             if self.refine_k_factor else None)
        # accepted and persisted for compatibility; the CUDA scan is always
        # the hand kernel (module docstring)
        self.use_pallas = bool(use_pallas)
        self.scan_bf16 = bool(scan_bf16)
        # stored-norms scan is the default; False recomputes ||x||^2 in the scan
        self.use_stored_norms = True
        self.norm_lists: Optional[base.PaddedLists] = None  # (nlist, cap) fp32

    def _make_lists(self) -> base.PaddedLists:
        # exact fp32 ||x||^2 per stored row, appended in lockstep with the
        # payload (same assign/gids stream -> same layout and growth); only
        # l2 reads norms, so a dot index keeps no sidecar
        if self.metric == "l2":
            self.norm_lists = base.PaddedLists(self.nlist, (), torch.float32, self.device)
        return base.PaddedLists(self.nlist, (self.dim,), self._dtype,
                                self.device)

    def train(self, x: np.ndarray) -> None:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self._train_centroids(xt)
        if self.codec == "sq8":
            self.sq_params = sq.sq8_train(xt)
        self.lists = self._make_lists()

    def _encode(self, x: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
        if self.codec == "sq8":
            return sq.sq8_encode(x, self.sq_params["vmin"], self.sq_params["span"])
        return x.to(self._dtype)

    def _decode(self, rows: torch.Tensor) -> torch.Tensor:
        if self.codec == "sq8":
            return sq.sq8_decode(rows, self.sq_params["vmin"], self.sq_params["span"])
        return rows.float()

    def _row_norms(self, rows: torch.Tensor, chunk: int = 1 << 20) -> torch.Tensor:
        """Exact fp32 ||x||^2 of ENCODED rows after decode (the scan's
        recompute formula), chunked to bound the decode transient."""
        return torch.cat([base.row_norms_f32(self._decode(rows[s:s + chunk]))
                          for s in range(0, rows.shape[0], chunk)])

    def _append_extra(self, x, assign, gids, rows) -> None:
        if self.refine_store is not None:
            self.refine_store.add(clip_f16(x))
        if self.norm_lists is not None:
            self.norm_lists.append(assign, self._row_norms(rows), gids)

    def _scan_norms(self):
        if not (self.use_stored_norms and self.norm_lists is not None):
            return None
        if self.norm_lists.cap != self.lists.cap:
            raise RuntimeError(
                f"norm/payload list capacities diverged "
                f"({self.norm_lists.cap} != {self.lists.cap})")
        return self.norm_lists.data

    def _search_plan(self):
        """(nprobe, query block, probe group size) of a search."""
        nprobe = min(self.nprobe, self.nlist)
        nb = base.pick_query_block(self.lists.cap * self.dim * 4)
        return nprobe, nb, probe_group_size(nprobe, nb * self.lists.cap * self.dim * 4)

    def _scan_options(self) -> dict:
        """``flat_list_scan``'s inputs that come from the index: stored
        norms, the SQ8 decode parameters, the bf16 scan."""
        opts = dict(list_norms=self._scan_norms(), scan_bf16=self.scan_bf16)
        if self.codec == "sq8":
            opts.update(vmin=self.sq_params["vmin"], span=self.sq_params["span"])
        return opts

    def search(self, q: np.ndarray, k: int):
        if self._n == 0:
            return self._empty_results(q.shape[0], k)
        nprobe, nb, g = self._search_plan()
        opts = self._scan_options()
        scan_k = k * self.refine_k_factor if self.refine_k_factor else k

        def run(qb):
            # GRAFT_SANITIZE=1: NaN checks on the probe scan (a plain call
            # otherwise)
            vals, ids = sanitize.maybe_checked(
                _ivf_flat_search, self.centroids, self.lists.data, self.lists.ids,
                self.lists.sizes, qb, scan_k, nprobe, g, self.metric, self.codec, **opts)
            if self.refine_k_factor:
                vals, ids = _rerank_exact(self.refine_store.data, qb, ids, k, self.metric)
            return vals, ids

        return base.blocked_search(q, k, self.metric, run, self.device, block=nb)

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        rows = base.gather_list_rows(self.lists, self._host_assign_array()[ids],
                                     self._host_pos_array()[ids])
        return base.to_numpy(self._decode(torch.as_tensor(rows, device=self.device)))

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = {
            "kind": "ivf_flat",
            "dim": self.dim,
            "metric": self.metric,
            "codec": self.codec,
            "nlist": self.nlist,
            "nprobe": self.nprobe,
            "trained": self.is_trained,
            "refine_k_factor": self.refine_k_factor,
            "use_pallas": self.use_pallas,
            "scan_bf16": self.scan_bf16,
        }
        if self.is_trained:
            state["centroids"] = base.to_numpy(self.centroids)
            state["rows"] = self._rows_in_insertion_order()
            state["assign"] = self._host_assign_array()
            if self._n and self.norm_lists is not None:
                state["list_norms"] = self._rows_in_insertion_order(lists=self.norm_lists)
            if self.sq_params is not None:
                state["sq_vmin"] = base.to_numpy(self.sq_params["vmin"])
                state["sq_span"] = base.to_numpy(self.sq_params["span"])
            if self.refine_store is not None:
                state["refine_rows"] = self.refine_store.all_rows()
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "IVFFlatIndex":
        idx = cls(int(state["dim"]), int(state["nlist"]), str(state["metric"]),
                  str(state["codec"]),
                  refine_k_factor=int(state.get("refine_k_factor", 0)),
                  use_pallas=bool(state.get("use_pallas", False)),
                  scan_bf16=bool(state.get("scan_bf16", False)), device=device)
        idx.nprobe = int(state["nprobe"])
        if not bool(state["trained"]):
            return idx
        dev = idx.device
        idx.centroids = torch.as_tensor(np.asarray(state["centroids"], np.float32), device=dev)
        if "sq_vmin" in state:
            idx.sq_params = {
                "vmin": torch.as_tensor(np.asarray(state["sq_vmin"], np.float32), device=dev),
                "span": torch.as_tensor(np.asarray(state["sq_span"], np.float32), device=dev),
            }
        idx.lists = idx._make_lists()
        rows = np.asarray(state["rows"])
        assign = np.asarray(state["assign"]).astype(np.int64)
        if rows.shape[0]:
            gids = np.arange(rows.shape[0], dtype=np.int64)
            rows_t = torch.as_tensor(rows, device=dev)
            pos = idx.lists.append(assign, rows_t, gids)
            idx._host_assign = [assign.astype(np.int32)]
            idx._host_pos = [pos]
            idx._n = rows.shape[0]
            if idx.norm_lists is not None:
                # from the snapshot when present, else backfilled from the
                # decoded rows (the two are bit-identical by construction)
                norms = (torch.as_tensor(np.asarray(state["list_norms"], np.float32),
                                         device=dev)
                         if "list_norms" in state else idx._row_norms(rows_t))
                idx.norm_lists.append(assign, norms, gids)
            if idx.refine_store is not None:
                idx.refine_store.add(np.asarray(state["refine_rows"], np.float16))
        return idx


class IVFPQIndex(_IVFBase):
    """IVF-PQ: inverted lists of m uint8 codes per vector, ADC search.

    Parity target: the reference ``knnlm`` builder (IndexIVFPQ with
    code_size=m, nbits=8). ``refine_k_factor`` > 0 keeps fp16 raw rows and
    rescores the top k * refine_k_factor ADC candidates exactly.
    """

    def __init__(self, dim: int, nlist: int, m: int = 64, nbits: int = 8,
                 metric: str = "l2", kmeans_iters: int = 10, pq_iters: int = 15,
                 use_pallas: bool = False, refine_k_factor: int = 0,
                 adc_lut_bf16: bool = False, device="cuda"):
        super().__init__(dim, nlist, metric, kmeans_iters, device)
        if dim % m != 0:
            raise ValueError(f"dim {dim} not divisible by PQ m={m}")
        if nbits != 8:
            raise ValueError("only 8-bit PQ codes supported (uint8 storage)")
        if int(refine_k_factor) != refine_k_factor or int(refine_k_factor) < 0:
            raise ValueError(
                f"refine_k_factor must be a non-negative int, got {refine_k_factor!r}")
        self.m = m
        self.nbits = nbits
        self.pq_iters = pq_iters
        # accepted and persisted; with adc_lut_bf16 it selects the bf16 LUT
        # (module docstring); the CUDA scan is always the hand kernel
        self.use_pallas = bool(use_pallas)
        self.adc_lut_bf16 = bool(adc_lut_bf16)
        self.refine_k_factor = int(refine_k_factor)
        self.refine_store = (base.DeviceVectorStore((dim,), torch.float16, self.device)
                             if self.refine_k_factor else None)
        self.codebooks: Optional[torch.Tensor] = None  # (m, 256, dsub)

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None and self.codebooks is not None

    def _make_lists(self) -> base.PaddedLists:
        return base.PaddedLists(self.nlist, (self.m,), torch.uint8, self.device)

    def train(self, x: np.ndarray) -> None:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self._train_centroids(xt)
        if self.metric == "l2":
            train_vecs = xt - self.centroids[self._assign(xt)]
        else:
            train_vecs = xt
        self.codebooks = pq.pq_train(train_vecs, self.m, iters=self.pq_iters)
        self.lists = self._make_lists()

    def _encode(self, x: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
        if self.metric == "l2":
            x = x - self.centroids[assign]
        return pq.pq_encode(x, self.codebooks)

    def _append_extra(self, x, assign, gids, rows) -> None:
        if self.refine_store is not None:
            self.refine_store.add(clip_f16(x))

    @property
    def lut_bf16(self) -> bool:
        """The ADC LUT's dtype, chosen as in the JAX package (``ivf.py:1019``)."""
        return self.use_pallas and self.adc_lut_bf16

    def _search_plan(self):
        """(nprobe, query block, probe group size) of a search."""
        nprobe = min(self.nprobe, self.nlist)
        cap = self.lists.cap
        nb = base.pick_query_block(cap * (self.m + 8) + self.m * 256 * 4)
        return nprobe, nb, probe_group_size(nprobe,
                                            pq_probe_payload_bytes(cap, self.m, nq_block=nb))

    def search(self, q: np.ndarray, k: int):
        if self._n == 0:
            return self._empty_results(q.shape[0], k)
        nprobe, nb, g = self._search_plan()
        adc_k = k * self.refine_k_factor if self.refine_k_factor else k

        def run(qb):
            if self.nlist == 1:
                vals, ids = sanitize.maybe_checked(
                    _pq_shared_search, self.centroids, self.codebooks, self.lists.data,
                    self.lists.ids, int(self.lists.sizes_host[0]), qb, adc_k,
                    shared_chunk_rows(nb), self.metric, lut_bf16=self.lut_bf16)
            else:
                vals, ids = sanitize.maybe_checked(
                    _ivf_pq_search, self.centroids, self.codebooks, self.lists.data,
                    self.lists.ids, self.lists.sizes, qb, adc_k, nprobe, g, self.metric,
                    lut_bf16=self.lut_bf16)
            if self.refine_k_factor:
                vals, ids = _rerank_exact(self.refine_store.data, qb, ids, k, self.metric)
            return vals, ids

        return base.blocked_search(q, k, self.metric, run, self.device, block=nb)

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        assign = self._host_assign_array()[ids]
        codes = base.gather_list_rows(self.lists, assign, self._host_pos_array()[ids])
        rec = pq.pq_decode(torch.as_tensor(codes, device=self.device), self.codebooks)
        if self.metric == "l2":
            rec = rec + self.centroids[torch.as_tensor(assign.astype(np.int64),
                                                       device=self.device)]
        return base.to_numpy(rec)

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = {
            "kind": "ivf_pq",
            "dim": self.dim,
            "metric": self.metric,
            "nlist": self.nlist,
            "m": self.m,
            "nbits": self.nbits,
            "nprobe": self.nprobe,
            "trained": self.is_trained,
            "refine_k_factor": self.refine_k_factor,
            "use_pallas": self.use_pallas,
            "adc_lut_bf16": self.adc_lut_bf16,
        }
        if self.is_trained:
            state["centroids"] = base.to_numpy(self.centroids)
            state["codebooks"] = base.to_numpy(self.codebooks)
            state["rows"] = self._rows_in_insertion_order()
            state["assign"] = self._host_assign_array()
            if self.refine_store is not None:
                state["refine_rows"] = self.refine_store.all_rows()
        return state

    @classmethod
    def from_state_dict(cls, state, device="cuda") -> "IVFPQIndex":
        idx = cls(int(state["dim"]), int(state["nlist"]), int(state["m"]),
                  int(state["nbits"]), str(state["metric"]),
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
            pos = idx.lists.append(assign, torch.as_tensor(rows, device=dev),
                                   np.arange(rows.shape[0], dtype=np.int64))
            idx._host_assign = [assign.astype(np.int32)]
            idx._host_pos = [pos]
            idx._n = rows.shape[0]
        if idx.refine_store is not None and "refine_rows" in state:
            idx.refine_store.add(np.asarray(state["refine_rows"], np.float16))
        return idx
