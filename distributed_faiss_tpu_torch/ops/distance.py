"""Batched distances and top-k (counterpart of
distributed_faiss_tpu/ops/distance.py).

Conventions kept from the JAX package:
- scores are **bigger-is-better** inside: inner product for ``dot``,
  negated squared L2 for ``l2``; models convert to FAISS-style distances at
  their boundary;
- a result slot whose score is -inf carries id -1 (pad slots of a short
  result never leak a live id);
- fp32 accumulation whatever the storage dtype. On CUDA the matmuls run in
  full fp32 (``utils.device.resolve_device`` pins TF32 off).

``torch.topk`` replaces ``lax.top_k``. The JAX package breaks ties by the
lower index (``lax.top_k`` is stable); ``torch.topk`` promises no order
among equal values, so parity holds on tie-free data, and the -inf pad
slots are normalised to id -1 explicitly (``merge_topk``) instead of
relying on the order of ties.
"""

import torch

from distributed_faiss_tpu_torch.ops import sq
from distributed_faiss_tpu_torch.utils import sanitize

NEG_INF = float("-inf")

# exact two-stage top-k over wide rows: per-segment top-k, then one narrow
# top-k over the union (every global top-k element lies in its own
# segment's top-k). Same segment as the JAX package, so the two packages
# reduce in the same shape.
_TOPK_SEGMENT = 2048


def row_norms_f32(rows: torch.Tensor) -> torch.Tensor:
    """Exact fp32 ``||row||^2`` over the minor axis — the one norm formula
    shared by add-time norm storage and the scan's recompute path."""
    r = rows.float()
    return (r * r).sum(-1)


def pairwise_scores(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """(nq, d) x (n, d) -> (nq, n) bigger-is-better scores.

    dot: q @ x.T ; l2: -(||q||^2 - 2 q.x + ||x||^2), fp32 throughout."""
    q = q.float()
    x = x.float()
    ip = q @ x.T
    if metric == "dot":
        return ip
    qn = (q * q).sum(1, keepdim=True)
    xn = (x * x).sum(1)
    return -(qn - 2.0 * ip + xn[None, :])


def merge_topk(vals_a, ids_a, vals_b, ids_b, k: int):
    """Merge two (nq, ka)/(nq, kb) bigger-is-better top-k sets into top-k;
    -inf slots come back with id -1."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1)
    best, pos = torch.topk(vals, k, dim=1)
    out = torch.gather(ids, 1, pos)
    return best, torch.where(torch.isneginf(best), torch.full_like(out, -1), out)


def _seg_reduce(s: torch.Tensor, k: int):
    """Exact top-k over rows of (nq, W) scores via the two-stage reduction.

    Returns (vals, pos) with pos indexing the ORIGINAL columns (int64).
    Widths that are not a segment multiple are padded with -inf; a padded
    column can only surface when a row has fewer than k finite entries, and
    its pos is then -1."""
    nq, w = s.shape
    seg = _TOPK_SEGMENT
    kk = min(k, w)
    if w <= 2 * seg or kk > seg:
        return torch.topk(s, kk, dim=1)
    wp = -(-w // seg) * seg
    if wp != w:
        s = torch.nn.functional.pad(s, (0, wp - w), value=NEG_INF)
    g = wp // seg
    sv, sp = torch.topk(s.reshape(nq, g, seg), kk, dim=2)  # (nq, g, kk)
    flat = (torch.arange(g, device=s.device) * seg)[None, :, None] + sp
    cv, cp = torch.topk(sv.reshape(nq, g * kk), kk, dim=1)
    pos = torch.gather(flat.reshape(nq, g * kk), 1, cp)
    return cv, torch.where(pos < w, pos, torch.full_like(pos, -1))


def segmented_argtopk(s: torch.Tensor, k: int):
    """(vals, pos) top-k over rows; pos is -1 only for -inf pad slots."""
    return _seg_reduce(s, k)


def segmented_topk(s: torch.Tensor, k: int, gids: torch.Tensor):
    """Exact top-k of (nq, W) scores; gids: (W,) column ids."""
    cv, pos = _seg_reduce(s, k)
    safe = torch.where(pos >= 0, pos, torch.zeros_like(pos))
    out = gids[safe]
    return cv, torch.where(pos >= 0, out, torch.full_like(out, -1))


def segmented_topk_rows(s: torch.Tensor, k: int, ids: torch.Tensor):
    """segmented_topk for per-row id arrays: s, ids both (nq, W)."""
    cv, pos = _seg_reduce(s, k)
    safe = torch.where(pos >= 0, pos, torch.zeros_like(pos))
    out = torch.gather(ids, 1, safe)
    return cv, torch.where(pos >= 0, out, torch.full_like(out, -1))


def _knn_scan(q, x, ntotal: int, k: int, metric: str, chunk: int,
              codec: str = "raw", vmin=None, span=None, live=None):
    """Chunked corpus scan with a running top-k.

    q: (nq, d); x: (cap, d) with cap % chunk == 0; rows >= ntotal are masked
    to -inf. codec 'raw' (any float dtype, cast to fp32) or 'sq8' (uint8
    codes decoded with per-dim vmin/span). ``live``: the optional (cap,)
    bool tombstone mask (False = deleted), ANDed into each chunk's mask
    before the chunk's top-k, so a deleted row never surfaces even when k
    exceeds the live rows; None (nothing deleted) runs the scan without
    it. Chunks wholly past ``ntotal`` hold only masked rows and are
    skipped: they could only add -inf slots, which the running top-k
    already holds with id -1.
    Returns (scores (nq, k), ids (nq, k) int32) sorted descending."""
    nq = q.shape[0]
    q = q.float()
    qn = (q * q).sum(1, keepdim=True)
    best_v = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    nchunks = min(x.shape[0] // chunk, -(-ntotal // chunk))
    for ci in range(nchunks):
        xc = x[ci * chunk:(ci + 1) * chunk]
        xc = sq.sq8_decode(xc, vmin, span) if codec == "sq8" else xc.float()
        ip = q @ xc.T
        if metric == "dot":
            s = ip
        else:
            xn = (xc * xc).sum(1)
            s = -(qn - 2.0 * ip + xn[None, :])
        gids = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=q.device)
        ok = gids < ntotal
        if live is not None:
            ok = ok & live[ci * chunk:(ci + 1) * chunk]
        s = torch.where(ok[None, :], s, torch.full_like(s, NEG_INF))
        cv, cids = segmented_topk(s, min(k, chunk), gids)
        best_v, best_i = merge_topk(best_v, best_i, cv, cids, k)
    return best_v, best_i


def knn(q, x, k: int, metric: str = "l2", ntotal: int = None, chunk: int = 65536,
        codec: str = "raw", vmin=None, span=None, live=None):
    """Exact k-nearest-neighbour scan of a (possibly capacity-padded) corpus.

    Returns bigger-is-better (scores, ids int32). ``ntotal`` masks padding
    rows and defaults to the full array; ``chunk`` bounds the transient
    (nq, chunk) score block; ``live`` is the optional (cap,) bool
    tombstone mask (False rows are masked like padding)."""
    cap = x.shape[0]
    if ntotal is None:
        ntotal = cap
    chunk = min(chunk, cap)
    if cap % chunk:
        newcap = -(-cap // chunk) * chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, newcap - cap))
        if live is not None:
            live = torch.nn.functional.pad(live, (0, newcap - cap), value=False)
    # GRAFT_SANITIZE=1: NaN checks on the scan's operands and results
    return sanitize.maybe_checked(_knn_scan, q, x, int(ntotal), k, metric, chunk, codec,
                                  vmin, span, live)
