"""The plain reference that decides ``correct``: exact k-nearest neighbours
by squared L2 over the benchmark's own rows, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
rows and queries are the benchmark's, and what it reads of the program's
answers (ids and distances) it reads only to judge them.

Numbers a run compares (``compare``), each against its own limit:

- ``bad_rows``: sampled answer rows that are not k distinct ids of stored
  rows with finite, non-decreasing distances (limit 0);
- ``recall10``: the share of the reference's top-k among the served ids
  (limit: the traffic mix's recall bar, which the operating point states);
- ``dist_gap``: the widest gap between a served distance and the exact
  distance of the served id, as a share of the query's exact k-th
  distance (limit: the cell's, set from the program's readings and the
  control's, see ``control.py``).
"""

import numpy as np
import torch

# reference rows scored at once against the query sample
BLOCK_ROWS = 1 << 18


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_topk(x: torch.Tensor, q: torch.Tensor, k: int):
    """(distances (nq, k) float32, ids (nq, k) int64) of the exact top-k
    by squared L2, in fp32 with TF32 off, in blocks of rows."""
    _no_tf32()
    q = q.float()
    qn = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, x.shape[0], BLOCK_ROWS):
        xb = x[s:s + BLOCK_ROWS].float()
        d = qn - 2.0 * (q @ xb.T) + (xb * xb).sum(1)[None, :]
        kk = min(k, d.shape[1])
        bd, bi = torch.topk(d, kk, dim=1, largest=False)
        cat_d = torch.cat([best_d, bd], 1)
        cat_i = torch.cat([best_i, bi + s], 1)
        sel = torch.topk(cat_d, k, dim=1, largest=False).indices
        best_d, best_i = cat_d.gather(1, sel), cat_i.gather(1, sel)
    return best_d, best_i


def true_dists(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 squared L2 from each query to the rows ``ids`` (nq, k), taken
    as differences (no expansion); +inf where an id is not a stored row."""
    valid = (ids >= 0) & (ids < x.shape[0])
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    diff = x[safe].double() - q.double()[:, None, :]
    d = (diff * diff).sum(2)
    return torch.where(valid, d, torch.full_like(d, float("inf")))


def bad_rows(served_d: np.ndarray, served_ids: np.ndarray, n_rows: int) -> np.ndarray:
    """(nq,) bool: rows that are not k distinct stored ids with finite,
    non-decreasing distances."""
    ids = np.asarray(served_ids, np.int64)
    d = np.asarray(served_d, np.float64)
    out = ((ids < 0) | (ids >= n_rows)).any(1) | ~np.isfinite(d).all(1)
    srt = np.sort(ids, axis=1)
    out |= (srt[:, 1:] == srt[:, :-1]).any(1)
    with np.errstate(invalid="ignore"):
        out |= (np.diff(d, axis=1) < 0).any(1)
    return out


def compare(x: torch.Tensor, q: torch.Tensor, served_d: np.ndarray,
            served_ids: np.ndarray) -> dict:
    """The numbers ``correct`` is decided on, for one sample of served
    answers to the queries ``q`` (rows of the device tensor ``x``)."""
    k = served_ids.shape[1]
    bad = bad_rows(served_d, served_ids, x.shape[0])
    _, gt = exact_topk(x, q, k)
    gt = gt.cpu().numpy()
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(served_ids, gt))
    ids_t = torch.as_tensor(np.asarray(served_ids, np.int64), device=x.device)
    exact = true_dists(x, q, ids_t).cpu().numpy()
    kth = true_dists(x, q, torch.as_tensor(gt[:, -1:], device=x.device)).cpu().numpy()
    ok = ~bad
    gap = np.abs(np.asarray(served_d, np.float64) - exact) / kth
    return {"bad_rows": int(bad.sum()),
            "recall10": hits / float(gt.size),
            "dist_gap": float(gap[ok].max()) if ok.any() else float("inf")}


def sq8(x: torch.Tensor) -> torch.Tensor:
    """The rows through a per-dimension 8-bit scalar quantizer over their
    own range, decoded back to float32."""
    vmin = x.min(0).values
    span = (x.max(0).values - vmin).clamp(min=1e-12)
    codes = torch.round((x - vmin) / span * 255.0).clamp(0, 255)
    return vmin + codes * (span / 255.0)


def control_answers(x: torch.Tensor, q: torch.Tensor, k: int, precision: str):
    """The reference put in the program's place one precision below what
    the configuration serves: (distances, ids) numpy arrays of the exact
    top-k over the rows stored at ``precision``."""
    if precision != "int8":
        raise ValueError(f"no control at precision {precision!r}")
    d, ids = exact_topk(sq8(x), q, k)
    return d.cpu().numpy(), ids.cpu().numpy()


# the precision one step below what a configuration serves
CONTROL_PRECISION = {"float16": "int8", "bfloat16": "int8"}
