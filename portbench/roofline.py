"""The least time a scan kernel could take over the requests it served, from
the bytes the work needs (``chip_smoke.py``'s ``k1_bound`` and
``lists_bound``, counted over the work and not over one launch's inputs).

A request's probed lists come from the benchmark's own coarse top-nprobe
over its queries, against the centroids of the served index's snapshot,
and each list's live rows from its assignment vector. Per request:

- each distinct probed list is read once, at its live rows;
- the queries (and, for K3, every (query, probe) pair's LUT) once;
- the probe indices and their fill counts once;
- the scores at 4 bytes a live scored row (a (query, probe, row) triple),
  not at the padded capacity.

A PR that shares list reads across requests reads less than this count,
and the share can then pass 100%: that is a change of the count's terms,
for a benchmark PR.
"""

import numpy as np
import torch

# one NVIDIA H100 SXM: HBM bytes/s and fp32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def probed_lists(centroids: torch.Tensor, q: torch.Tensor, nprobe: int) -> torch.Tensor:
    """(nq, nprobe) ids of each query's nearest centroids by squared L2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c = centroids.float()
    d = (c * c).sum(1)[None, :] - 2.0 * (q.float() @ c.T)
    return torch.topk(d, nprobe, dim=1, largest=False).indices


def request_work(probes: torch.Tensor, list_sizes: torch.Tensor) -> tuple:
    """(live rows of the distinct probed lists, live (query, probe, row)
    triples) of one request's (nq, nprobe) probes."""
    distinct = torch.unique(probes)
    return int(list_sizes[distinct].sum()), int(list_sizes[probes].sum())


def k1_request_bytes(nq: int, d: int, nprobe: int, row_bytes: int, unique_live: int,
                     pair_live: int) -> int:
    """K1 (flat or fp16 lists with stored norms): a live row is its payload,
    its id and its norm (``row_bytes``)."""
    return unique_live * row_bytes + nq * d * 4 + 2 * nq * nprobe * 4 + pair_live * 4


def k3_request_bytes(nq: int, nprobe: int, m: int, ksub: int, lut_itemsize: int,
                     unique_live: int, pair_live: int) -> int:
    """K3 (PQ codes over the probed lists): every pair's (m, ksub) LUT, a
    live row's m code bytes and its id."""
    return (nq * nprobe * m * ksub * lut_itemsize + unique_live * (m + 4)
            + 2 * nq * nprobe * 4 + pair_live * 4)


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def mean_request_least_s(kernel: str, centroids: np.ndarray, list_sizes: np.ndarray,
                         requests: list, nprobe: int, layout: dict, device) -> float:
    """The mean least time of one request's ``kernel`` work over
    ``requests`` (each an (nq, d) query array)."""
    c = torch.as_tensor(centroids, device=device)
    sizes = torch.as_tensor(np.asarray(list_sizes, np.int64), device=device)
    total = 0.0
    for qr in requests:
        q = torch.as_tensor(qr, device=device)
        nq, d = q.shape
        unique_live, pair_live = request_work(probed_lists(c, q, nprobe), sizes)
        if kernel == "K1":
            nbytes = k1_request_bytes(nq, d, nprobe, layout["row_bytes"], unique_live,
                                      pair_live)
            flops = pair_live * 2 * d
        elif kernel == "K3":
            nbytes = k3_request_bytes(nq, nprobe, layout["m"], layout["ksub"],
                                      layout["lut_itemsize"], unique_live, pair_live)
            flops = pair_live * layout["m"]
        else:
            raise ValueError(f"no byte count for kernel {kernel!r}")
        total += least_seconds(nbytes, flops)
    return total / len(requests)
