"""Lloyd k-means (counterpart of distributed_faiss_tpu/ops/kmeans.py).

Same structure as the JAX package: the points are padded to a chunk
multiple with zero-weight rows, each Lloyd iteration assigns every chunk by
argmin over a (chunk, k) distance block and accumulates per-cluster sums
and counts, empty clusters keep their previous centroid. fp32 throughout;
on CUDA the distance matmul runs in full fp32 because
``utils.device.resolve_device`` pins TF32 off.

The seeding (k-means++ or uniform without replacement) draws from an
explicit ``torch.Generator`` seeded from ``seed``. Its draws differ from
the JAX package's ``PRNGKey`` draws, so the same seed gives different
initial centroids in the two packages — expected, not a fault; the tests
compare Lloyd steps from a shared initial set instead.
"""

import torch


def accumulate_clusters(x_chunks: torch.Tensor, w_chunks: torch.Tensor,
                        cent: torch.Tensor, k: int):
    """Lloyd assignment + accumulation over pre-chunked points.

    x_chunks: (nchunks, chunk, d); w_chunks: (nchunks, chunk) 0/1 weights.
    Returns (sums (k, d), counts (k,)). The accumulation is a scatter-add
    (``index_add_``) where the JAX package runs the one-hot matmul its MXU
    prefers; both are fp32 sums of the same terms."""
    d = x_chunks.shape[2]
    cent = cent.float()
    cn = (cent * cent).sum(1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=cent.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=cent.device)
    for pts, w in zip(x_chunks, w_chunks):
        ip = pts @ cent.T
        assign = torch.argmin(-2.0 * ip + cn[None, :], dim=1)
        sums.index_add_(0, assign, pts * w[:, None])
        counts.index_add_(0, assign, w)
    return sums, counts


def _init_random(x, n: int, k: int, gen: torch.Generator):
    """k distinct valid points, uniform without replacement."""
    seed_ids = torch.randperm(n, generator=gen, device=gen.device)[:k]
    return x[seed_ids.to(x.device)].clone()


def _init_pp(x, n: int, k: int, gen: torch.Generator):
    """k-means++ seeding: each next seed sampled ~ D^2 to the nearest chosen
    seed (falls back to uniform when every remaining point coincides with a
    seed)."""
    pts = x[:n]
    first = int(torch.randint(n, (1,), generator=gen, device=gen.device).item())
    cent = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    cent[0] = pts[first]
    d2 = ((pts - pts[first]) ** 2).sum(1)
    for i in range(1, k):
        weights = d2 if bool((d2 > 0).any()) else torch.ones_like(d2)
        pick = torch.multinomial(weights.to(gen.device), 1, generator=gen)
        c = pts[pick.to(x.device)[0]]
        cent[i] = c
        d2 = torch.minimum(d2, ((pts - c) ** 2).sum(1))
    return cent


def _use_pp(k: int, init: str) -> bool:
    if init == "kmeans++":
        return True
    if init == "random":
        return False
    # auto: ++ seeding is sequential over k; past ~16k centroids it
    # dominates, fall back to random (the JAX package's rule)
    return k <= 16384


_CHUNK_BYTE_BUDGET = 512 * 1024 * 1024


def auto_chunk(k: int, requested: int = None) -> int:
    """Bound the (chunk, k) fp32 assignment block to the byte budget."""
    if requested is not None:
        return requested
    return max(256, min(8192, _CHUNK_BYTE_BUDGET // (4 * max(k, 1))))


def kmeans(x, k: int, iters: int = 20, seed: int = 0, chunk: int = None,
           init: str = "auto", device=None) -> torch.Tensor:
    """L2 Lloyd k-means. x: (n, d) tensor (or array) -> centroids (k, d)
    fp32 on ``device`` (default: x's device)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if device is not None:
        x = x.to(device)
    n, d = x.shape
    if k > n:
        raise ValueError(f"k={k} > n={n} training points")
    chunk = min(auto_chunk(k, chunk), max(8, n))
    npad = -(-n // chunk) * chunk
    mask = (torch.arange(npad, device=x.device) < n).float()
    if npad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    cent = _init_pp(x, n, k, gen) if _use_pp(k, init) else _init_random(x, n, k, gen)
    xc = x.reshape(npad // chunk, chunk, d)
    mc = mask.reshape(npad // chunk, chunk)
    for _ in range(iters):
        sums, counts = accumulate_clusters(xc, mc, cent, k)
        cent = torch.where(counts[:, None] > 0,
                           sums / torch.clamp_min(counts, 1.0)[:, None], cent)
    return cent
