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

``kmeans_batched`` runs m independent problems (the PQ codebooks) as one
batch dimension, where the JAX package vmaps: one bmm and one scatter-add
per chunk for all m problems, and a k-means++ seeding that draws the m
problems' next seeds together (one ``multinomial`` over an (m, n) weight
block per step, no host sync).
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


def accumulate_clusters_batched(x_chunks: torch.Tensor, w_chunks: torch.Tensor,
                                cent: torch.Tensor, k: int):
    """``accumulate_clusters`` for m independent problems at once.

    x_chunks: (m, nchunks, chunk, d); w_chunks: (nchunks, chunk) 0/1
    weights shared by the m problems; cent: (m, k, d). Returns (sums
    (m, k, d), counts (m, k)): per chunk one bmm and one argmin for all m
    problems, then one scatter-add into the flattened (m * k) clusters."""
    m, _, _, d = x_chunks.shape
    cent = cent.float()
    cn = (cent * cent).sum(2)  # (m, k)
    sums = torch.zeros((m * k, d), dtype=torch.float32, device=cent.device)
    counts = torch.zeros((m * k,), dtype=torch.float32, device=cent.device)
    offset = (torch.arange(m, device=cent.device) * k)[:, None]
    for ci in range(x_chunks.shape[1]):
        pts = x_chunks[:, ci]  # (m, chunk, d)
        w = w_chunks[ci]
        ip = torch.bmm(pts, cent.transpose(1, 2))  # (m, chunk, k)
        assign = torch.argmin(-2.0 * ip + cn[:, None, :], dim=2) + offset
        flat = assign.reshape(-1)
        sums.index_add_(0, flat, (pts * w[None, :, None]).reshape(-1, d))
        counts.index_add_(0, flat, w.repeat(m))
    return sums.reshape(m, k, d), counts.reshape(m, k)


def _init_random_batched(xs, n: int, k: int, gen: torch.Generator):
    """k distinct valid points per problem, uniform without replacement."""
    m = xs.shape[0]
    keys = torch.rand((m, n), generator=gen, device=gen.device)
    seed_ids = torch.argsort(keys, dim=1)[:, :k].to(xs.device)
    return torch.gather(xs[:, :n], 1, seed_ids[:, :, None].expand(m, k, xs.shape[2]))


def _init_pp_batched(xs, n: int, k: int, gen: torch.Generator):
    """k-means++ seeding of m problems at once: each step draws every
    problem's next seed ~ D^2 in one ``multinomial`` over the (m, n)
    distance block (uniform for a problem whose points all coincide with
    its seeds). Nothing is read back to the host."""
    m, _, d = xs.shape
    pts = xs[:, :n]
    rows = torch.arange(m, device=xs.device)
    first = torch.randint(n, (m,), generator=gen, device=gen.device).to(xs.device)
    cent = torch.zeros((m, k, d), dtype=torch.float32, device=xs.device)
    c = pts[rows, first]  # (m, d)
    cent[:, 0] = c
    d2 = ((pts - c[:, None, :]) ** 2).sum(2)  # (m, n)
    for i in range(1, k):
        weights = torch.where((d2 > 0).any(1, keepdim=True), d2, torch.ones_like(d2))
        pick = torch.multinomial(weights.to(gen.device), 1, generator=gen)[:, 0]
        c = pts[rows, pick.to(xs.device)]
        cent[:, i] = c
        d2 = torch.minimum(d2, ((pts - c[:, None, :]) ** 2).sum(2))
    return cent


def kmeans_batched(xs, k: int, iters: int = 20, seed: int = 0, chunk: int = None,
                   init: str = "auto") -> torch.Tensor:
    """Independent L2 Lloyd k-means over the leading axis (PQ codebooks).
    xs: (m, n, dsub) tensor (or array) -> centroids (m, k, dsub) fp32 on
    xs's device. Chunked by ``auto_chunk(k * m)`` as in the JAX package, so
    one chunk's (m, chunk, k) score block stays within the same budget."""
    xs = torch.as_tensor(xs, dtype=torch.float32)
    m, n, d = xs.shape
    if k > n:
        raise ValueError(f"k={k} > n={n} training points")
    chunk = min(auto_chunk(k * m, chunk), max(8, n))
    npad = -(-n // chunk) * chunk
    mask = (torch.arange(npad, device=xs.device) < n).float()
    if npad != n:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, npad - n))
    gen = torch.Generator(device=xs.device)
    gen.manual_seed(seed)
    init_fn = _init_pp_batched if _use_pp(k, init) else _init_random_batched
    cent = init_fn(xs, n, k, gen)
    xc = xs.reshape(m, npad // chunk, chunk, d)
    mc = mask.reshape(npad // chunk, chunk)
    for _ in range(iters):
        sums, counts = accumulate_clusters_batched(xc, mc, cent, k)
        cent = torch.where(counts[:, :, None] > 0,
                           sums / torch.clamp_min(counts, 1.0)[:, :, None], cent)
    return cent
