"""Rows and queries of a configuration, drawn on the device from the seed.

The low-rank mixture of ``benchmarks/baseline_configs.py`` (copied, with
its draws on the card as ``chip_smoke.py``'s ``lowrank_rows`` makes them):
``clusters`` gaussians in ``rank`` dims, embedded by a random orthonormal
(rank, dim) map, plus isotropic ambient noise. The map and the cluster
centres are the configuration's (``structure_seed``), so every seed serves
a corpus of the same shape; the rows and queries come from ``--seed``.
"""

import numpy as np
import torch

# rows a device draw makes at once (bounds the temporaries)
DRAW_CHUNK = 500_000

STREAMS = {"rows": 0, "queries": 1, "warm": 2, "eval": 3}


def stream_seed(seed: int, stream: str, part: int = 0) -> int:
    """A 63-bit generator seed for one stream of one run's seed (``part``:
    one chunk of a stream drawn in pieces)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), STREAMS[stream]]
                                + ([int(part)] if part else []))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class LowRankCorpus:
    def __init__(self, corpus: dict, dim: int, device):
        if corpus.get("kind") != "lowrank":
            raise ValueError(f"unknown corpus kind {corpus.get('kind')!r}")
        self.dim = int(dim)
        self.rank = int(corpus["rank"])
        self.clusters = int(corpus["clusters"])
        self.sigma = float(corpus["ambient_sigma"])
        self.device = torch.device(device)
        rng = np.random.default_rng(int(corpus["structure_seed"]))
        w = np.linalg.qr(rng.standard_normal((self.dim, self.rank)))[0].T
        centers = rng.standard_normal((self.clusters, self.rank)) * float(corpus["center_scale"])
        self.w = torch.as_tensor(w.astype(np.float32), device=self.device)
        self.centers = torch.as_tensor(centers.astype(np.float32), device=self.device)

    def draw(self, n: int, seed: int, stream: str, part: int = 0) -> torch.Tensor:
        """(n, dim) float32 rows on the device; the same (seed, stream,
        part) gives the same rows on the same kind of device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(seed, stream, part))
        out = torch.empty((n, self.dim), dtype=torch.float32, device=self.device)
        for s in range(0, n, DRAW_CHUNK):
            m = min(DRAW_CHUNK, n - s)
            a = torch.randint(0, self.clusters, (m,), generator=g, device=self.device)
            z = self.centers[a] + torch.randn((m, self.rank), generator=g, device=self.device)
            out[s:s + m] = z @ self.w + self.sigma * torch.randn(
                (m, self.dim), generator=g, device=self.device)
        return out


def make_corpus(config: dict, device) -> LowRankCorpus:
    return LowRankCorpus(config["corpus"], config["dim"], device)
