"""Builder registry + factory-string parser (counterpart of
distributed_faiss_tpu/models/factory.py).

Ported builders (same names as the reference and the JAX package):
- flat       — exact search, honoring cfg.metric;
- ivf_simple — IVF + fp32 lists (IndexIVFFlat);
- ivfsq      — IVF + fp16 lists (IndexIVFScalarQuantizer QT_fp16);
- knnlm      — IVF-PQ, m = cfg.extra['code_size'] (default 64), 8-bit codes
               (IndexIVFPQ), with the pallas_adc, adc_lut_bf16,
               refine_k_factor and kmeans_iters knobs; its opq=True and
               shard_lists=True variants are not ported and raise.

Factory strings: ``Flat | SQ8 | SQfp16 | PQ<m>[x8]`` and
``IVF<n>,(Flat|SQ8|SQfp16|PQ<m>[x8])``, each with an optional
``,RFlat`` / ``,Refine(Flat)`` suffix (``{centroids}`` templating as in the
reference). ``index_from_state_dict`` rebuilds the kinds ``flat``,
``ivf_flat`` and ``ivf_pq`` — the npz state written by either package loads
here.

Everything else (hnswsq, ivf_tpu, HNSW/OPQ/PCA specs, the sharded and
pretransform kinds) raises a "not yet ported" error.
"""

import re

from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.utils.config import IndexCfg


def _not_ported(what: str):
    return RuntimeError(f"{what} is not yet ported to distributed_faiss_tpu_torch "
                        "(ported: the flat, ivf_simple, ivfsq and knnlm builders; "
                        "the Flat, SQ8, SQfp16 and PQ<m> factory specs, alone or "
                        "under IVF<n>, with an optional RFlat)")


def _centroids(cfg: IndexCfg) -> int:
    c = int(cfg.centroids)
    if c <= 0:
        raise RuntimeError(
            "cfg.centroids must be set (or inferred by the engine) before building an IVF index")
    return c


def _kmeans_iters(cfg: IndexCfg) -> int:
    return int(cfg.extra.get("kmeans_iters", 10))


def _flat_scan_knobs(cfg: IndexCfg) -> dict:
    """IVF-Flat/SQ8 scan knobs riding in cfg.extra: pallas_flat (accepted and
    persisted; the CUDA scan is always the hand kernel), scan_bf16 (legal
    only with refine_k_factor > 0), refine_k_factor."""
    return dict(
        use_pallas=bool(cfg.extra.get("pallas_flat", False)),
        scan_bf16=bool(cfg.extra.get("scan_bf16", False)),
        refine_k_factor=int(cfg.extra.get("refine_k_factor", 0)),
    )


def _build_flat(cfg: IndexCfg, device):
    if cfg.extra.get("mesh_shards"):
        raise _not_ported("the mesh-sharded flat index (mesh_shards)")
    return FlatIndex(cfg.dim, cfg.get_metric(), device=device)


def _build_ivf_simple(cfg: IndexCfg, device) -> IVFFlatIndex:
    return IVFFlatIndex(cfg.dim, _centroids(cfg), cfg.get_metric(), "f32",
                        kmeans_iters=_kmeans_iters(cfg), device=device,
                        **_flat_scan_knobs(cfg))


def _build_ivfsq(cfg: IndexCfg, device) -> IVFFlatIndex:
    return IVFFlatIndex(cfg.dim, _centroids(cfg), cfg.get_metric(), "f16",
                        kmeans_iters=_kmeans_iters(cfg), device=device,
                        **_flat_scan_knobs(cfg))


def _build_knnlm(cfg: IndexCfg, device) -> IVFPQIndex:
    if cfg.extra.get("opq"):
        raise _not_ported("the knnlm builder's opq=True (OPQ rotation in front of IVF-PQ)")
    if cfg.extra.get("shard_lists"):
        raise _not_ported("the knnlm builder's shard_lists=True (mesh-sharded lists)")
    return IVFPQIndex(cfg.dim, _centroids(cfg), m=int(cfg.extra.get("code_size", 64)),
                      nbits=int(cfg.extra.get("nbits", 8)), metric=cfg.get_metric(),
                      kmeans_iters=_kmeans_iters(cfg),
                      use_pallas=bool(cfg.extra.get("pallas_adc", False)),
                      refine_k_factor=int(cfg.extra.get("refine_k_factor", 0)),
                      adc_lut_bf16=bool(cfg.extra.get("adc_lut_bf16", False)),
                      device=device)


INDEX_BUILDERS = {
    "flat": _build_flat,
    "ivf_simple": _build_ivf_simple,
    "ivfsq": _build_ivfsq,
    "knnlm": _build_knnlm,
}

# builders of the JAX package that later slices port
_PENDING_BUILDERS = ("hnswsq", "ivf_tpu")

_FLAT_CODECS = {"Flat": "f32", "SQ8": "sq8", "SQfp16": "f16"}
_IVF_CODECS = {"Flat": "f32", "SQ8": "sq8", "SQfp16": "f16", "SQ16": "f16"}


def _parse_pq_m(token: str) -> int:
    """``PQ<m>`` or ``PQ<m>x8`` -> m; other code widths are refused."""
    body = token[2:]
    if "x" in body:
        body, bits = body.split("x")
        if int(bits) != 8:
            raise RuntimeError(f"only 8-bit PQ supported, got {token}")
    return int(body)


def _is_pq(token: str) -> bool:
    return bool(re.fullmatch(r"PQ\d+(x\d+)?", token))


def parse_factory(cfg: IndexCfg, device):
    """Build from a FAISS-style factory spec (the ported subset of the JAX
    package's grammar): ``(Flat|SQ8|SQfp16|PQ<m>[x8])`` or
    ``IVF<n>,(Flat|SQ8|SQfp16|PQ<m>[x8])``, with an optional
    ``,RFlat|,Refine(Flat)`` suffix. A flat ``PQ<m>`` is IVF-PQ with one
    list, always probed."""
    spec = cfg.faiss_factory
    if "{centroids}" in spec:
        spec = spec.format(centroids=int(cfg.centroids))
    parts = [p.strip() for p in spec.split(",")]
    metric = cfg.get_metric()
    refine_k = 0
    if parts and parts[-1] in ("RFlat", "Refine(Flat)"):
        refine_k = int(cfg.extra.get("refine_k_factor", 8))
        parts = parts[:-1]
    if len(parts) == 1 and parts[0] in _FLAT_CODECS:
        return FlatIndex(cfg.dim, metric, codec=_FLAT_CODECS[parts[0]], device=device)
    if len(parts) == 1 and _is_pq(parts[0]):
        idx = IVFPQIndex(cfg.dim, 1, m=_parse_pq_m(parts[0]), metric=metric,
                         refine_k_factor=refine_k, device=device)
        idx.set_nprobe(1)
        return idx
    if (len(parts) == 2 and parts[0].startswith("IVF") and parts[0][3:].isdigit()
            and _is_pq(parts[1])):
        return IVFPQIndex(cfg.dim, int(parts[0][3:]), m=_parse_pq_m(parts[1]), metric=metric,
                          kmeans_iters=_kmeans_iters(cfg), refine_k_factor=refine_k,
                          device=device)
    if (len(parts) == 2 and parts[0].startswith("IVF") and parts[0][3:].isdigit()
            and parts[1] in _IVF_CODECS):
        knobs = _flat_scan_knobs(cfg)
        knobs.pop("refine_k_factor")
        return IVFFlatIndex(cfg.dim, int(parts[0][3:]), metric, _IVF_CODECS[parts[1]],
                            kmeans_iters=_kmeans_iters(cfg), refine_k_factor=refine_k,
                            device=device, **knobs)
    raise _not_ported(f"factory spec {spec!r}")


def build_index(cfg: IndexCfg, device="cuda"):
    """Resolve cfg -> index model. The engine resolves cfg.centroids first."""
    if cfg.index_builder_type:
        if cfg.index_builder_type in _PENDING_BUILDERS:
            raise _not_ported(f"index_builder_type {cfg.index_builder_type!r}")
        try:
            builder = INDEX_BUILDERS[cfg.index_builder_type]
        except KeyError:
            raise RuntimeError(f"unknown index_builder_type {cfg.index_builder_type!r}")
        return builder(cfg, device)
    if cfg.faiss_factory:
        return parse_factory(cfg, device)
    raise RuntimeError(
        "Either faiss_factory or valid index_builder_type should be specified to initialize index")


_STATE_KINDS = {"flat": FlatIndex, "ivf_flat": IVFFlatIndex, "ivf_pq": IVFPQIndex}
_PENDING_KINDS = ("sharded_flat", "sharded_ivf_flat", "sharded_ivf_pq",
                  "hnswsq", "pretransform")


def index_from_state_dict(state, device="cuda"):
    """Rebuild a ported index model from its state_dict (either package's)."""
    kind = str(state["kind"])
    if kind in _PENDING_KINDS:
        raise _not_ported(f"serialized index kind {kind!r}")
    try:
        cls = _STATE_KINDS[kind]
    except KeyError:
        raise RuntimeError(f"unknown serialized index kind {kind!r}")
    return cls.from_state_dict(state, device=device)
