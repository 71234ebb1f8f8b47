"""Builder registry + factory-string parser (counterpart of
distributed_faiss_tpu/models/factory.py).

Ported builders (same names as the reference and the JAX package):
- flat       — exact search, honoring cfg.metric;
- ivf_simple — IVF + fp32 lists (IndexIVFFlat);
- ivfsq      — IVF + fp16 lists (IndexIVFScalarQuantizer QT_fp16).

Factory strings: ``Flat | SQ8 | SQfp16`` and
``IVF<n>,(Flat|SQ8|SQfp16)[,RFlat]`` (``{centroids}`` templating as in the
reference). ``index_from_state_dict`` rebuilds the kinds ``flat`` and
``ivf_flat`` — the npz state written by either package loads here.

Everything else (knnlm, hnswsq, ivf_tpu, PQ/HNSW/OPQ/PCA specs, the
sharded and pretransform kinds) raises a "not yet ported" error.
"""

from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex
from distributed_faiss_tpu_torch.utils.config import IndexCfg


def _not_ported(what: str):
    return RuntimeError(f"{what} is not yet ported to distributed_faiss_tpu_torch "
                        "(this slice ports flat, ivf_simple and ivfsq)")


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


INDEX_BUILDERS = {
    "flat": _build_flat,
    "ivf_simple": _build_ivf_simple,
    "ivfsq": _build_ivfsq,
}

# builders of the JAX package that later slices port
_PENDING_BUILDERS = ("knnlm", "hnswsq", "ivf_tpu")

_FLAT_CODECS = {"Flat": "f32", "SQ8": "sq8", "SQfp16": "f16"}
_IVF_CODECS = {"Flat": "f32", "SQ8": "sq8", "SQfp16": "f16", "SQ16": "f16"}


def parse_factory(cfg: IndexCfg, device):
    """Build from a FAISS-style factory spec (the ported subset of the JAX
    package's grammar): ``Flat|SQ8|SQfp16`` or
    ``IVF<n>,(Flat|SQ8|SQfp16)[,RFlat|,Refine(Flat)]``."""
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


_STATE_KINDS = {"flat": FlatIndex, "ivf_flat": IVFFlatIndex}
_PENDING_KINDS = ("ivf_pq", "sharded_flat", "sharded_ivf_flat", "sharded_ivf_pq",
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
