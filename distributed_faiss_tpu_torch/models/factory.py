"""Builder registry + factory-string parser (counterpart of
distributed_faiss_tpu/models/factory.py).

Ported builders (same names as the reference and the JAX package):
- flat       — exact search, honoring cfg.metric;
- ivf_simple — IVF + fp32 lists (IndexIVFFlat);
- ivfsq      — IVF + fp16 lists (IndexIVFScalarQuantizer QT_fp16);
- knnlm      — IVF-PQ, m = cfg.extra['code_size'] (default 64), 8-bit codes
               (IndexIVFPQ), with the pallas_adc, adc_lut_bf16,
               refine_k_factor and kmeans_iters knobs; opq=True puts an OPQ
               rotation in front (opq_iters, default 8); shard_lists=True
               shards the code lists over the mesh (ShardedIVFPQIndex);
- hnswsq     — the host C++ HNSW graph over SQ8 codes (models/hnsw.py), L2
               only: store_n (graph degree, default 128), ef_construction
               (default 100), refine_k_factor (default 8); nprobe is
               efSearch. Without a working C++ compiler it raises; it never
               falls back to a flat scan;
- ivf_tpu    — IVF-Flat whose coarse k-means trains sharded over the mesh
               (IvfTpuIndex, the single-device K1 scan); shard_lists=True
               shards the fp32 lists too (ShardedIVFFlatIndex).

The mesh knobs (parallel/mesh.py): ``mesh_shards=True`` on ``flat`` shards
the corpus (ShardedFlatIndex); ``mesh_devices`` pins the shard count (0:
every visible device; unset: DFT_MESH_DEVICES); ``mesh_virtual=True``
lets more shards than visible devices share them round-robin (the port's
counterpart of the JAX tests' forced host device count);
``probe_routing`` picks the sharded IVF scan mode (unset:
DFT_MESH_MODE).

Factory strings: ``[OPQ<m>[_<dout>],|PCA<dout>,|PCAR<dout>,] core
[,RFlat|,Refine(Flat)]`` with core ``Flat | SQ8 | SQfp16 | PQ<m>[x8]``,
``HNSW<M>[,Flat|,SQ8]`` or ``IVF<n>,(Flat|SQ8|SQfp16|PQ<m>[x8])``
(``{centroids}`` templating as in the reference). ``index_from_state_dict``
rebuilds the kinds ``flat``, ``ivf_flat``, ``ivf_pq``, ``hnswsq``,
``pretransform``, ``sharded_flat``, ``sharded_ivf_flat`` and
``sharded_ivf_pq``: the npz state written by either package loads here
(a sharded kind on ``make_mesh(None)``, the host's mesh, whatever mesh
wrote it).
"""

import logging
import re

from distributed_faiss_tpu_torch.models.flat import FlatIndex
from distributed_faiss_tpu_torch.models.hnsw import HNSWSQIndex
from distributed_faiss_tpu_torch.models.ivf import IVFFlatIndex, IVFPQIndex
from distributed_faiss_tpu_torch.models.pretransform import PreTransformIndex
from distributed_faiss_tpu_torch.parallel.mesh import (
    IvfTpuIndex,
    ShardedFlatIndex,
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
    make_mesh,
)
from distributed_faiss_tpu_torch.utils.config import IndexCfg, MeshCfg

logger = logging.getLogger()


def _not_ported(what: str):
    return RuntimeError(f"{what} is not yet ported to distributed_faiss_tpu_torch "
                        "(ported: the flat, ivf_simple, ivfsq, knnlm, hnswsq and ivf_tpu "
                        "builders; the Flat, SQ8, SQfp16 and PQ<m> factory specs, "
                        "alone or under IVF<n>, and HNSW<M>, with an optional RFlat "
                        "and an optional OPQ<m>[_<d>], PCA<d> or PCAR<d> prefix)")


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


def _mesh(cfg: IndexCfg, device):
    """The cfg's mesh: cfg.extra['mesh_devices'] pins the shard count (0:
    every visible device) and 'mesh_virtual' lets the shards share
    devices; neither set -> None, and the model's ``make_mesh(None)``
    applies the host's MeshCfg."""
    n_dev = cfg.extra.get("mesh_devices")
    virtual = bool(cfg.extra.get("mesh_virtual", False))
    if n_dev is None and not virtual:
        return None
    return make_mesh(None if n_dev is None else int(n_dev), device=device, virtual=virtual)


def _probe_routing(cfg: IndexCfg) -> bool:
    """Sharded-IVF serving mode: cfg.extra['probe_routing'] wins, else the
    host's DFT_MESH_MODE ('routed' -> True)."""
    pr = cfg.extra.get("probe_routing")
    if pr is None:
        return MeshCfg.from_env().mode == "routed"
    return bool(pr)


def _warn_routing_ignored(cfg: IndexCfg, builder: str) -> None:
    if _probe_routing(cfg):
        logger.warning("probe_routing (cfg.extra or DFT_MESH_MODE=routed) requires "
                       "shard_lists=True on the %s builder; ignored — building the "
                       "single-device scan", builder)


def _build_flat(cfg: IndexCfg, device):
    if cfg.extra.get("mesh_shards"):
        # exact search with the corpus sharded over the mesh
        return ShardedFlatIndex(cfg.dim, cfg.get_metric(), mesh=_mesh(cfg, device),
                                device=device)
    if cfg.extra.get("mesh_devices") is not None:  # 0 is an explicit pin too
        logger.warning("mesh_devices is set but mesh_shards is not: building a "
                       "single-device flat index (set mesh_shards=True to shard)")
    return FlatIndex(cfg.dim, cfg.get_metric(), device=device)


def _build_ivf_simple(cfg: IndexCfg, device) -> IVFFlatIndex:
    return IVFFlatIndex(cfg.dim, _centroids(cfg), cfg.get_metric(), "f32",
                        kmeans_iters=_kmeans_iters(cfg), device=device,
                        **_flat_scan_knobs(cfg))


def _build_ivfsq(cfg: IndexCfg, device) -> IVFFlatIndex:
    return IVFFlatIndex(cfg.dim, _centroids(cfg), cfg.get_metric(), "f16",
                        kmeans_iters=_kmeans_iters(cfg), device=device,
                        **_flat_scan_knobs(cfg))


def _opq_iters(cfg: IndexCfg) -> int:
    return int(cfg.extra.get("opq_iters", 8))


def _build_knnlm(cfg: IndexCfg, device):
    m = int(cfg.extra.get("code_size", 64))
    knobs = dict(m=m, nbits=int(cfg.extra.get("nbits", 8)), metric=cfg.get_metric(),
                 kmeans_iters=_kmeans_iters(cfg),
                 use_pallas=bool(cfg.extra.get("pallas_adc", False)),
                 refine_k_factor=int(cfg.extra.get("refine_k_factor", 0)),
                 adc_lut_bf16=bool(cfg.extra.get("adc_lut_bf16", False)), device=device)
    if cfg.extra.get("shard_lists"):
        inner = ShardedIVFPQIndex(cfg.dim, _centroids(cfg), mesh=_mesh(cfg, device),
                                  probe_routing=_probe_routing(cfg), **knobs)
    else:
        _warn_routing_ignored(cfg, "knnlm")
        inner = IVFPQIndex(cfg.dim, _centroids(cfg), **knobs)
    if cfg.extra.get("opq"):
        # FAISS "OPQ<m>,IVF<n>,PQ<m>": the rotation is fit on the train
        # sample, then the inner index trains on rotated rows
        return PreTransformIndex(inner, cfg.dim, opq_m=m, opq_iters=_opq_iters(cfg))
    return inner


def _hnsw(dim: int, M: int, cfg: IndexCfg, device) -> HNSWSQIndex:
    if cfg.metric != "l2":
        raise RuntimeError("hnswsq and HNSW<M> support the l2 metric only "
                           "(reference index.py:52)")
    # refine_k_factor=8 (exact fp16 rescore of the SQ8 shortlist) is on by
    # default: the bare SQ8 codec plateaus near recall 0.90, and the rerank
    # is what clears 0.95; extra={'refine_k_factor': 0} is the reference's
    # IndexHNSWSQ
    return HNSWSQIndex(dim, "l2", M=M,
                       ef_construction=int(cfg.extra.get("ef_construction", 100)),
                       refine_k_factor=int(cfg.extra.get("refine_k_factor", 8)),
                       device=device)


def _build_hnswsq(cfg: IndexCfg, device) -> HNSWSQIndex:
    # store_n=128 and efConstruction=100 are the reference builder's
    # (index.py:55-58)
    return _hnsw(cfg.dim, int(cfg.extra.get("store_n", 128)), cfg, device)


def _build_ivf_tpu(cfg: IndexCfg, device):
    mesh = _mesh(cfg, device)
    if cfg.extra.get("shard_lists"):
        # inverted lists partitioned over the mesh; K1 scores every shard
        if cfg.extra.get("pallas_flat"):
            logger.warning("pallas_flat is accepted on the sharded (shard_lists=True) flat "
                           "scan for compatibility; the port runs K1 on every shard "
                           "whatever it says")
        return ShardedIVFFlatIndex(cfg.dim, _centroids(cfg), cfg.get_metric(), mesh=mesh,
                                   kmeans_iters=_kmeans_iters(cfg),
                                   probe_routing=_probe_routing(cfg),
                                   refine_k_factor=int(cfg.extra.get("refine_k_factor", 0)),
                                   scan_bf16=bool(cfg.extra.get("scan_bf16", False)),
                                   device=device)
    _warn_routing_ignored(cfg, "ivf_tpu")
    return IvfTpuIndex(cfg.dim, _centroids(cfg), cfg.get_metric(), "f32", mesh=mesh,
                       kmeans_iters=_kmeans_iters(cfg), device=device,
                       **_flat_scan_knobs(cfg))


INDEX_BUILDERS = {
    "flat": _build_flat,
    "ivf_simple": _build_ivf_simple,
    "ivfsq": _build_ivfsq,
    "knnlm": _build_knnlm,
    "hnswsq": _build_hnswsq,
    "ivf_tpu": _build_ivf_tpu,
}

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


_OPQ_RE = re.compile(r"^OPQ(\d+)(?:_(\d+))?$")
_HNSW_RE = re.compile(r"^HNSW(\d+)$")
_PCA_RE = re.compile(r"^PCAR?(\d+)$")


def _build_core(parts, dim: int, metric: str, refine_k: int, cfg: IndexCfg, device, spec):
    """The index a spec names after its pre-transform prefix."""
    if len(parts) == 1 and parts[0] in _FLAT_CODECS:
        return FlatIndex(dim, metric, codec=_FLAT_CODECS[parts[0]], device=device)
    if len(parts) == 1 and _is_pq(parts[0]):
        # flat PQ == IVF-PQ with a single list, always probed
        idx = IVFPQIndex(dim, 1, m=_parse_pq_m(parts[0]), metric=metric,
                         refine_k_factor=refine_k, device=device)
        idx.set_nprobe(1)
        return idx
    hnsw = _HNSW_RE.match(parts[0]) if parts else None
    if hnsw and (len(parts) == 1 or (len(parts) == 2 and parts[1] in ("Flat", "SQ8"))):
        # the graph's storage is SQ8 either way
        return _hnsw(dim, int(hnsw.group(1)), cfg, device)
    if len(parts) == 2 and parts[0].startswith("IVF") and parts[0][3:].isdigit():
        nlist = int(parts[0][3:])
        if _is_pq(parts[1]):
            return IVFPQIndex(dim, nlist, m=_parse_pq_m(parts[1]), metric=metric,
                              kmeans_iters=_kmeans_iters(cfg), refine_k_factor=refine_k,
                              device=device)
        if parts[1] in _IVF_CODECS:
            knobs = _flat_scan_knobs(cfg)
            knobs.pop("refine_k_factor")
            return IVFFlatIndex(dim, nlist, metric, _IVF_CODECS[parts[1]],
                                kmeans_iters=_kmeans_iters(cfg), refine_k_factor=refine_k,
                                device=device, **knobs)
    raise _not_ported(f"factory spec {spec!r}")


def parse_factory(cfg: IndexCfg, device):
    """Build from a FAISS-style factory spec (the ported subset of the JAX
    package's grammar):

      [OPQ<m>[_<dout>],|PCA<dout>,|PCAR<dout>,] core [,RFlat|,Refine(Flat)]
      core := Flat | SQ8 | SQfp16 | PQ<m>[x8] | HNSW<M>[,Flat|,SQ8]
            | IVF<n>,(Flat|SQ8|SQfp16|PQ<m>[x8])

    A flat ``PQ<m>`` is IVF-PQ with one list, always probed. As in the JAX
    package, PCAR's random rotation is folded into the PCA basis, and RFlat
    under a dim-reducing transform reranks in the reduced space (a warning
    says so)."""
    spec = cfg.faiss_factory
    if "{centroids}" in spec:
        spec = spec.format(centroids=int(cfg.centroids))
    parts = [p.strip() for p in spec.split(",")]
    metric = cfg.get_metric()
    refine_k = 0
    if parts and parts[-1] in ("RFlat", "Refine(Flat)"):
        refine_k = int(cfg.extra.get("refine_k_factor", 8))
        parts = parts[:-1]
    pre = None  # (kind, opq m, d_out)
    if parts:
        m_opq, m_pca = _OPQ_RE.match(parts[0]), _PCA_RE.match(parts[0])
        if m_opq:
            pre = ("opq", int(m_opq.group(1)),
                   int(m_opq.group(2)) if m_opq.group(2) else cfg.dim)
        elif m_pca:
            pre = ("pca", None, int(m_pca.group(1)))
        if pre is not None:
            parts = parts[1:]
            if pre[2] > cfg.dim:
                raise RuntimeError(
                    f"pre-transform output dim {pre[2]} > input dim {cfg.dim} in {spec!r}")
    core = _build_core(parts, pre[2] if pre else cfg.dim, metric, refine_k, cfg, device, spec)
    if pre is None:
        return core
    kind, opq_m, d_out = pre
    if refine_k and d_out < cfg.dim and getattr(core, "refine_k_factor", 0):
        logger.warning("RFlat under a dim-reducing pre-transform (%r): rerank happens in "
                       "the reduced %d-dim space and cannot recover projection error "
                       "(FAISS IndexRefineFlat reranks full-dim rows)", spec, d_out)
    if kind == "opq":
        return PreTransformIndex(core, cfg.dim, opq_m=opq_m, opq_iters=_opq_iters(cfg))
    return PreTransformIndex(core, cfg.dim, pca=True)


def remove_rows_unsupported(cfg: IndexCfg) -> bool:
    """True when ``cfg`` resolves to a model without a tombstone mask: the
    host HNSW graph (``hnswsq``, ``HNSW<M>``), whose traversal cannot skip
    masked nodes without losing recall. Checkable before the model exists,
    so the engine refuses a delete while every row is still buffered. The
    JAX package answers False where it has no C++ compiler, because its
    graph builders then fall back to a maskable sq8 flat scan; the port
    has no such fallback, so it always answers True for these kinds."""
    if cfg.index_builder_type == "hnswsq":
        return True
    spec = cfg.faiss_factory or ""
    if "{centroids}" in spec:
        spec = spec.format(centroids=int(cfg.centroids or 0))
    return any(_HNSW_RE.match(p.strip()) for p in spec.split(","))


def build_index(cfg: IndexCfg, device="cuda"):
    """Resolve cfg -> index model. The engine resolves cfg.centroids first."""
    if cfg.index_builder_type:
        try:
            builder = INDEX_BUILDERS[cfg.index_builder_type]
        except KeyError:
            raise RuntimeError(f"unknown index_builder_type {cfg.index_builder_type!r}")
        return builder(cfg, device)
    if cfg.faiss_factory:
        return parse_factory(cfg, device)
    raise RuntimeError(
        "Either faiss_factory or valid index_builder_type should be specified to initialize index")


_STATE_KINDS = {"flat": FlatIndex, "ivf_flat": IVFFlatIndex, "ivf_pq": IVFPQIndex,
                "hnswsq": HNSWSQIndex, "pretransform": PreTransformIndex,
                "sharded_flat": ShardedFlatIndex, "sharded_ivf_flat": ShardedIVFFlatIndex,
                "sharded_ivf_pq": ShardedIVFPQIndex}


def index_from_state_dict(state, device="cuda"):
    """Rebuild a ported index model from its state_dict (either package's)."""
    kind = str(state["kind"])
    try:
        cls = _STATE_KINDS[kind]
    except KeyError:
        raise RuntimeError(f"unknown serialized index kind {kind!r}")
    return cls.from_state_dict(state, device=device)
