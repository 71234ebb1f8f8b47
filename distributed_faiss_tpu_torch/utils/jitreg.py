"""Program registry: the one declaration of the port's captured-program
surface (counterpart of distributed_faiss_tpu/utils/jitreg.py).

The JAX package registers every jitted launch target with its abstract
signatures, for the IR tier of its lint (``tools/graftlint``, not ported),
and with the bucket budget its steady serving may compile. The port's
counterpart of a jitted entry is a program of ``utils/programs.py``: a
model's search function captured as a CUDA graph under the name it passes
to ``ProgramCache.bind`` / ``run`` (``<prefix>.block``, ``<prefix>.fused``,
``<prefix>.routed``). ``REGISTRY`` has one row for each such name, with
the bucket family its key can take and the budget of the JAX row it
stands for, and one for the host-side block loop; ``INSIDE`` names, for
each JAX row the port has no program of its own for, where that work runs
in the port. ``utils/compilecheck.py`` tallies each ``capture:<name>``
record under its row.

Keys of a row:
  name     the program name passed to the cache ("blocked_search" for the
           host-side block loop, which captures nothing itself)
  path     repo-relative file of the port's function
  qualname the port's function: the fused body the program runs
  jax      the JAX registry row (qualname) it stands for
  buckets  name of the ``buckets_*`` enumerator of its key's bucket family
  budget   the JAX row's declared budget: the most buckets steady serving
           may capture
  hot      reachable from the serving path

The enumerators run the port's own pow2 helpers (``ops.distance.
bucket_size``, ``models.base.pick_query_block`` and ``_next_pow2``), so a
change to the bucketing moves the enumeration.
"""

_MESH = "distributed_faiss_tpu_torch/parallel/mesh.py"
_IVF = "distributed_faiss_tpu_torch/models/ivf.py"

# Upper bound on the merged serving-window rows the enumerators consider
# (the JAX package's).
MAX_SERVING_WINDOW_ROWS = 8192

REGISTRY = (
    {"name": "flat.block", "path": "distributed_faiss_tpu_torch/models/flat.py",
     "qualname": "_flat_search_fused", "jax": "_knn_scan",
     "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "flat.fused", "path": "distributed_faiss_tpu_torch/models/flat.py",
     "qualname": "_flat_search_fused", "jax": "_flat_search_fused",
     "buckets": "buckets_fused_nblocks", "budget": 3, "hot": True},
    {"name": "ivf_flat.block", "path": _IVF, "qualname": "_ivf_flat_search_fused",
     "jax": "_ivf_flat_search", "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "ivf_flat.fused", "path": _IVF, "qualname": "_ivf_flat_search_fused",
     "jax": "_ivf_flat_search_fused", "buckets": "buckets_fused_nblocks", "budget": 3,
     "hot": True},
    {"name": "ivf_pq.block", "path": _IVF, "qualname": "_ivf_pq_search_fused",
     "jax": "_ivf_pq_search", "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "ivf_pq.fused", "path": _IVF, "qualname": "_ivf_pq_search_fused",
     "jax": "_ivf_pq_search_fused", "buckets": "buckets_fused_nblocks", "budget": 3,
     "hot": True},
    # flat PQ: an IVF-PQ index with one list, which the JAX package serves
    # through its IVF-PQ entries
    {"name": "pq_shared.block", "path": _IVF, "qualname": "_pq_shared_search_fused",
     "jax": "_ivf_pq_search", "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "pq_shared.fused", "path": _IVF, "qualname": "_pq_shared_search_fused",
     "jax": "_ivf_pq_search_fused", "buckets": "buckets_fused_nblocks", "budget": 3,
     "hot": True},
    {"name": "sharded_flat.block", "path": _MESH, "qualname": "_sharded_knn_fused",
     "jax": "_sharded_knn_jit", "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "sharded_flat.fused", "path": _MESH, "qualname": "_sharded_knn_fused",
     "jax": "_sharded_knn_fused", "buckets": "buckets_fused_nblocks", "budget": 3,
     "hot": True},
    {"name": "sharded_ivf_flat.block", "path": _MESH,
     "qualname": "_sharded_ivf_flat_search_fused", "jax": "_sharded_ivf_flat_search",
     "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "sharded_ivf_flat.fused", "path": _MESH,
     "qualname": "_sharded_ivf_flat_search_fused", "jax": "_sharded_ivf_flat_search_fused",
     "buckets": "buckets_fused_nblocks", "budget": 3, "hot": True},
    {"name": "sharded_ivf_pq.block", "path": _MESH,
     "qualname": "_sharded_ivf_pq_search_fused", "jax": "_sharded_ivf_pq_search",
     "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "sharded_ivf_pq.fused", "path": _MESH,
     "qualname": "_sharded_ivf_pq_search_fused", "jax": "_sharded_ivf_pq_search_fused",
     "buckets": "buckets_fused_nblocks", "budget": 3, "hot": True},
    # one program a block bucket at the steady pair bucket; a relaunch at a
    # grown bucket captures one more (the JAX package's one extra compile)
    {"name": "sharded_ivf_flat.routed", "path": _MESH,
     "qualname": "_sharded_ivf_flat_search_routed", "jax": "_sharded_ivf_flat_search_routed",
     "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    {"name": "sharded_ivf_pq.routed", "path": _MESH,
     "qualname": "_sharded_ivf_pq_search_routed", "jax": "_sharded_ivf_pq_search_routed",
     "buckets": "buckets_query_blocks", "budget": 8, "hot": True},
    # the host-side block loop: the family every program behind it inherits
    {"name": "blocked_search", "path": "distributed_faiss_tpu_torch/models/base.py",
     "qualname": "blocked_search", "jax": "blocked_search",
     "buckets": "buckets_blocked_search", "budget": 11, "hot": True},
)

# Each JAX registry row that no port program stands for, and where its work
# runs in the port: inside a search program (a registered name), or op by
# op on another path.
INSIDE = {
    "flat_list_scan_pallas": "ivf_flat.block",
    "adc_scan_pallas": "ivf_pq.block",
    "adc_scan_pallas_nibble": "ivf_pq.block",
    "adc_scan_shared_pallas": "pq_shared.block",
    "adc_lut": "ivf_pq.block",
    "adc_scan": "ivf_pq.block",
    "adc_scan_shared": "pq_shared.block",
    "row_norms_f32": "ivf_flat.block",
    "_coarse_assign": "ivf_flat.block",
    "_rerank_exact": "ivf_flat.block",
    "_pq_encode_block": "op by op: the add path (ops/pq.py pq_encode)",
    "pq_decode": "op by op: reconstruct (ops/pq.py pq_decode)",
    "_write_rows": "op by op: the add path (models/base.py DeviceVectorStore)",
    "_mask_rows_false": "op by op: the delete path (models/base.py mask_rows)",
    "_mask_cells_neg1": "op by op: the delete path (models/base.py mask_cells)",
    "_scatter_lists": "op by op: the add path (models/base.py PaddedLists.append)",
    "_gather_flat_rows": "op by op: reconstruct (models/base.py gather_list_rows)",
    "_kmeans_step_jit": "op by op: training (parallel/mesh.py kmeans_step)",
    "_take_rows": "op by op: reconstruct (parallel/mesh.py ShardedFlatIndex)",
}


# -------------------------------------------------------- bucket enumerators


def _serving_block() -> int:
    from distributed_faiss_tpu_torch.models import base

    # the flat serving block, the largest any model path uses
    return base.pick_query_block(65536 * 4)


def buckets_query_blocks() -> list:
    """Row buckets a one-block program can see: ``query_blocks`` pads each
    block to its ``distance.bucket_size``."""
    from distributed_faiss_tpu_torch.ops import distance

    block = _serving_block()
    return sorted({distance.bucket_size(n) for n in range(1, block + 1)})


def buckets_fused_nblocks() -> list:
    """nblocks buckets a window program can see for windows up to
    MAX_SERVING_WINDOW_ROWS rows (``blocked_search`` pads nblocks to a
    power of two)."""
    from distributed_faiss_tpu_torch.models import base

    block = _serving_block()
    return sorted({base._next_pow2(-(-n // block), 1)
                   for n in range(block + 1, MAX_SERVING_WINDOW_ROWS + 1)})


def buckets_blocked_search() -> list:
    """The block loop's whole family: one-block buckets and window buckets."""
    return ([("block", b) for b in buckets_query_blocks()]
            + [("nblocks", b) for b in buckets_fused_nblocks()])


# -------------------------------------------------------------------- lookup


def rows() -> tuple:
    """REGISTRY (stable order)."""
    return REGISTRY


def registered_qualnames() -> tuple:
    """The registered program names (the counterpart of the JAX module's
    qualnames: what the cache is passed)."""
    return tuple(r["name"] for r in REGISTRY)


def row_of(name: str):
    """The row registered under the program name ``name``, or None."""
    for r in REGISTRY:
        if r["name"] == name:
            return r
    return None


def enumerate_buckets(row) -> list:
    """The row's reachable bucket family (empty when it has no enumerator)."""
    if not row["buckets"]:
        return []
    return globals()[row["buckets"]]()
