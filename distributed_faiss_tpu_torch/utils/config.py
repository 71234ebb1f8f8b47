"""Per-index configuration plus the per-rank serving knobs this slice uses
(counterpart of distributed_faiss_tpu/utils/config.py).

``IndexCfg`` keeps the reference's field names and defaults
(distributed_faiss/index_cfg.py:11-64): unknown kwargs land in
``self.extra`` and the JSON round-trip (``from_json`` /
``to_json_string``) writes the same text as the JAX package, so a
``cfg.json`` written by either package loads in the other.

``SchedulerCfg``, ``WireCfg``, ``MutationCfg``, ``VersioningCfg``,
``ReplicationCfg``, ``AntiEntropyCfg``, ``TracingCfg`` and ``MeshCfg``
read the same environment variables with the same defaults and
validation. ``MeshCfg`` has one knob more, ``DFT_MESH_VIRTUAL``: the
port's counterpart of the JAX tests' forced host device count (see
``parallel/mesh.py`` ``make_mesh``).
"""

import json
import os

_SUPPORTED_METRICS = ("dot", "l2")

_SCHEMA = {
    "index_builder_type": None,
    "faiss_factory": None,
    "dim": 768,
    "train_num": 0,
    "train_ratio": 1.0,
    "centroids": 0,
    "metric": "dot",
    "nprobe": 1,
    "infer_centroids": False,
    "buffer_bsz": 50000,
    "save_interval_sec": -1,
    "index_storage_dir": None,
    "custom_meta_id_idx": 0,
}


class IndexCfg:
    """Keyword-constructed config; unrecognized keys land in ``self.extra``."""

    def __init__(self, **kwargs):
        for field, default in _SCHEMA.items():
            setattr(self, field, kwargs.pop(field, default))
        self.dim = int(self.dim)
        self.extra = dict(kwargs)

    def get_metric(self) -> str:
        """Validate and return the metric name ('dot' or 'l2')."""
        if self.metric not in _SUPPORTED_METRICS:
            raise RuntimeError("Only dot and l2 metrics are supported.")
        return self.metric

    @classmethod
    def from_json(cls, json_path: str) -> "IndexCfg":
        with open(json_path, "r") as f:
            kwargs = json.load(f)
        # round-trip support: a serialized cfg nests unknown keys under "extra"
        kwargs.update(kwargs.pop("extra", {}))
        return cls(**kwargs)

    def to_json_string(self) -> str:
        return json.dumps(self, default=lambda o: o.__dict__, sort_keys=True, indent=4)

    def save(self, json_path: str) -> None:
        with open(json_path, "w") as f:
            f.write(self.to_json_string())

    def __repr__(self) -> str:
        return f"<IndexCfg: {self.__dict__}>"


class _EnvCfg:
    """Keyword construction against a ``{field: (type, ENV_VAR, default)}``
    schema, unknown-kwarg rejection, ``from_env`` with the one bool
    convention ('0'/'false'/'' are False) and a ``_validate`` hook."""

    _SCHEMA: dict = {}
    _KIND = "env"

    def __init__(self, **kwargs):
        for field, (_, _, default) in self._SCHEMA.items():
            setattr(self, field, kwargs.pop(field, default))
        if kwargs:
            raise TypeError(f"unknown {self._KIND} knobs: {sorted(kwargs)}")
        self._validate()

    def _validate(self) -> None:
        pass

    @classmethod
    def from_env(cls, env=None):
        env = os.environ if env is None else env
        kwargs = {}
        for field, (typ, var, default) in cls._SCHEMA.items():
            raw = env.get(var)
            if raw is None:
                kwargs[field] = default
            elif typ is bool:
                kwargs[field] = raw not in ("0", "false", "False", "")
            else:
                kwargs[field] = typ(raw)
        return cls(**kwargs)

    def __repr__(self) -> str:
        return f"<{type(self).__name__}: {self.__dict__}>"


class SchedulerCfg(_EnvCfg):
    """Serving-scheduler knobs (queue bound, flush triggers, master switch)."""

    _SCHEMA = {
        # DFT_SCHEDULER=0 serves every search on its connection thread
        "enabled": (bool, "DFT_SCHEDULER", True),
        # flush when the pending compatible rows reach this many queries
        "max_batch_rows": (int, "DFT_SCHED_MAX_BATCH", 256),
        # ... or when the oldest queued request has waited this long
        "max_wait_ms": (float, "DFT_SCHED_MAX_WAIT_MS", 2.0),
        # admission bound: requests queued beyond this are rejected with BUSY
        "max_queue": (int, "DFT_SCHED_MAX_QUEUE", 512),
    }
    _KIND = "scheduler"

    def _validate(self) -> None:
        if self.max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")


_WIRE_ENCODINGS = ("binary", "pickle")


class WireCfg(_EnvCfg):
    """RPC wire-encoding knob (DFT_RPC_WIRE, default ``binary``): with
    ``binary`` a client advertises binary skeletons (parallel/wire.py) and a
    server answers an advertising connection's searches in them; ``pickle``
    keeps every frame a pickle skeleton, byte-identical to the pickle-only
    protocol. Parsed with the JAX package's rules, so a bad value fails
    fast the same way on both ends."""

    _SCHEMA = {"encoding": (str, "DFT_RPC_WIRE", "binary")}
    _KIND = "wire"

    def _validate(self) -> None:
        if self.encoding not in _WIRE_ENCODINGS:
            raise ValueError(
                f"wire encoding must be one of {_WIRE_ENCODINGS}, "
                f"got {self.encoding!r}")


class MutationCfg(_EnvCfg):
    """Mutable-corpora knobs, per rank (every engine on a rank shares the
    compaction policy): the background compaction watcher's switch, the
    tombstoned/indexed fraction that triggers it, and its wake interval."""

    _SCHEMA = {
        # 0 leaves tombstones masked until compact_index is called
        "compact": (bool, "DFT_COMPACT", True),
        "threshold": (float, "DFT_COMPACT_THRESHOLD", 0.25),
        "interval_s": (float, "DFT_COMPACT_INTERVAL", 5.0),
    }
    _KIND = "mutation"

    def _validate(self) -> None:
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError("compaction threshold must be in (0, 1]")
        if self.interval_s <= 0:
            raise ValueError("compaction interval must be > 0 seconds")


class VersioningCfg(_EnvCfg):
    """Per-id mutation versions: whether a client stamps its adds, upserts
    and deletes with hybrid-logical-clock versions (read by the client),
    and how many committed generations each shard retains for
    generation-pinned reads (read by the engine)."""

    _SCHEMA = {
        "enabled": (bool, "DFT_VERSIONING", True),
        "retain_generations": (int, "DFT_RETAIN_GENERATIONS", 2),
    }
    _KIND = "versioning"

    def _validate(self) -> None:
        if self.retain_generations < 2:
            # the prune floor is 2 whatever is asked (the crash-fallback pair)
            raise ValueError(
                "retain_generations must be >= 2 (the newest generation "
                "plus its crash-fallback predecessor are always kept)")


class ReplicationCfg(_EnvCfg):
    """Shard-replication knobs, read by the client: the replica count of
    each logical shard group, the write quorum (0 = majority), the bound
    on the under-replicated repair queue and the period of the optional
    repair loop (0 = off)."""

    _SCHEMA = {
        # replicas per group; 1 is one owner per shard
        "replication": (int, "DFT_REPLICATION", 1),
        # acks before a write reports success; 0 = majority (R // 2 + 1)
        "write_quorum": (int, "DFT_WRITE_QUORUM", 0),
        # records hold the batch payload, so this caps a client's memory
        "repair_queue_len": (int, "DFT_REPAIR_QUEUE", 256),
        # seconds between passes of the repair thread; 0 = no thread
        "repair_interval_s": (float, "DFT_REPAIR_INTERVAL", 0.0),
    }
    _KIND = "replication"

    def _validate(self) -> None:
        if self.replication < 1:
            raise ValueError("replication must be >= 1")
        if self.write_quorum < 0:
            raise ValueError("write_quorum must be >= 0 (0 = majority)")
        if self.write_quorum > self.replication:
            raise ValueError(
                f"write_quorum {self.write_quorum} cannot exceed the "
                f"replication factor {self.replication}")
        if self.repair_queue_len < 1:
            raise ValueError("repair_queue_len must be >= 1")
        if self.repair_interval_s < 0:
            raise ValueError("repair_interval_s must be >= 0 (0 = off)")


class AntiEntropyCfg(_EnvCfg):
    """Server-side anti-entropy knobs, per rank: the sweeper's switch and
    period, the failure detector's threshold, the compaction lease's
    liveness window, the delta-versus-full-sync bound, the digest exchange
    deadline and the minimum age of a prunable deletion-ledger entry."""

    _SCHEMA = {
        # the sweeper also needs a discovery file to resolve its peers
        "enabled": (bool, "DFT_ANTIENTROPY", True),
        "interval_s": (float, "DFT_ANTIENTROPY_INTERVAL", 2.0),
        # consecutive failed digest round trips before a peer is suspect
        "suspect_after": (int, "DFT_SUSPECT_AFTER", 3),
        # a peer silent longer than this stops counting for the lease
        "lease_ttl_s": (float, "DFT_COMPACT_LEASE_TTL", 10.0),
        # more missing rows than this heal by a full shard transfer
        "delta_max_rows": (int, "DFT_ANTIENTROPY_DELTA_MAX", 1024),
        "exchange_timeout_s": (float, "DFT_ANTIENTROPY_TIMEOUT", 5.0),
        # a client's repair queue may replay a pre-delete add this long
        # after the delete; younger ledger entries are never pruned
        "ledger_prune_age_s": (float, "DFT_LEDGER_PRUNE_AGE_S", 600.0),
    }
    _KIND = "antientropy"

    def _validate(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("antientropy interval must be > 0 seconds")
        if self.suspect_after < 1:
            raise ValueError("suspect_after must be >= 1")
        if self.lease_ttl_s <= 0:
            raise ValueError("lease_ttl_s must be > 0 seconds")
        if self.delta_max_rows < 1:
            raise ValueError("delta_max_rows must be >= 1")
        if self.exchange_timeout_s <= 0:
            raise ValueError("exchange_timeout_s must be > 0 seconds")
        if self.ledger_prune_age_s < 0:
            raise ValueError("ledger_prune_age_s must be >= 0 (0 = no "
                             "age bound)")


class TracingCfg(_EnvCfg):
    """Server-side observability knobs: the bound of each rank's span ring
    and the Prometheus listener's base port (rank r binds base + r; 0 = no
    listener). Sampling is decided on the client, per call, from
    ``DFT_TRACE_SAMPLE`` (observability/spans.py)."""

    _SCHEMA = {
        "buffer": (int, "DFT_TRACE_BUFFER", 2048),
        "metrics_port": (int, "DFT_METRICS_PORT", 0),
    }
    _KIND = "tracing"

    def _validate(self) -> None:
        if self.buffer < 1:
            raise ValueError("trace buffer must hold at least 1 span")
        if self.metrics_port < 0:
            raise ValueError("metrics port must be >= 0 (0 = off)")


# Deployment-side defaults for mesh-backed builders (parallel/mesh.py).
# Whether an index shards at all (``mesh_shards`` / ``shard_lists``) stays
# in cfg.extra and round-trips through snapshots; how a rank drives its
# devices is a per-host property these knobs fill in when cfg.extra does
# not pin it.

_MESH_MODES = ("masked", "routed")


class MeshCfg(_EnvCfg):
    """Per-host mesh serving knobs: the device count (0 = every visible
    device), the sharded-IVF serving mode ('masked' or 'routed'), and
    whether more shards than visible devices may share them round-robin
    (``virtual``)."""

    _SCHEMA = {
        "devices": (int, "DFT_MESH_DEVICES", 0),
        "mode": (str, "DFT_MESH_MODE", "masked"),
        "virtual": (bool, "DFT_MESH_VIRTUAL", False),
    }
    _KIND = "mesh"

    def _validate(self) -> None:
        self.devices = int(self.devices)
        if self.devices < 0:
            raise ValueError("mesh devices must be >= 0 (0 = all local)")
        if self.mode not in _MESH_MODES:
            raise ValueError(
                f"mesh mode must be one of {_MESH_MODES}, got {self.mode!r}")
