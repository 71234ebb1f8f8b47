"""Tombstone bookkeeping and the crash-safe sidecar protocol (counterpart of
distributed_faiss_tpu/mutation/tombstones.py; the payload is its format 2,
written with the same ``json.dumps`` call, so the bytes are the same and
each package loads the other's sidecars).

A :class:`TombstoneSet` is the engine's record of the deleted rows of one
shard: a ``row -> metadata id`` map (rows are the positions the metadata
join is keyed on), a position-free deletion ledger of every id ever
deleted, the per-id live and delete versions the last-writer-wins gates
compare, and a layout epoch. The set is plain data; the owning engine
guards it under ``index_lock``, the lock every device search holds, so a
coalesced search window sees one tombstone snapshot.

Durability:

- every committed MANIFEST generation carries a ``tombstones-gNNNNNNNN.json``
  file (sha256-checked like the others) with the set and the layout epoch
  its positions are valid for;
- every mutation rewrites the standalone ``tombstones.json`` (tmp + fsync +
  rename), so a delete is durable when ``remove_ids`` returns.

Compaction renumbers rows, which is what the layout epoch is for: a load
applies the generation's own payload, and merges the standalone sidecar
positionally only when its layout matches; otherwise the engine re-applies
the sidecar's deletes by id (engine._apply_sidecar_by_id).
"""

import json
import logging
import os
from typing import Dict, Iterable, Optional

from distributed_faiss_tpu_torch.mutation import versions as _versions
from distributed_faiss_tpu_torch.utils import serialization

logger = logging.getLogger()

SIDECAR_NAME = "tombstones.json"

# format 2: the ledger carries per-id delete versions (``dead_versions``)
# and the payload the per-id live write versions (``live_versions``); a
# format-1 payload loads with every version None
PAYLOAD_FORMAT = 2


def id_match_key(v):
    """A metadata id normalized for matching across layouts and JSON round
    trips (which turn tuples into lists): tuples all the way down, or the
    id's ``str`` for what JSON cannot hold."""
    if isinstance(v, (list, tuple)):
        return tuple(id_match_key(e) for e in v)
    if isinstance(v, (int, float, str, bool)):
        return v
    return str(v)


class TombstoneSet:
    """Positional dead-row set with the id-keyed record beside it.

    Besides the ``row -> id`` map, which compaction clears as it reclaims
    the rows, the set keeps the deletion ledger: the ``id_match_key`` of
    every id ever deleted here, with the delete's version. It survives
    compaction and rides in every payload; a legal re-add of an id
    (upsert) removes its entry."""

    __slots__ = ("_rows", "layout", "_ledger", "_live_versions")

    def __init__(self, rows: Optional[Dict[int, object]] = None,
                 layout: int = 0, ledger=None,
                 seed_ledger_from_rows: bool = True):
        self._rows: Dict[int, object] = (
            {int(r): v for r, v in rows.items()} if rows else {})
        self.layout = int(layout)
        # normalized id -> version of its delete (None: unversioned)
        self._ledger: Dict[object, object] = {}
        for k in ledger or ():
            self._ledger.setdefault(id_match_key(k), None)
        # normalized id -> version of the last versioned write that made it
        # live here; unversioned adds leave no entry
        self._live_versions: Dict[object, object] = {}
        # a payload that carries a ledger is authoritative (an upserted id
        # is unledgered while its old row stays dead until compaction);
        # only direct construction and pre-ledger payloads seed from rows
        if seed_ledger_from_rows:
            for v in self._rows.values():
                if v is not None:
                    self._ledger.setdefault(id_match_key(v), None)

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, row: int) -> bool:
        return int(row) in self._rows

    def rows(self) -> list:
        """Dead row positions (a copy, safe outside the lock)."""
        return list(self._rows)

    def ids(self) -> list:
        """Metadata ids of the dead rows (a copy)."""
        return list(self._rows.values())

    def items(self) -> list:
        """(row, metadata id) pairs (a copy)."""
        return list(self._rows.items())

    def add(self, rows: Iterable[int], ids: Optional[Iterable] = None,
            version=None) -> None:
        """Record dead rows; ``version`` stamps the ledger entries of their
        ids (the delete's version; None keeps the unversioned entry)."""
        if ids is None:
            for r in rows:
                self._rows.setdefault(int(r), None)
            return
        version = _versions.version_key(version)
        for r, i in zip(rows, ids):
            self._rows[int(r)] = i
            if i is not None:
                k = id_match_key(i)
                self._ledger[k] = _versions.newest(self._ledger.get(k), version)

    # ------------------------------------------------------ deletion ledger

    def ledger(self) -> frozenset:
        """Normalized ids of every delete recorded here (a copy)."""
        return frozenset(self._ledger)

    def ledger_size(self) -> int:
        return len(self._ledger)

    def ledger_version(self, key):
        """The recorded delete version of one id (None when unledgered or
        ledgered unversioned; the gates treat both as minimal)."""
        return self._ledger.get(id_match_key(key))

    def ledger_items(self) -> list:
        """(normalized id, delete version) pairs (a copy)."""
        return list(self._ledger.items())

    def ledger_update(self, keys: Iterable) -> int:
        """Record unversioned deletes a peer observed; returns how many ids
        were new."""
        before = len(self._ledger)
        for k in keys:
            self._ledger.setdefault(id_match_key(k), None)
        return len(self._ledger) - before

    def ledger_update_versioned(self, pairs: Iterable) -> int:
        """Record ``(id, version)`` deletes; versions max-merge, so an older
        replayed delete never rolls a newer one back. Returns how many ids
        were new."""
        before = len(self._ledger)
        for k, v in pairs:
            kk = id_match_key(k)
            self._ledger[kk] = _versions.newest(self._ledger.get(kk),
                                                _versions.version_key(v))
        return len(self._ledger) - before

    def prune_ledger(self, min_version, max_wall_ms=None) -> int:
        """Drop the entries whose delete version is strictly below
        ``min_version`` (the lowest replica watermark of the group: every
        replica has incorporated the delete) and, with ``max_wall_ms``, whose
        wall-clock part is at most that: a client's repair queue may still
        replay an add the entry gates. Unversioned entries are never pruned.
        Returns the entries dropped."""
        mk = _versions.version_key(min_version)
        if mk is None:
            return 0
        victims = [k for k, v in self._ledger.items()
                   if v is not None and _versions.compare(v, mk) < 0
                   and (max_wall_ms is None or v[0] <= max_wall_ms)]
        for k in victims:
            del self._ledger[k]
        return len(victims)

    def unledger(self, keys: Iterable) -> int:
        """Drop the ledger entries of legally re-added ids; returns how
        many were there."""
        hit = 0
        for k in keys:
            kk = id_match_key(k)
            if kk in self._ledger:
                del self._ledger[kk]
                hit += 1
        return hit

    # ---------------------------------------------------- live versions

    def live_version(self, key):
        return self._live_versions.get(id_match_key(key))

    def set_live_version(self, key, version) -> None:
        self._live_versions[id_match_key(key)] = _versions.version_key(version)

    def drop_live_version(self, key) -> None:
        self._live_versions.pop(id_match_key(key), None)

    def live_versions(self) -> list:
        """(normalized id, version) pairs (a copy)."""
        return list(self._live_versions.items())

    def live_versions_update(self, pairs: Iterable) -> None:
        """Max-merge (id, version) pairs in."""
        for k, v in pairs:
            kk = id_match_key(k)
            self._live_versions[kk] = _versions.newest(
                self._live_versions.get(kk), _versions.version_key(v))

    def max_version(self):
        """The newest version recorded anywhere in the set (None when
        nothing versioned was applied)."""
        out = None
        for v in list(self._ledger.values()) + list(self._live_versions.values()):
            out = _versions.newest(out, v)
        return out

    def count_below(self, n: int) -> int:
        """Dead rows at positions < n (the indexed ones)."""
        return sum(1 for r in self._rows if r < n)

    def rows_in_range(self, lo: int, hi: int) -> list:
        """Dead positions in [lo, hi): the buffer-drain mask window."""
        return [r for r in self._rows if lo <= r < hi]

    def to_payload(self) -> dict:
        rows = sorted(self._rows)
        return {
            "format": PAYLOAD_FORMAT,
            "layout": self.layout,
            "dead_rows": rows,
            "dead_ids": [self._rows[r] for r in rows],
            # dead_ledger keeps the format-1 shape (bare ids); the versions
            # ride beside it
            "dead_ledger": sorted(self._ledger, key=repr),
            "dead_versions": sorted(
                ([k, v] for k, v in self._ledger.items() if v is not None),
                key=repr),
            "live_versions": sorted(
                ([k, v] for k, v in self._live_versions.items()
                 if v is not None), key=repr),
        }

    @classmethod
    def from_payload(cls, payload: Optional[dict]) -> "TombstoneSet":
        if not payload:
            return cls()
        rows = [int(r) for r in payload.get("dead_rows", ())]
        mapping = dict.fromkeys(rows)
        for r, i in zip(rows, payload.get("dead_ids", ())):
            mapping[r] = i
        out = cls(mapping, layout=int(payload.get("layout", 0)),
                  ledger=payload.get("dead_ledger", ()),
                  seed_ledger_from_rows="dead_ledger" not in payload)
        out.ledger_update_versioned(payload.get("dead_versions", ()))
        out.live_versions_update(payload.get("live_versions", ()))
        return out

    def merge_payload(self, payload: Optional[dict]) -> None:
        """Union another payload of the same layout in."""
        if not payload:
            return
        other = TombstoneSet.from_payload(payload)
        for r, i in other._rows.items():
            self._rows.setdefault(r, i)
        for k, v in other._ledger.items():
            self._ledger[k] = _versions.newest(self._ledger.get(k), v)
        self.live_versions_update(other._live_versions.items())

    def __repr__(self) -> str:
        return f"<TombstoneSet {len(self._rows)} dead, layout {self.layout}>"


def dump_payload(payload: dict) -> str:
    """JSON text of a payload. ``default=str`` keeps an id object JSON
    cannot hold from failing the dump; the positions are the recovery
    key."""
    return json.dumps(payload, default=str, sort_keys=True)


def write_sidecar(storage_dir: str, payload: dict) -> None:
    """Rewrite the standalone sidecar atomically (tmp + fsync + rename)."""
    serialization.atomic_write(
        os.path.join(storage_dir, SIDECAR_NAME),
        lambda f: f.write(dump_payload(payload) + "\n"), "w")


def load_sidecar(storage_dir: str) -> Optional[dict]:
    path = os.path.join(storage_dir, SIDECAR_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        # atomic_write cannot tear it; garbage reads as absent, loudly (the
        # generation's own payload still covers recovery to its commit)
        logger.warning("unreadable tombstone sidecar at %s: %s", path, e)
        return None


def load_generation_payload(storage_dir: str, manifest: dict) -> Optional[dict]:
    """The committed generation's own tombstone payload (None for a
    generation committed without one)."""
    entry = manifest.get("files", {}).get("tombstones")
    if not entry:
        return None
    try:
        with open(os.path.join(storage_dir, entry["name"])) as f:
            return json.load(f)
    except (OSError, ValueError):
        # verify_manifest checked its sha256; a failure here is later
        # corruption, and the standalone sidecar takes over
        return None
