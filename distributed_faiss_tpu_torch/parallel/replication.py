"""Shard replication: membership, quorum math, the read plan and the repair
queue (counterpart of distributed_faiss_tpu/parallel/replication.py).

- ``assign_groups`` maps the discovery-file order onto logical shard
  GROUPS of replication factor R by modular striping: with N ranks and
  G = N // R groups, stub position p serves group ``p % G``, so killing any
  one rank leaves every group a live replica when R >= 2. A rank that
  registered a group (``DFT_SHARD_GROUP`` server-side, or the
  ``set_shard_group`` op) overrides the derived one.
- ``MembershipTable`` is the thread-safe group -> stub positions map the
  client reads per call; fan-out happens outside its lock.
- ``quorum_size`` is the write-ack contract: ``write_quorum`` if set, else
  a majority (R // 2 + 1). Replicas that missed an acknowledged write are
  recorded in the bounded ``RepairQueue``.
- ``plan_read_fanout`` picks one replica per group and the failover order.

R = 1 (the default) is one group per rank and quorum 1.
"""

import logging
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from distributed_faiss_tpu_torch.parallel import rpc
from distributed_faiss_tpu_torch.utils import lockdep
from distributed_faiss_tpu_torch.utils.state import (
    NOT_TRAINED_REJECTION_FMT,
    STALE_READ_REJECTION_PREFIX,
    IndexState,
)

logger = logging.getLogger()

# the engine's search refusal while a replica drains its add buffer (state
# ADD), matched in the remote traceback; narrow on purpose: a NOT_TRAINED
# refusal or bad arguments repeat on every replica and must raise
_DRAIN_REJECTION = NOT_TRAINED_REJECTION_FMT.format(state=IndexState.ADD)


def parse_discovery_lines(lines) -> Tuple[Optional[int], List[Tuple[str, int]]]:
    """``(advertised_count, [(host, port), ...])`` of a discovery file, the
    one parser of every reader (the client, the anti-entropy sweeper). The
    count is None when line 0 is missing or garbled; entries dedupe on
    first occurrence (a restarted rank re-appends its line) and garbled
    lines are skipped (a half-written append must never crash a reader)."""
    count: Optional[int] = None
    entries: List[Tuple[str, int]] = []
    seen = set()
    for idx, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        if idx == 0:
            try:
                count = int(line)
            except ValueError:
                count = None
            continue
        try:
            host, port = line.split(",")[:2]
            entry = (host.strip(), int(port))
        except ValueError:
            continue
        if entry not in seen:
            seen.add(entry)
            entries.append(entry)
    return count, entries


def drain_failover_eligible(exc: BaseException) -> bool:
    """True for a replica's refusal of a search while it drains its add
    buffer: the read path fails over to a peer instead of raising."""
    return isinstance(exc, rpc.ServerException) and _DRAIN_REJECTION in str(exc)


def stale_read_failover_eligible(exc: BaseException) -> bool:
    """True for a replica's refusal of a ``min_version`` search it has not
    caught up with: the write acked at quorum, so a peer of the group has
    it, and the read path walks there."""
    return (isinstance(exc, rpc.ServerException)
            and STALE_READ_REJECTION_PREFIX in str(exc))


def quorum_size(replication: int, write_quorum: int = 0) -> int:
    """Acks a replicated write needs: ``write_quorum`` when set (it must lie
    in [1, R]), else a majority, R // 2 + 1."""
    if replication < 1:
        raise ValueError("replication factor must be >= 1")
    if write_quorum:
        if not 1 <= write_quorum <= replication:
            raise ValueError(f"write_quorum {write_quorum} outside [1, {replication}]")
        return write_quorum
    return replication // 2 + 1


def assign_groups(num_ranks: int, replication: int) -> List[int]:
    """Derived group per stub position: G = num_ranks // R groups (>= 1),
    position p -> ``p % G``; when R does not divide N the extra ranks become
    extra replicas of the low groups."""
    if replication < 1:
        raise ValueError("replication factor must be >= 1")
    if num_ranks < 1:
        return []
    if replication > num_ranks:
        logger.warning("replication factor %d > %d ranks: clamping to %d",
                       replication, num_ranks, num_ranks)
        replication = num_ranks
    num_groups = max(1, num_ranks // replication)
    return [p % num_groups for p in range(num_ranks)]


class MembershipTable:
    """Thread-safe logical shard group -> replica positions (stub indexes
    in discovery order). Replica order within a group is registration
    order, the read path's failover order."""

    def __init__(self, groups_by_pos: List[int]):
        self._lock = lockdep.lock("MembershipTable._lock")
        self._group_of: Dict[int, int] = {}
        self._groups: Dict[int, List[int]] = {}
        for pos, gid in enumerate(groups_by_pos):
            self._groups.setdefault(int(gid), []).append(pos)
            self._group_of[pos] = int(gid)

    def groups(self) -> List[int]:
        with self._lock:
            return sorted(self._groups)

    def replicas(self, group: int) -> List[int]:
        with self._lock:
            return list(self._groups.get(group, ()))

    def group_of(self, pos: int) -> Optional[int]:
        with self._lock:
            return self._group_of.get(pos)

    def register(self, pos: int, group: int) -> None:
        """Move a position into ``group`` (a rank joining or rejoining)."""
        group = int(group)
        with self._lock:
            old = self._group_of.get(pos)
            if old == group:
                return
            self._drop_locked(pos, old)
            self._groups.setdefault(group, []).append(pos)
            self._group_of[pos] = group

    def remove(self, pos: int) -> None:
        """Take a position out of rotation (a rank leaving)."""
        with self._lock:
            self._drop_locked(pos, self._group_of.pop(pos, None))

    def _drop_locked(self, pos: int, group: Optional[int]) -> None:
        if group is not None and pos in self._groups.get(group, ()):
            self._groups[group].remove(pos)
            if not self._groups[group]:
                del self._groups[group]

    def snapshot(self) -> Dict[int, List[int]]:
        """{group: [positions]}, a copy to plan a fan-out on."""
        with self._lock:
            return {g: list(ps) for g, ps in self._groups.items()}

    def __repr__(self) -> str:
        return f"<MembershipTable {self.snapshot()}>"


def plan_read_fanout(membership: MembershipTable, preferred: Dict[int, int],
                     suspects=()) -> List[Tuple[int, int, List[int]]]:
    """One ``(group, chosen position, failover order)`` per group: the order
    is the group's replicas rotated so the pinned one (``preferred``, the
    last replica that answered) leads, with suspect positions moved to the
    tail, never dropped. One call per group reaches the merge, so a
    replicated row is never counted twice."""
    plan: List[Tuple[int, int, List[int]]] = []
    suspects = frozenset(suspects)
    for group, reps in sorted(membership.snapshot().items()):
        if not reps:
            continue
        pin = preferred.get(group)
        start = reps.index(pin) if pin in reps else 0
        ordering = reps[start:] + reps[:start]
        if suspects:
            ordering = ([p for p in ordering if p not in suspects]
                        + [p for p in ordering if p in suspects])
        plan.append((group, ordering[0], ordering))
    return plan


class RepairQueue:
    """Bounded record of under-replicated writes awaiting repair: each entry
    carries the payload and the positions that missed it. Past ``maxlen``
    the oldest record is dropped and counted (``dropped``, warned at most
    once a minute after the first); the server-side anti-entropy sweep is
    then what heals it."""

    DROP_WARN_INTERVAL_S = 60.0

    def __init__(self, maxlen: int = 256):
        self._lock = lockdep.lock("RepairQueue._lock")
        self._items = deque(maxlen=max(1, int(maxlen)))
        self._counters = {"recorded": 0, "repaired": 0, "dropped": 0}
        self._last_drop_warn = 0.0

    def record(self, entry: dict) -> None:
        warn = None
        with self._lock:
            if len(self._items) == self._items.maxlen:
                self._counters["dropped"] += 1
                now = time.monotonic()
                if (self._counters["dropped"] == 1
                        or now - self._last_drop_warn >= self.DROP_WARN_INTERVAL_S):
                    self._last_drop_warn = now
                    warn = (self._counters["dropped"], self._items.maxlen)
            self._items.append(entry)
            self._counters["recorded"] += 1
        if warn is not None:
            logger.warning(
                "repair queue full (maxlen=%d): dropped oldest under-replicated record "
                "(%d dropped so far); raise DFT_REPAIR_QUEUE, repair more often, or rely "
                "on the server-side anti-entropy sweep", warn[1], warn[0])

    def drain(self) -> List[dict]:
        """Pop every pending record; the repair pass re-records failures."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
        return items

    def mark_repaired(self, n: int = 1) -> None:
        with self._lock:
            self._counters["repaired"] += n

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["pending"] = len(self._items)
        return out
