"""Index lifecycle state machine (counterpart of
distributed_faiss_tpu/utils/state.py; reference
distributed_faiss/index_state.py:11-36).

Four states and the cluster-level aggregation lattice used by clients
polling a sharded index: TRAINING dominates, then NOT_TRAINED, then ADD,
else TRAINED.
"""

from enum import Enum
from typing import List

# The engine's search rejection while an index is not TRAINED (same text
# as the JAX package, so operators grep one message for both).
NOT_TRAINED_REJECTION_FMT = "Server index is not trained. state: {state}"

# The read-your-writes rejection of a replica that has not incorporated a
# search's ``min_version`` (same text as the JAX package).
STALE_READ_REJECTION_PREFIX = "Server replica has not applied version"
STALE_READ_REJECTION_FMT = (
    STALE_READ_REJECTION_PREFIX + " {version} (watermark: {watermark})")


class IndexState(Enum):
    NOT_TRAINED = 1
    TRAINING = 2
    ADD = 3
    TRAINED = 4

    @staticmethod
    def get_aggregated_states(states: List["IndexState"]) -> "IndexState":
        """Collapse per-server states into one cluster state: any TRAINING
        -> TRAINING; else any NOT_TRAINED -> NOT_TRAINED; else any ADD ->
        ADD; else TRAINED."""
        unique = set(states)
        if not unique:
            raise ValueError("cannot aggregate an empty state list")
        if len(unique) == 1:
            return unique.pop()
        if IndexState.TRAINING in unique:
            return IndexState.TRAINING
        if IndexState.NOT_TRAINED in unique:
            return IndexState.NOT_TRAINED
        if IndexState.ADD in unique:
            return IndexState.ADD
        return IndexState.TRAINED
