"""Carrying index state between the JAX package and the port.

A model ``state_dict`` in either package is a flat dict of numpy arrays and
json-able scalars with the same keys (IVF-Flat: rows in insertion order +
the coarse assignment vector + optional stored norms / sq8 params / refine
rows; IVF-PQ: the uint8 codes in insertion order + the assignment vector,
the coarse centroids, the PQ codebooks, optional refine rows and the
knobs; flat: the stored rows; pre-transform: the matrix, the mean and the
fit flags beside the inner index's own keys under ``inner.``), so it does
not depend on either package's device layout. ``from_jax_state`` turns
such a dict — arrays may be any array-like, e.g. device arrays, scalars
Python or numpy scalars — into the port's index on ``device``;
``to_state_dict`` writes the port's index back to the same keys. The npz
files written by ``utils.serialization.save_state`` in either package load
in the other through ``index_from_state_dict``.
"""

import numpy as np

from distributed_faiss_tpu_torch.models.factory import index_from_state_dict

_SCALARS = (str, bytes, bool, int, float, np.generic)


def from_jax_state(state: dict, device="cuda"):
    """JAX-package ``state_dict`` -> the port's index model."""
    # np.array copies: a JAX array's host view is read-only, and torch
    # wants writable buffers
    plain = {k: (v if isinstance(v, _SCALARS) or not hasattr(v, "__array__")
                 else np.array(v))
             for k, v in state.items()}
    return index_from_state_dict(plain, device=device)


def to_state_dict(index) -> dict:
    """The port's index -> a state_dict the JAX package's
    ``index_from_state_dict`` accepts."""
    return index.state_dict()
