"""Carry state from the JAX package into the port.

This system's only learned-looking state is the hashing encoder's projection
table; the forest itself is rebuilt from the same sessions. Pass the JAX
encoder's table as numpy, e.g.::

    table = np.asarray(jax_encoder._table)
    enc = hashing_encoder_from_numpy(table, device="cuda")
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.encoder import HashingEncoder


def hashing_encoder_from_numpy(table: np.ndarray, *, device=None,
                               max_batch: int = 1024) -> HashingEncoder:
    """A ``HashingEncoder`` whose projection table is ``table``
    ((buckets, dim) float32), on ``device``."""
    table = np.asarray(table)
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D, got shape {table.shape}")
    return HashingEncoder(dim=table.shape[1], max_batch=max_batch,
                          device=device, table=table)
