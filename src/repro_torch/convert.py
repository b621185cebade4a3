"""Carry state from the JAX package into the port, as numpy arrays.

The hashing encoder's projection table (the forest itself is rebuilt from
the same sessions)::

    table = np.asarray(jax_encoder._table)
    enc = hashing_encoder_from_numpy(table, device="cuda")

A dense transformer's parameters::

    jax_params = get_model(cfg).init(jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree.map(np.asarray, jax_params), cfg, device="cuda")
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.encoder import HashingEncoder
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype


def hashing_encoder_from_numpy(table: np.ndarray, *, device=None,
                               max_batch: int = 1024) -> HashingEncoder:
    """A ``HashingEncoder`` whose projection table is ``table``
    ((buckets, dim) float32), on ``device``."""
    table = np.asarray(table)
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D, got shape {table.shape}")
    return HashingEncoder(dim=table.shape[1], max_batch=max_batch,
                          device=device, table=table)


def transformer_params_from_numpy(params: Dict[str, Any], cfg, *,
                                  device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's dense-transformer tree:
    ``embed`` (V, D), ``layers`` stacked along a leading layer axis,
    ``final_norm`` and ``unembed`` (absent when the embeddings are tied).

    Projections keep the JAX layout, (d_in, d_out), applied as ``x @ w``:
    nothing is transposed. The stacked layers become the port's list of
    per-layer dicts. Every tensor takes ``cfg.param_dtype``; a bf16 array
    arrives as numpy's bf16-compatible dtype or as float32, and either way
    holds the same values."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def t(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)    # numpy has no native bf16
        return torch.from_numpy(np.array(a, copy=True)).to(device=dev,
                                                            dtype=dtype)

    def layer(i: int, tree):
        if isinstance(tree, dict):
            return {k: layer(i, v) for k, v in tree.items()}
        return t(np.asarray(tree)[i])

    n = np.asarray(params["final_norm"]).shape
    if n != (cfg.d_model,):
        raise ValueError(f"final_norm has shape {n}, want ({cfg.d_model},)")
    out = {
        "embed": t(params["embed"]),
        "layers": [layer(i, params["layers"]) for i in range(cfg.num_layers)],
        "final_norm": t(params["final_norm"]),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = t(params["unembed"])
    return out
