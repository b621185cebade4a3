"""Carry state from the JAX package into the port, as numpy arrays.

The hashing encoder's projection table (the forest itself is rebuilt from
the same sessions)::

    table = np.asarray(jax_encoder._table)
    enc = hashing_encoder_from_numpy(table, device="cuda")

A dense transformer's parameters::

    jax_params = get_model(cfg).init(jax.random.key(0))
    params = transformer_params_from_numpy(
        jax.tree.map(np.asarray, jax_params), cfg, device="cuda")

The MoE and VLM families take the same converter; zamba2's, rwkv6's and
whisper's parameters go the same way through ``zamba2_params_from_numpy``,
``rwkv6_params_from_numpy`` and ``whisper_params_from_numpy``. A whole train
state (parameters, AdamW moments and step, error state) goes through
``train_state_from_numpy``::

    state = train_state_from_numpy(jax.tree.map(np.asarray, jax_state), cfg,
                                   device="cuda")

and placed on a model mesh, as the reference's ``build_cell`` places it
(``launch.sharding.gather_tree`` gives the whole state back)::

    state = sharded_train_state_from_numpy(
        jax.tree.map(np.asarray, jax_state), cfg, mesh)

A serve cache of any family (the reference's leaf names), placed on a model
mesh by ``launch.sharding.cache_shardings``, beside its parameters placed by
``param_shardings``::

    cache = cache_from_numpy(jax.tree.map(np.asarray, jax_cache), cfg, mesh)
    params = place_tree(transformer_params_from_numpy(...), mesh,
                        param_shardings(mesh, ...))
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.encoder import HashingEncoder
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import cache_shardings, place_tree
from repro_torch.training.train_loop import shard_train_state


def hashing_encoder_from_numpy(table: np.ndarray, *, device=None,
                               max_batch: int = 1024) -> HashingEncoder:
    """A ``HashingEncoder`` whose projection table is ``table``
    ((buckets, dim) float32), on ``device``."""
    table = np.asarray(table)
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D, got shape {table.shape}")
    return HashingEncoder(dim=table.shape[1], max_batch=max_batch,
                          device=device, table=table)


def _tensor(a, device) -> torch.Tensor:
    """One leaf as a tensor on ``device``, in the leaf's own type. A bf16
    array arrives as numpy's bf16-compatible dtype (it becomes
    torch.bfloat16)."""
    a = np.asarray(a)
    bf16 = a.dtype.kind == "V" or a.dtype.name == "bfloat16"
    if bf16:
        a = a.astype(np.float32)    # numpy has no native bf16
    t = torch.from_numpy(np.array(a, copy=True)).to(device)
    return t.to(torch.bfloat16) if bf16 else t


def _tree(tree, device, index=None):
    """A dict tree of leaves as tensors; ``index`` picks one entry of a
    leading stacked axis."""
    if isinstance(tree, dict):
        return {k: _tree(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    return _tensor(a if index is None else a[index], device)


def _unstack(tree, n, device):
    """``n`` layers stacked along a leading axis -> the port's list of
    per-layer dicts."""
    return [_tree(tree, device, i) for i in range(n)]


def _check_final_norm(params, cfg) -> None:
    n = np.asarray(params["final_norm"]).shape
    if n != (cfg.d_model,):
        raise ValueError(f"final_norm has shape {n}, want ({cfg.d_model},)")


def transformer_params_from_numpy(params: Dict[str, Any], cfg, *,
                                  device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's transformer tree (the
    dense, MoE and VLM families): ``embed`` (V, D), ``layers`` stacked along
    a leading layer axis, ``final_norm`` and ``unembed`` (absent when the
    embeddings are tied).

    Projections keep the JAX layout, (d_in, d_out), applied as ``x @ w``:
    nothing is transposed. The stacked layers become the port's list of
    per-layer dicts. Every leaf keeps its own type: an MoE layer's router is
    float32 whatever ``cfg.param_dtype`` is."""
    dev = resolve_device(device)
    _check_final_norm(params, cfg)
    out = {
        "embed": _tensor(params["embed"], dev),
        "layers": _unstack(params["layers"], cfg.num_layers, dev),
        "final_norm": _tensor(params["final_norm"], dev),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = _tensor(params["unembed"], dev)
    return out


def zamba2_params_from_numpy(params: Dict[str, Any], cfg, *,
                             device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's zamba2 tree: ``embed``,
    ``layers`` (stacked; becomes a list of per-layer ``{"ln", "mamba"}``
    dicts), ``shared_attn`` (stays one dict), ``final_norm``, ``unembed``.
    Nothing is transposed. Unlike the dense converter, every leaf keeps its
    own type: ``A_log``, ``dt_bias`` and ``D_skip`` are float32 whatever
    ``cfg.param_dtype`` is."""
    dev = resolve_device(device)
    _check_final_norm(params, cfg)
    return {
        "embed": _tensor(params["embed"], dev),
        "layers": _unstack(params["layers"], cfg.num_layers, dev),
        "shared_attn": _tree(params["shared_attn"], dev),
        "final_norm": _tensor(params["final_norm"], dev),
        "unembed": _tensor(params["unembed"], dev),
    }


def rwkv6_params_from_numpy(params: Dict[str, Any], cfg, *,
                            device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's rwkv6 tree: ``embed``,
    ``ln_in``, ``layers`` (stacked; becomes a list of per-layer dicts),
    ``final_norm``, ``unembed``. Nothing is transposed, and every leaf keeps
    its own type."""
    dev = resolve_device(device)
    _check_final_norm(params, cfg)
    return {
        "embed": _tensor(params["embed"], dev),
        "ln_in": _tensor(params["ln_in"], dev),
        "layers": _unstack(params["layers"], cfg.num_layers, dev),
        "final_norm": _tensor(params["final_norm"], dev),
        "unembed": _tensor(params["unembed"], dev),
    }


def whisper_params_from_numpy(params: Dict[str, Any], cfg, *,
                              device=None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's whisper tree:
    ``embed``, ``enc_layers`` and ``dec_layers`` (stacked; each becomes a
    list of per-layer dicts, ``cfg.encoder_layers`` and ``cfg.num_layers``
    of them), and the final layer norms with their biases. Nothing is
    transposed, and every leaf keeps its own type."""
    dev = resolve_device(device)
    out = {
        "embed": _tensor(params["embed"], dev),
        "enc_layers": _unstack(params["enc_layers"], cfg.encoder_layers,
                               dev),
        "dec_layers": _unstack(params["dec_layers"], cfg.num_layers, dev),
    }
    for name in ("enc_norm", "enc_norm_b", "dec_norm", "dec_norm_b"):
        out[name] = _tensor(params[name], dev)
    return out


_PARAM_CONVERTERS = {"dense": transformer_params_from_numpy,
                     "moe": transformer_params_from_numpy,
                     "vlm": transformer_params_from_numpy,
                     "hybrid": zamba2_params_from_numpy,
                     "ssm": rwkv6_params_from_numpy,
                     "encdec": whisper_params_from_numpy}


def train_state_from_numpy(state: Dict[str, Any], cfg, *,
                           device=None) -> Dict[str, Any]:
    """The port's train state from the JAX package's (``init_train_state``
    or a trained one) as numpy arrays: ``params``, ``opt`` (``m`` and ``v``,
    float32 with the parameters' tree, and the int32 ``step``) and, with
    gradient compression, ``err`` (float32, the parameters' tree). The
    moments and the error state go through the family's parameter
    converter, since they have the parameters' tree."""
    dev = resolve_device(device)
    conv = _PARAM_CONVERTERS[cfg.family]
    out = {"params": conv(state["params"], cfg, device=dev),
           "opt": {"m": conv(state["opt"]["m"], cfg, device=dev),
                   "v": conv(state["opt"]["v"], cfg, device=dev),
                   "step": _tensor(state["opt"]["step"], dev)}}
    if "err" in state:
        out["err"] = conv(state["err"], cfg, device=dev)
    return out


def sharded_train_state_from_numpy(state: Dict[str, Any], cfg,
                                   mesh) -> Dict[str, Any]:
    """``train_state_from_numpy`` on the CPU, then placed on ``mesh`` by
    ``training.train_loop.shard_train_state`` (the parameters by
    ``param_shardings`` with ``cfg.moe_fsdp_params``, the moments by
    ``zero1_shardings``)."""
    whole = train_state_from_numpy(state, cfg, device="cpu")
    return shard_train_state(whole, mesh, cfg)


def cache_from_numpy(cache: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """A serve cache (numpy leaves, each in its own type: bf16 caches,
    float32 states, int32 ``lengths``) placed on ``mesh`` leaf by leaf by
    ``launch.sharding.cache_shardings``: a dict of ``Sharded``."""
    whole = _tree(cache, "cpu")
    return place_tree(whole, mesh, cache_shardings(cfg, mesh, whole))
