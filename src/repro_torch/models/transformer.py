"""Decoder-only LM, the dense, MoE and VLM families: init, trunk, the train
loss, prefill and decode.

Counterpart of the JAX package's ``models/transformer.py``. Parameters are a
dict: ``embed`` (V, D), ``layers`` (a list with one dict per layer: ``ln1``,
``ln2``, ``attn``, and ``mlp``, or ``moe`` for the MoE family),
``final_norm`` and, unless the embeddings are tied, ``unembed`` (D, V). The
JAX package stacks the layers along a leading axis for ``lax.scan``; here a
Python loop walks the list. ``sharded_loss_fn``, ``sharded_prefill`` and
``sharded_decode_step`` are the train loss and serve on a model mesh, the
parameters placed by ``launch.sharding.param_shardings`` and the cache by
``launch.sharding.cache_shardings``. The VLM
family's batches may carry
``patch_embeds`` (B, P, D), prepended to the token embeddings at prefill
(positions and the cache's ``lengths`` count them); decode ignores them.

The KV cache is a dict ``{"k", "v": (L, B, max_len, Hkv, Dh) in cfg.dtype,
"lengths": (B,) int32}`` on the parameters' device. ``decode_step`` writes
the new K/V rows into it IN PLACE and returns a dict with the same ``k`` and
``v`` tensors and new ``lengths``; a caller that keeps an older cache dict
must clone it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (P, axes_of, cache_shardings,
                                         data_sharding, shard_region)
from repro_torch.models import layers as L

FAMILIES = ("dense", "moe", "vlm")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card), with the reference's distributions: dense
    normal * 1/sqrt(d_in), embeddings normal * 0.02, norms ones; an MoE
    layer's router in float32 and its experts normal * 1/sqrt(d_in)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.family}: models.transformer builds the "
                         f"{', '.join(FAMILIES)} families; get_model(cfg) "
                         "picks the module of a family")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg.param_dtype)

    def layer():
        p = {"ln1": torch.ones(cfg.d_model, dtype=dtype, device=dev),
             "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
             "attn": L.attn_init(gen, cfg, dtype)}
        if cfg.family == "moe":
            p["moe"] = L.moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = L.mlp_init(gen, cfg, dtype)
        return p

    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype)
    return params


# ---------------------------------------------------------------------------
# shared trunk
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, p, h):
    """The layer's MLP or MoE block: (out, aux loss or None without
    experts)."""
    if cfg.family == "moe":
        return L.moe_block(p["moe"], h, cfg)
    return L.mlp_block(p["mlp"], h, cfg), None


def _layer_fwd(cfg: ModelConfig, p, x, positions, *, return_kv=False):
    """One layer over (B, S, D): (x, aux, and (k, v) if ``return_kv``)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    att = L.attention_prefill(p["attn"], h, cfg, positions,
                              return_kv=return_kv)
    if return_kv:
        att, kv = att
    x = x + att
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(cfg, p, h)
    return (x + y, aux, kv) if return_kv else (x + y, aux)


def trunk(params, cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor, *, remat: bool = False):
    """x: (B, S, D) embeddings -> (hidden (B, S, D), aux_loss): the MoE
    layers' aux losses summed in float32, 0 for the other families. With
    ``remat`` each layer runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): its activations are recomputed in the
    backward pass instead of kept."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        if remat:
            x, aux = checkpoint(_layer_fwd, cfg, p, x, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _layer_fwd(cfg, p, x, positions)
        if aux is not None:
            total = total + aux
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), total


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["unembed"]
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _embed_batch(params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embedding, (B, S) ids -> (B, S, D); for the VLM family the
    batch's ``patch_embeds`` (B, P, D) go in front: (B, P + S, D)."""
    x = params["embed"][batch["tokens"]]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# train loss
# ---------------------------------------------------------------------------
def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent", "aux"}): the token cross-entropy over ``labels`` (B,
    S) (and ``loss_mask`` when the batch has one) plus 0.01 x the MoE
    layers' aux loss. A VLM batch's patch positions are dropped before the
    logits. ``cfg.remat`` recomputes each layer in the backward pass."""
    x = _embed_batch(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    h, aux = trunk(params, cfg, x, positions, remat=cfg.remat)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        h = h[:, batch["patch_embeds"].shape[1]:]
    logits = _logits(params, cfg, h)
    loss = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# train loss on a model mesh
# ---------------------------------------------------------------------------
def _layer_shards(cfg: ModelConfig, p, xs, positions, mesh: Mesh,
                  batch_axes):
    """One layer at every position: (x, aux per position or None)."""
    hs = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, p["ln1"].parts)]
    att = L.attention_prefill_shards(p["attn"], hs, cfg, positions, mesh)
    xs = spmd.each(torch.add, xs, att)
    hs = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, p["ln2"].parts)]
    if cfg.family == "moe":
        ys, aux = L.moe_block_shards(p["moe"], hs, cfg, mesh, batch_axes)
    else:
        ys, aux = L.mlp_block_shards(p["mlp"], hs, cfg, mesh), None
    return spmd.each(torch.add, xs, ys), aux


def _layer_call(cfg: ModelConfig, p, xs, positions, mesh: Mesh, batch_axes):
    """``_layer_shards``, under ``spmd.remat`` when ``cfg.remat``
    (``layers.layer_call``): (x, aux per position or None)."""
    def run(q, ys):
        out, aux = _layer_shards(cfg, q, ys, positions, mesh, batch_axes)
        return out + (aux or [])

    out = L.layer_call(run, p, xs, cfg.remat)
    n = len(xs)
    return out[:n], (out[n:] or None)


def sharded_loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    mesh: Mesh):
    """``loss_fn`` on ``mesh`` -> (loss, {"xent", "aux"}), 0-d tensors on
    the mesh's first device. ``params`` is a tree of ``Sharded`` (any
    placement the sharding rules give); ``batch`` holds whole tensors, split
    over the data axes by ``data_sharding`` (replicated when their width
    does not divide B). Each layer runs per shard (``models.layers``'
    ``*_shards``); the embedding lookup is vocab-split with a ``psum`` over
    ``model``; the logits stay split by vocab over ``model`` and the
    cross-entropy takes the log-sum-exp across the shards; the mean runs
    over the whole batch; aux is summed over the layers. ``cfg.remat``
    recomputes each layer, its collectives included, in the backward pass
    (``spmd.remat``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.family}: sharded_loss_fn trains the "
                         f"{', '.join(FAMILIES)} families")
    B = batch["tokens"].shape[0]
    spec = data_sharding(mesh, 1, B).spec
    batch_axes = axes_of(spec[0])

    def body(params, batch):
        x = L.embed_shards(params["embed"], batch["tokens"].parts)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = spmd.each(lambda pe, e: torch.cat([pe.to(e.dtype), e], dim=1),
                          batch["patch_embeds"].parts, x)
        S = x[0].shape[1]
        positions = spmd.each(lambda d: torch.arange(S, device=d)[None, :],
                              mesh.devices)
        aux = spmd.each(lambda d: torch.zeros((), dtype=torch.float32,
                                              device=d), mesh.devices)
        for p in params["layers"]:
            x, a = _layer_call(cfg, p, x, positions, mesh, batch_axes)
            if a is not None:
                aux = spmd.each(torch.add, aux, a)
        h = [L.rms_norm(t, g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        if cfg.family == "vlm" and "patch_embeds" in batch:
            h = [t[:, batch["patch_embeds"].shape[1]:] for t in h]
        logits, split = L.logits_shards(params, cfg, h)
        masks = batch["loss_mask"].parts if "loss_mask" in batch else None
        xent = L.softmax_xent_shards(logits, batch["labels"].parts, masks,
                                     mesh, split, batch_axes)
        loss = spmd.each(lambda x, a: x + 0.01 * a, xent, aux)
        return loss, xent, aux

    loss, xent, aux = spmd.shard_map(body, mesh, (None, spec),
                                     (P(), P(), P()))(params, batch)
    return loss.parts[0], {"xent": xent.parts[0], "aux": aux.parts[0]}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dtype = L.torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }



def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Full-sequence forward; returns (last logits (B, V), cache). The
    cache is ``max_len`` wide (``S`` if the prompt is longer, as the
    reference pads only up to ``max_len``). S counts a VLM batch's
    patches."""
    x = _embed_batch(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, B, max(max_len, S), device=x.device)
    for i, p in enumerate(params["layers"]):
        x, _, (k, v) = _layer_fwd(cfg, p, x, positions, return_kv=True)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h[:, -1])
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One-token decode. batch: {"tokens": (B,) int} (a VLM batch's
    patches are ignored). Returns (logits (B, V), cache with the new rows
    written in place and lengths + 1)."""
    x = params["embed"][batch["tokens"]]           # (B, D)
    lengths = cache["lengths"]
    for i, p in enumerate(params["layers"]):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        att, _, _ = L.attention_decode(p["attn"], h, cfg, cache["k"][i],
                                       cache["v"][i], lengths)
        x = x + att
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        y, _ = _ffn(cfg, p, h[:, None, :])
        x = x + y[:, 0]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}


# ---------------------------------------------------------------------------
# serving on a model mesh
# ---------------------------------------------------------------------------
def _serve_layout(params, cfg: ModelConfig, B: int, mesh: Mesh, what: str):
    """``layers.serve_layout`` for the families this module serves."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.family}: {what} serves the "
                         f"{', '.join(FAMILIES)} families")
    return L.serve_layout(params, cfg, B, mesh, what)


def _ffn_shards(cfg: ModelConfig, p, hs, mesh: Mesh, batch_axes):
    if cfg.family == "moe":
        return L.moe_block_shards(p["moe"], hs, cfg, mesh, batch_axes)[0]
    return L.mlp_block_shards(p["mlp"], hs, cfg, mesh)


def sharded_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    max_len: int, mesh: Mesh):
    """``prefill`` on ``mesh`` -> (last logits, cache). ``params`` is a tree
    of ``Sharded`` (``param_shardings``' placement, any ``kv_heads``);
    ``batch`` holds whole tensors, split over the data axes as
    ``data_sharding`` splits them (replicated when their width does not
    divide B). S counts a VLM batch's patches, and the cache is
    max(max_len, S) rows wide, as unsharded. Each layer runs per shard; each
    position keeps what ``launch.sharding.cache_shardings`` gives it of K and
    V (its KV-head block, or its rows of every KV head), zero-padded past S.
    Returns the logits as a ``Sharded`` (B, V), split over the data axes and
    by vocab over ``model`` (``launch.sharding.gather`` gives them whole),
    and the cache as a dict of ``Sharded`` with the reference's leaf names,
    ``lengths`` (B,) split over the data axes."""
    B = batch["tokens"].shape[0]
    spec, batch_axes, logit_spec = _serve_layout(params, cfg, B, mesh,
                                                 "sharded_prefill")
    vlm = cfg.family == "vlm" and "patch_embeds" in batch
    S = batch["tokens"].shape[1] + (batch["patch_embeds"].shape[1]
                                    if vlm else 0)
    Smax = max(max_len, S)
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.head_dim)
    cache_sh = cache_shardings(cfg, mesh, {
        "k": torch.empty(shape, device="meta"),
        "lengths": torch.empty((B,), dtype=torch.int32, device="meta")})
    k_spec, len_spec = cache_sh["k"].spec, cache_sh["lengths"].spec
    dtype = L.torch_dtype(cfg.dtype)

    def body(params, batch):
        x = L.embed_shards(params["embed"], batch["tokens"].parts)
        if vlm:
            x = spmd.each(lambda pe, e: torch.cat([pe.to(e.dtype), e], dim=1),
                          batch["patch_embeds"].parts, x)
        positions = spmd.each(lambda d: torch.arange(S, device=d)[None, :],
                              mesh.devices)
        regions = [shard_region(shape, k_spec, mesh, pos)
                   for pos in range(mesh.size)]
        ks = spmd.each(lambda reg, d: torch.zeros(
            tuple(r.stop - r.start for r in reg), dtype=dtype, device=d),
            regions, mesh.devices)
        vs = [torch.zeros_like(t) for t in ks]
        for i, p in enumerate(params["layers"]):
            hs = [L.rms_norm(t, g, cfg.norm_eps)
                  for t, g in zip(x, p["ln1"].parts)]
            att, kvs = L.attention_prefill_shards(p["attn"], hs, cfg,
                                                  positions, mesh,
                                                  return_kv=True)
            for pos, (k, v) in enumerate(kvs):
                ks[pos][i] = L.kv_block(k, regions[pos], S,
                                        cfg.num_kv_heads)
                vs[pos][i] = L.kv_block(v, regions[pos], S,
                                        cfg.num_kv_heads)
            x = spmd.each(torch.add, x, att)
            hs = [L.rms_norm(t, g, cfg.norm_eps)
                  for t, g in zip(x, p["ln2"].parts)]
            x = spmd.each(torch.add, x, _ffn_shards(cfg, p, hs, mesh,
                                                    batch_axes))
        h = [L.rms_norm(t[:, -1], g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, _ = L.logits_shards(params, cfg, h)
        lengths = spmd.each(lambda t: torch.full(
            (t.shape[0],), S, dtype=torch.int32, device=t.device), h)
        return logits, ks, vs, lengths

    logits, k, v, lengths = spmd.shard_map(
        body, mesh, (None, spec), (logit_spec, k_spec, k_spec, len_spec))(
            params, batch)
    return logits, {"k": k, "v": v, "lengths": lengths}


def sharded_decode_step(params, cfg: ModelConfig,
                        batch: Dict[str, torch.Tensor], cache, mesh: Mesh):
    """``decode_step`` on ``mesh`` -> (logits, cache). ``batch``: {"tokens":
    (B,)} whole (a VLM batch's patches are ignored); ``cache``: the dict of
    ``Sharded`` that ``sharded_prefill`` returns or that
    ``launch.sharding.cache_shardings`` places. Each layer writes its new K/V
    row IN PLACE and runs ``layers.attention_decode_shards`` (the heads or
    the sequence form, as the cache is laid out); an MoE layer takes each
    data shard's (B_local, 1, D) tokens. Returns the logits as
    ``sharded_prefill`` does and the cache with the same ``k`` and ``v`` and
    lengths + 1."""
    B = batch["tokens"].shape[0]
    spec, batch_axes, logit_spec = _serve_layout(params, cfg, B, mesh,
                                                 "sharded_decode_step")
    L.check_cache(cache, mesh, batch_axes, B, "sharded_decode_step")
    kc, vc, lc = cache["k"], cache["v"], cache["lengths"]

    def body(params, batch):
        x = L.embed_shards(params["embed"], batch["tokens"].parts)
        n = lc.parts
        for i, p in enumerate(params["layers"]):
            hs = [L.rms_norm(t, g, cfg.norm_eps)
                  for t, g in zip(x, p["ln1"].parts)]
            att = L.attention_decode_shards(
                p["attn"], hs, cfg, [t[i] for t in kc.parts],
                [t[i] for t in vc.parts], n, mesh, kc.spec)
            x = spmd.each(torch.add, x, att)
            hs = [L.rms_norm(t, g, cfg.norm_eps)[:, None, :]
                  for t, g in zip(x, p["ln2"].parts)]
            ys = _ffn_shards(cfg, p, hs, mesh, batch_axes)
            x = spmd.each(lambda t, y: t + y[:, 0], x, ys)
        h = [L.rms_norm(t, g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, _ = L.logits_shards(params, cfg, h)
        return logits, [t + 1 for t in n]

    logits, lengths = spmd.shard_map(body, mesh, (None, spec),
                                     (logit_spec, lc.spec))(params, batch)
    return logits, {"k": kc, "v": vc, "lengths": lengths}
