"""Zamba2 hybrid: a Mamba2 backbone and one SHARED attention + MLP block
applied after every ``attn_every`` Mamba2 layers.

Counterpart of the JAX package's ``models/zamba2.py``. For L layers and
period A: G = L // A groups of A Mamba2 layers, each group followed by one
application of the shared block (the same weights every time, a KV cache of
its own per application); the L - G*A remaining layers run last. The JAX
package scans grouped, stacked parameters; here Python loops walk the list.

Parameters: ``embed``, ``layers`` (one dict per layer: ``ln``, ``mamba``),
``shared_attn`` (``ln1``, ``ln2``, ``attn``, ``mlp``; one dict),
``final_norm``, ``unembed``.

``loss_fn`` trains it: on a card the Mamba2 layers' scans run the
``mamba2_ssd`` kernels forward and backward, the shared block's attention
the ``flash_attention`` kernels.

The cache keeps the reference's keys and shapes: ``ssd`` (L, B, H, P, N)
float32, ``conv`` (L, B, W-1, conv_dim), ``kv_k`` and ``kv_v`` (G, B, Smax,
Hkv, Dh) in cfg.dtype, ``lengths`` (B,) int32. ``decode_step`` updates
``ssd``, ``conv``, ``kv_k`` and ``kv_v`` IN PLACE and returns a dict with the
same tensors and new ``lengths``; a caller that keeps an older cache dict
must clone it.

``sharded_loss_fn``, ``sharded_prefill`` and ``sharded_decode_step`` run it
on a model mesh: the Mamba2 layers through ``mamba2.mamba2_seq_shards`` and
``mamba2_step_shards`` (under ``spmd.remat`` when ``cfg.remat``), the
shared block through ``layers.attention_prefill_shards``,
``attention_decode_shards`` and ``mlp_block_shards``; the cache laid out by
``launch.sharding.cache_shardings``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (P, axes_of, cache_shardings,
                                         data_sharding, shard_region)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import meta_specs


def _group_counts(cfg: ModelConfig):
    A = cfg.attn_every
    G = cfg.num_layers // A
    return G, A, cfg.num_layers - G * A


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card), with the reference's distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=dtype, device=dev)  # noqa: E731
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, D, dtype),
        "layers": [{"ln": ones(), "mamba": M.mamba2_init(gen, cfg, dtype)}
                   for _ in range(cfg.num_layers)],
        "shared_attn": {
            "ln1": ones(),
            "ln2": ones(),
            "attn": L.attn_init(gen, cfg, dtype),
            "mlp": L.mlp_init(gen, cfg, dtype),
        },
        "final_norm": ones(),
        "unembed": L.dense_init(gen, D, cfg.vocab_size, dtype),
    }


def _layer_order(cfg: ModelConfig):
    """(layer index or None, group index): the Mamba2 layers in order, a
    ``None`` where the shared block applies after group ``g``."""
    G, A, rem = _group_counts(cfg)
    for g in range(G):
        for a in range(A):
            yield g * A + a, g
        yield None, g
    for i in range(G * A, G * A + rem):
        yield i, None


def _shared_attn_seq(cfg, sp, x, positions, return_kv=True):
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    att = L.attention_prefill(sp["attn"], h, cfg, positions,
                              return_kv=return_kv)
    if return_kv:
        att, kv = att
    x = x + att
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    x = x + L.mlp_block(sp["mlp"], h, cfg)
    return (x, kv) if return_kv else x


def _run_seq(params, cfg: ModelConfig, x: torch.Tensor, states):
    """x: (B, T, D). ``states``: {"ssd", "conv"} stacked over layers,
    updated in place. Returns (x, [(k, v) per application of the shared
    block])."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    sp = params["shared_attn"]
    kvs = []
    for i, _g in _layer_order(cfg):
        if i is None:
            x, kv = _shared_attn_seq(cfg, sp, x, positions)
            kvs.append(kv)
            continue
        x, states["ssd"][i], states["conv"][i] = _mamba_layer(
            cfg, params["layers"][i], x, states["ssd"][i], states["conv"][i])
    return x, kvs


def _mamba_layer(cfg: ModelConfig, p, x, ssd_state, conv_state):
    """One Mamba2 layer: (x + mamba2(rms_norm(x)), new ssd state, new conv
    state)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    y, s_new, c_new = M.mamba2_seq(p["mamba"], h, cfg, ssd_state, conv_state)
    return x + y, s_new, c_new


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent"}): the token cross-entropy over ``labels`` (B, T) (and
    ``loss_mask``), as the reference's ``loss_fn``. Every layer starts from
    zero states, which nothing writes (autograd keeps the tensors it saved
    intact) and which the loss drops. ``cfg.remat`` recomputes each Mamba2
    layer in the backward pass; the shared block is kept, as the reference
    checkpoints the Mamba2 layers only."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = params["embed"][tokens]
    ssd_shape, conv_shape = M.state_shapes(cfg, B)
    ssd0 = torch.zeros(ssd_shape, dtype=torch.float32, device=x.device)
    conv0 = torch.zeros(conv_shape, dtype=L.torch_dtype(cfg.dtype),
                        device=x.device)
    positions = torch.arange(T, device=x.device)[None, :]
    for i, _g in _layer_order(cfg):
        if i is None:
            x = _shared_attn_seq(cfg, params["shared_attn"], x, positions,
                                 return_kv=False)
        else:
            x = L.remat(_mamba_layer, cfg.remat, cfg, params["layers"][i], x,
                        ssd0, conv0)[0]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = L.softmax_xent(h @ params["unembed"], batch["labels"],
                          batch.get("loss_mask"))
    return loss, {"xent": loss}


def init_state(cfg: ModelConfig, batch: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    ssd_shape, conv_shape = M.state_shapes(cfg, batch)
    Lnum = cfg.num_layers
    return {
        "ssd": torch.zeros((Lnum,) + ssd_shape, dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((Lnum,) + conv_shape,
                            dtype=L.torch_dtype(cfg.dtype), device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    G, _, _ = _group_counts(cfg)
    kv_shape = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = L.torch_dtype(cfg.dtype)
    return {
        **init_state(cfg, batch, device=dev),
        "kv_k": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "kv_v": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }



def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Full-sequence forward; returns (last logits (B, V), cache). The KV
    caches are ``max_len`` wide (``T`` if the prompt is longer)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = params["embed"][tokens]
    cache = init_cache(cfg, B, max(max_len, T), device=x.device)
    x, kvs = _run_seq(params, cfg, x, cache)
    for g, (k, v) in enumerate(kvs):
        cache["kv_k"][g, :, :T] = k
        cache["kv_v"][g, :, :T] = v
    h = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    cache["lengths"].fill_(T)
    return h @ params["unembed"], cache


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One-token decode. batch: {"tokens": (B,) int}. Returns (logits (B,
    V), cache updated in place with lengths + 1)."""
    x = params["embed"][batch["tokens"]]           # (B, D)
    lengths = cache["lengths"]
    sp = params["shared_attn"]
    for i, g in _layer_order(cfg):
        if i is None:
            h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
            att, _, _ = L.attention_decode(sp["attn"], h, cfg,
                                           cache["kv_k"][g], cache["kv_v"][g],
                                           lengths)
            x = x + att
            h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = x + L.mlp_block(sp["mlp"], h, cfg)
            continue
        p = params["layers"][i]
        h = L.rms_norm(x, p["ln"], cfg.norm_eps)
        y, s_new, c_new = M.mamba2_step(p["mamba"], h, cfg, cache["ssd"][i],
                                        cache["conv"][i])
        x = x + y
        cache["ssd"][i] = s_new
        cache["conv"][i] = c_new
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["unembed"], {**cache, "lengths": lengths + 1}


# ---------------------------------------------------------------------------
# on a model mesh
# ---------------------------------------------------------------------------
def _shared_shards(cfg, sp, xs, positions, mesh: Mesh, return_kv=False):
    """The shared block at every position: attention (its heads where the
    model width divides them, ``layers.attention_prefill_shards``) and the
    MLP (``layers.mlp_block_shards``), each added to the residual."""
    hs = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, sp["ln1"].parts)]
    att = L.attention_prefill_shards(sp["attn"], hs, cfg, positions, mesh,
                                     return_kv=return_kv)
    if return_kv:
        att, kvs = att
    xs = spmd.each(torch.add, xs, att)
    hs = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, sp["ln2"].parts)]
    xs = spmd.each(torch.add, xs, L.mlp_block_shards(sp["mlp"], hs, cfg, mesh))
    return (xs, kvs) if return_kv else xs


def _mamba_shards(cfg, p, xs, ssd, conv, mesh: Mesh, step=False):
    """One Mamba2 layer at every position: (x + mamba2(rms_norm(x)), new SSD
    states, new conv states)."""
    hs = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, p["ln"].parts)]
    fn = M.mamba2_step_shards if step else M.mamba2_seq_shards
    ys, s_new, c_new = fn(p["mamba"], hs, cfg, mesh, ssd, conv)
    return spmd.each(torch.add, xs, ys), s_new, c_new


def _zero_states(cfg: ModelConfig, mesh: Mesh, xs):
    """Each position's zero SSD state (B_local, its heads, P, N) and zero
    conv state (B_local, W-1, conv_dim), whole."""
    _, H, P, conv_dim = M.mamba2_dims(cfg)
    n = L.heads_of(H, mesh, 0)[1]
    ssd = [torch.zeros((x.shape[0], n, P, cfg.ssm_state_dim),
                       dtype=torch.float32, device=x.device) for x in xs]
    conv = [torch.zeros((x.shape[0], cfg.ssm_conv_width - 1, conv_dim),
                        dtype=L.torch_dtype(cfg.dtype), device=x.device)
            for x in xs]
    return ssd, conv


def sharded_loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    mesh: Mesh):
    """``loss_fn`` on ``mesh`` -> (loss, {"xent"}), 0-d tensors on the mesh's
    first device. ``params`` is a tree of ``Sharded`` placed by
    ``param_shardings``; ``batch`` holds whole tensors, split over the data
    axes by ``data_sharding``. The Mamba2 layers run per shard
    (``mamba2.mamba2_seq_shards``) from zero states, under ``spmd.remat``
    when ``cfg.remat`` (the shared block is kept, as the reference
    checkpoints the Mamba2 layers only); the logits stay split by vocab and
    the cross-entropy takes the log-sum-exp across the shards."""
    B = batch["tokens"].shape[0]
    spec = data_sharding(mesh, 1, B).spec
    batch_axes = axes_of(spec[0])

    def body(params, batch):
        x = L.embed_shards(params["embed"], batch["tokens"].parts)
        T = x[0].shape[1]
        positions = [torch.arange(T, device=d)[None, :] for d in mesh.devices]
        ssd0, conv0 = _zero_states(cfg, mesh, x)
        for i, _g in _layer_order(cfg):
            if i is None:
                x = _shared_shards(cfg, params["shared_attn"], x, positions,
                                   mesh)
            else:
                x = L.layer_call(lambda q, xs: _mamba_shards(
                    cfg, q, xs, ssd0, conv0, mesh)[0], params["layers"][i],
                    x, cfg.remat)
        h = [L.rms_norm(t, g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, split = L.logits_shards(params, cfg, h)
        masks = batch["loss_mask"].parts if "loss_mask" in batch else None
        return L.softmax_xent_shards(logits, batch["labels"].parts, masks,
                                     mesh, split, batch_axes)

    loss = spmd.shard_map(body, mesh, (None, spec), P())(params, batch)
    return loss.parts[0], {"xent": loss.parts[0]}


def sharded_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    max_len: int, mesh: Mesh):
    """``prefill`` on ``mesh`` -> (last logits, cache), the cache laid out by
    ``launch.sharding.cache_shardings``: ``ssd`` by heads over ``model``
    where the width divides them, ``conv`` whole and equal at every model
    position, ``kv_k``/``kv_v`` (G, B, max(max_len, T), Hkv, Dh) by KV heads
    (or by rows where the width does not divide them) and zero-padded past
    T, everything split over the data axes as the batch is. Returns the
    logits as a ``Sharded`` (B, V) split by vocab over ``model`` and the
    cache as a dict of ``Sharded``."""
    B, T = batch["tokens"].shape
    spec, _, logit_spec = L.serve_layout(params, cfg, B, mesh,
                                         "sharded_prefill")
    Smax = max(max_len, T)
    sh = cache_shardings(cfg, mesh, meta_specs(
        lambda: init_cache(cfg, B, Smax, device="cpu")))
    G, _, _ = _group_counts(cfg)
    kv_shape = (G, B, Smax, cfg.num_kv_heads, cfg.head_dim)
    dtype = L.torch_dtype(cfg.dtype)

    def body(params, batch):
        x = L.embed_shards(params["embed"], batch["tokens"].parts)
        positions = [torch.arange(T, device=d)[None, :] for d in mesh.devices]
        ssd0, conv0 = _zero_states(cfg, mesh, x)
        ssd = [torch.zeros((cfg.num_layers,) + t.shape, dtype=t.dtype,
                           device=t.device) for t in ssd0]
        conv = [torch.zeros((cfg.num_layers,) + t.shape, dtype=t.dtype,
                            device=t.device) for t in conv0]
        regions = [shard_region(kv_shape, sh["kv_k"].spec, mesh, pos)
                   for pos in range(mesh.size)]
        ks = [torch.zeros(tuple(r.stop - r.start for r in reg), dtype=dtype,
                          device=d) for reg, d in zip(regions, mesh.devices)]
        vs = [torch.zeros_like(t) for t in ks]
        for i, g in _layer_order(cfg):
            if i is None:
                x, kvs = _shared_shards(cfg, params["shared_attn"], x,
                                        positions, mesh, return_kv=True)
                for pos, (k, v) in enumerate(kvs):
                    ks[pos][g] = L.kv_block(k, regions[pos], T,
                                            cfg.num_kv_heads)
                    vs[pos][g] = L.kv_block(v, regions[pos], T,
                                            cfg.num_kv_heads)
                continue
            x, s_new, c_new = _mamba_shards(cfg, params["layers"][i], x,
                                            ssd0, conv0, mesh)
            for pos in range(mesh.size):
                ssd[pos][i] = s_new[pos]
                conv[pos][i] = c_new[pos]
        h = [L.rms_norm(t[:, -1], g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, _ = L.logits_shards(params, cfg, h)
        lengths = [torch.full((t.shape[0],), T, dtype=torch.int32,
                              device=t.device) for t in h]
        return logits, ssd, conv, ks, vs, lengths

    names = ("ssd", "conv", "kv_k", "kv_v", "lengths")
    logits, *leaves_ = spmd.shard_map(
        body, mesh, (None, spec),
        (logit_spec,) + tuple(sh[k].spec for k in names))(params, batch)
    return logits, dict(zip(names, leaves_))


def sharded_decode_step(params, cfg: ModelConfig,
                        batch: Dict[str, torch.Tensor], cache, mesh: Mesh):
    """``decode_step`` on ``mesh`` -> (logits, cache). ``cache``: the dict of
    ``Sharded`` that ``sharded_prefill`` returns or that ``cache_shardings``
    places. Each Mamba2 layer steps its heads' rows of ``ssd`` and the whole
    ``conv`` (``mamba2.mamba2_step_shards``) and writes them IN PLACE; each
    application of the shared block writes its K/V row IN PLACE and runs
    ``layers.attention_decode_shards`` (the heads or the sequence form, as
    the cache is laid out); lengths + 1."""
    B = batch["tokens"].shape[0]
    spec, batch_axes, logit_spec = L.serve_layout(params, cfg, B, mesh,
                                                  "sharded_decode_step")
    L.check_cache(cache, mesh, batch_axes, B, "sharded_decode_step")
    ssd, conv = cache["ssd"].parts, cache["conv"].parts
    kc, vc, lc = cache["kv_k"], cache["kv_v"], cache["lengths"]

    def body(params, batch):
        x = L.embed_shards(params["embed"], batch["tokens"].parts)
        sp = params["shared_attn"]
        for i, g in _layer_order(cfg):
            if i is None:
                hs = [L.rms_norm(t, w, cfg.norm_eps)
                      for t, w in zip(x, sp["ln1"].parts)]
                att = L.attention_decode_shards(
                    sp["attn"], hs, cfg, [t[g] for t in kc.parts],
                    [t[g] for t in vc.parts], lc.parts, mesh, kc.spec)
                x = spmd.each(torch.add, x, att)
                hs = [L.rms_norm(t, w, cfg.norm_eps)
                      for t, w in zip(x, sp["ln2"].parts)]
                x = spmd.each(torch.add, x,
                              L.mlp_block_shards(sp["mlp"], hs, cfg, mesh))
                continue
            x, s_new, c_new = _mamba_shards(
                cfg, params["layers"][i], x, [t[i] for t in ssd],
                [t[i] for t in conv], mesh, step=True)
            for pos in range(mesh.size):
                ssd[pos][i] = s_new[pos]
                conv[pos][i] = c_new[pos]
        h = [L.rms_norm(t, w, cfg.norm_eps)
             for t, w in zip(x, params["final_norm"].parts)]
        logits, _ = L.logits_shards(params, cfg, h)
        return logits, [t + 1 for t in lc.parts]

    logits, lengths = spmd.shard_map(body, mesh, (None, spec),
                                     (logit_spec, lc.spec))(params, batch)
    return logits, {**cache, "lengths": lengths}
