"""Whisper-style encoder-decoder: init, encode, the train loss, prefill and
decode.

Counterpart of the JAX package's ``models/whisper.py``. The conv audio
frontend is a stub, as there: batches carry precomputed frame embeddings
(B, S_enc, D) under ``frames``. Encoder: bidirectional self-attention
(``flash_attention`` with ``causal=False`` on the card) and a GeLU MLP.
Decoder: causal self-attention, then cross-attention to the encoder's output
(plain float32 PyTorch on every device, as the reference's jnp), then the
MLP. The output projection is tied to the embedding.

Parameters are a dict: ``embed``, ``enc_layers`` and ``dec_layers`` (lists
of per-layer dicts; the reference stacks them), ``enc_norm``,
``enc_norm_b``, ``dec_norm``, ``dec_norm_b``. The cache is ``{"self_k",
"self_v": (L, B, max_len, H, Dh), "cross_k", "cross_v": (L, B, S_enc, H,
Dh), "lengths": (B,) int32}``; ``decode_step`` writes the self-attention
rows IN PLACE, as the dense family does.

On a model mesh ``sharded_loss_fn``, ``sharded_prefill`` and
``sharded_decode_step`` run the same blocks per shard (``models.layers``'
``*_shards``): the encoder's and the decoder's self-attention on each
position's heads where the model width divides them, the GeLU MLP
column- then row-parallel, the layer norms on activations whole at D, the
frames split over the data axes as the tokens are. The logits are the
embedding's transpose whatever ``tie_embeddings`` says. The cross K and V
take the cross cache's layout (``launch.sharding.cache_shardings``) in
training too: by heads, by frames (the partials merged by their
log-sum-exp) or whole. Each device holds its own position table.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (P, Sharded, axes_of,
                                         cache_shardings, data_sharding,
                                         shard_region)
from repro_torch.models import layers as L


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card), with the reference's distributions; layer-norm
    gains ones and biases zeros."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg.param_dtype)
    D = cfg.d_model

    def norm(*names):
        out = {}
        for n in names:
            out[n] = torch.ones(D, dtype=dtype, device=dev)
            out[n + "b"] = torch.zeros(D, dtype=dtype, device=dev)
        return out

    def enc_layer():
        return {**norm("ln1", "ln2"), "attn": L.attn_init(gen, cfg, dtype),
                "mlp": L.mlp_init(gen, cfg, dtype)}

    def dec_layer():
        return {**norm("ln1", "ln_x", "ln2"),
                "self_attn": L.attn_init(gen, cfg, dtype),
                "cross_attn": L.attn_init(gen, cfg, dtype),
                "mlp": L.mlp_init(gen, cfg, dtype)}

    return {
        "embed": L.embed_init(gen, cfg.vocab_size, D, dtype),
        "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
        "dec_layers": [dec_layer() for _ in range(cfg.num_layers)],
        "enc_norm": torch.ones(D, dtype=dtype, device=dev),
        "enc_norm_b": torch.zeros(D, dtype=dtype, device=dev),
        "dec_norm": torch.ones(D, dtype=dtype, device=dev),
        "dec_norm_b": torch.zeros(D, dtype=dtype, device=dev),
    }


_TABLES: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _table(key: torch.Tensor, cfg: ModelConfig, n: int) -> torch.Tensor:
    table = _TABLES.get(key)
    if table is None or table.shape[0] < n:
        rows = max(n, cfg.max_seq_len, cfg.encoder_seq_len)
        table = L.sinusoidal_positions(rows, cfg.d_model).to(
            device=key.device, dtype=L.torch_dtype(cfg.dtype))
        _TABLES[key] = table
    return table[:n]


def position_table(params, cfg: ModelConfig, n: int) -> torch.Tensor:
    """The first ``n`` rows of ``sinusoidal_positions`` in ``cfg.dtype`` on
    the weights' device. The table, at least ``max_seq_len`` and
    ``encoder_seq_len`` rows, is computed on the host, so the card and the
    CPU add the same bits; it moves to the device once per set of weights
    (keyed by ``params["embed"]``) and is freed with them. Callers must not
    write into it."""
    return _table(params["embed"], cfg, n)


def position_tables(embed: Sharded, cfg: ModelConfig,
                    n: int) -> List[torch.Tensor]:
    """``position_table`` on a mesh: one table per mesh position, on its
    device. Each device's table is keyed by the first part of ``embed``
    that lies on it, so the positions that share a device share one table
    and it is freed with the weights; every table holds the same
    host-computed bits."""
    mine: Dict[torch.device, torch.Tensor] = {}
    for part in embed.parts:
        mine.setdefault(part.device, part)
    return [_table(mine[part.device], cfg, n) for part in embed.parts]


def _enc_layer(cfg: ModelConfig, p, x, positions):
    h = L.layer_norm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
    x = x + L.attention_prefill(p["attn"], h, cfg, positions, causal=False)
    h = L.layer_norm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], h, cfg)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, D), the stubbed frontend's output -> (B, S_enc,
    D). ``remat`` recomputes each layer in the backward pass."""
    B, S, D = frames.shape
    x = frames + position_table(params, cfg, S).to(frames.dtype)[None]
    positions = torch.arange(S, device=x.device)[None, :]
    for p in params["enc_layers"]:
        x = L.remat(_enc_layer, remat, cfg, p, x, positions)
    return L.layer_norm(x, params["enc_norm"], params["enc_norm_b"],
                        cfg.norm_eps)


def _dec_layer(cfg: ModelConfig, p, x, positions, enc_out):
    """One decoder layer: (x, its self-attention's (k, v), the
    cross-attention's (k, v))."""
    h = L.layer_norm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
    att, kv = L.attention_prefill(p["self_attn"], h, cfg, positions,
                                  return_kv=True)
    x = x + att
    h = L.layer_norm(x, p["ln_x"], p["ln_xb"], cfg.norm_eps)
    ck, cv = L.cross_kv(p["cross_attn"], enc_out, cfg)
    x = x + L.cross_attention(p["cross_attn"], h, cfg, ck, cv)
    h = L.layer_norm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
    return x + L.mlp_block(p["mlp"], h, cfg), kv, (ck, cv)


def _decoder_seq(params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor):
    """The decoder over (B, S) tokens: (hidden (B, S, D), per layer (k, v)
    of the self-attention, per layer the cross-attention's (k, v))."""
    B, S = tokens.shape
    x = params["embed"][tokens] + position_table(params, cfg, S)[None]
    positions = torch.arange(S, device=x.device)[None, :]
    self_kv, cross = [], []
    for p in params["dec_layers"]:
        x, kv, ckv = _dec_layer(cfg, p, x, positions, enc_out)
        self_kv.append(kv)
        cross.append(ckv)
    h = L.layer_norm(x, params["dec_norm"], params["dec_norm_b"],
                     cfg.norm_eps)
    return h, self_kv, cross


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent"}): the decoder's token cross-entropy over ``labels``
    (and ``loss_mask``), the logits tied to the embedding. ``cfg.remat``
    recomputes each encoder and decoder layer in the backward pass."""
    enc_out = encode(params, cfg, batch["frames"], remat=cfg.remat)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["embed"][tokens] + position_table(params, cfg, S)[None]
    positions = torch.arange(S, device=x.device)[None, :]

    def layer(p, x):
        return _dec_layer(cfg, p, x, positions, enc_out)[0]

    for p in params["dec_layers"]:
        x = L.remat(layer, cfg.remat, p, x)
    h = L.layer_norm(x, params["dec_norm"], params["dec_norm_b"],
                     cfg.norm_eps)
    logits = h @ params["embed"].T
    loss = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"xent": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """An empty cache; the cross rows are ``enc_len`` frames (0 means
    ``cfg.encoder_seq_len``)."""
    dev = resolve_device(device)
    dtype = L.torch_dtype(cfg.dtype)
    Lc, H, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    enc_len = enc_len or cfg.encoder_seq_len

    def zeros(rows):
        return torch.zeros((Lc, batch, rows, H, Dh), dtype=dtype, device=dev)

    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(enc_len), "cross_v": zeros(enc_len),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}



def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Encode ``frames`` once, run the decoder over ``tokens``: (last
    logits (B, V), cache). The self-attention cache is ``max_len`` wide
    (``S`` if the prompt is longer); the cross cache holds every frame."""
    enc_out = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    h, self_kv, cross = _decoder_seq(params, cfg, tokens, enc_out)
    logits = h[:, -1] @ params["embed"].T
    cache = init_cache(cfg, B, max(max_len, S), device=h.device,
                       enc_len=enc_out.shape[1])
    for i, ((k, v), (ck, cv)) in enumerate(zip(self_kv, cross)):
        cache["self_k"][i, :, :S] = k
        cache["self_v"][i, :, :S] = v
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
    cache["lengths"].fill_(S)
    return logits, cache


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One-token decode. batch: {"tokens": (B,) int}. Returns (logits (B,
    V), cache with the new self-attention rows written in place and lengths
    + 1). The position table covers ``cfg.max_seq_len`` rows; a length past
    it reads the last row, as the reference's gather clamps."""
    tok = batch["tokens"]
    lengths = cache["lengths"]
    table = position_table(params, cfg, cfg.max_seq_len)
    pos = torch.clamp(lengths, max=cfg.max_seq_len - 1).long()
    x = params["embed"][tok] + table[pos]
    for i, p in enumerate(params["dec_layers"]):
        h = L.layer_norm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
        att, _, _ = L.attention_decode(p["self_attn"], h, cfg,
                                       cache["self_k"][i], cache["self_v"][i],
                                       lengths)
        x = x + att
        h = L.layer_norm(x, p["ln_x"], p["ln_xb"], cfg.norm_eps)
        x = x + L.cross_attention(p["cross_attn"], h, cfg, cache["cross_k"][i],
                                  cache["cross_v"][i])
        h = L.layer_norm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
        x = x + L.mlp_block(p["mlp"], h, cfg)
    h = L.layer_norm(x, params["dec_norm"], params["dec_norm_b"],
                     cfg.norm_eps)
    logits = h @ params["embed"].T
    return logits, dict(cache, lengths=lengths + 1)


# ---------------------------------------------------------------------------
# on a model mesh
# ---------------------------------------------------------------------------
def _norm_shards(xs, g: Sharded, b: Sharded, cfg: ModelConfig):
    return [L.layer_norm(x, gp, bp, cfg.norm_eps)
            for x, gp, bp in zip(xs, g.parts, b.parts)]


def _enc_layer_shards(cfg: ModelConfig, p, xs, positions, mesh: Mesh):
    hs = _norm_shards(xs, p["ln1"], p["ln1b"], cfg)
    xs = spmd.each(torch.add, xs, L.attention_prefill_shards(
        p["attn"], hs, cfg, positions, mesh, causal=False))
    hs = _norm_shards(xs, p["ln2"], p["ln2b"], cfg)
    return spmd.each(torch.add, xs, L.mlp_block_shards(p["mlp"], hs, cfg,
                                                       mesh))


def _encode_shards(params, cfg: ModelConfig, frames, mesh: Mesh,
                   remat: bool):
    """``encode`` per shard: each position's (B_local, S_enc, D) frames ->
    the encoder's output there, replicated over ``model``."""
    S = frames[0].shape[1]
    tables = position_tables(params["embed"], cfg, S)
    xs = [f + t.to(f.dtype)[None] for f, t in zip(frames, tables)]
    positions = [torch.arange(S, device=d)[None, :] for d in mesh.devices]
    for p in params["enc_layers"]:
        xs = L.layer_call(lambda q, ys: _enc_layer_shards(
            cfg, q, ys, positions, mesh), p, xs, remat)
    return _norm_shards(xs, params["enc_norm"], params["enc_norm_b"], cfg)


def _dec_layer_shards(cfg: ModelConfig, p, xs, positions, enc, mesh: Mesh,
                      cross_spec):
    """One decoder layer per shard: (x, each position's self-attention (k,
    v), its cross (k, v) laid out by ``cross_spec``)."""
    hs = _norm_shards(xs, p["ln1"], p["ln1b"], cfg)
    att, kvs = L.attention_prefill_shards(p["self_attn"], hs, cfg, positions,
                                          mesh, return_kv=True)
    xs = spmd.each(torch.add, xs, att)
    hs = _norm_shards(xs, p["ln_x"], p["ln_xb"], cfg)
    ck, cv = L.cross_kv_shards(p["cross_attn"], enc, cfg, mesh, cross_spec)
    xs = spmd.each(torch.add, xs, L.cross_attention_shards(
        p["cross_attn"], hs, cfg, ck, cv, mesh, cross_spec))
    hs = _norm_shards(xs, p["ln2"], p["ln2b"], cfg)
    xs = spmd.each(torch.add, xs, L.mlp_block_shards(p["mlp"], hs, cfg,
                                                     mesh))
    return xs, kvs, (ck, cv)


def _cache_layout(cfg: ModelConfig, mesh: Mesh, B: int, max_len: int,
                  enc_len: int):
    """``cache_shardings`` of a (B, max_len) cache over ``enc_len``
    frames."""
    return cache_shardings(cfg, mesh, L.meta_specs(
        lambda: init_cache(cfg, B, max_len, device="cpu", enc_len=enc_len)))


def _decoder_input(params, cfg: ModelConfig, tokens, S: int):
    x = L.embed_shards(params["embed"], tokens)
    return [e + t[None] for e, t in zip(
        x, position_tables(params["embed"], cfg, S))]


def sharded_loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    mesh: Mesh):
    """``loss_fn`` on ``mesh`` -> (loss, {"xent"}), 0-d tensors on the mesh's
    first device. ``params`` is a tree of ``Sharded`` placed by
    ``param_shardings``; ``batch`` holds whole tensors, the frames, tokens
    and labels split over the data axes by ``data_sharding`` (replicated
    when their width does not divide B). The encoder and decoder layers run
    per shard under ``spmd.remat`` when ``cfg.remat`` (a decoder layer takes
    the encoder's output as an input of its recompute, so its gradient
    reaches the encoder); the logits are the embedding's transpose, split by
    vocab where the embedding is, and the cross-entropy takes the
    log-sum-exp across the shards."""
    B = batch["tokens"].shape[0]
    spec = data_sharding(mesh, 1, B).spec
    batch_axes = axes_of(spec[0])
    cross_spec = cache_shardings(cfg, mesh, {"cross_k": torch.empty(
        (cfg.num_layers, B, batch["frames"].shape[1], cfg.num_kv_heads,
         cfg.head_dim), device="meta")})["cross_k"].spec

    def body(params, batch):
        enc = _encode_shards(params, cfg, batch["frames"].parts, mesh,
                             cfg.remat)
        S = batch["tokens"].shape[1]
        x = _decoder_input(params, cfg, batch["tokens"].parts, S)
        positions = [torch.arange(S, device=d)[None, :] for d in mesh.devices]
        n = len(x)
        for p in params["dec_layers"]:
            x = L.layer_call(lambda q, ys: _dec_layer_shards(
                cfg, q, ys[:n], positions, ys[n:], mesh, cross_spec)[0],
                p, x + enc, cfg.remat)
        h = _norm_shards(x, params["dec_norm"], params["dec_norm_b"], cfg)
        logits, split = L.logits_shards(params, cfg, h, tied=True)
        masks = batch["loss_mask"].parts if "loss_mask" in batch else None
        return L.softmax_xent_shards(logits, batch["labels"].parts, masks,
                                     mesh, split, batch_axes)

    loss = spmd.shard_map(body, mesh, (None, spec), P())(params, batch)
    return loss.parts[0], {"xent": loss.parts[0]}


_CACHE_LEAVES = ("self_k", "self_v", "cross_k", "cross_v", "lengths")


def sharded_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    max_len: int, mesh: Mesh):
    """``prefill`` on ``mesh`` -> (last logits, cache). ``batch`` holds whole
    ``frames`` and ``tokens``, split over the data axes as
    ``data_sharding`` splits them. The cache is laid out by
    ``launch.sharding.cache_shardings``: ``self_k``/``self_v`` (L, B,
    max(max_len, S), Hkv, Dh) by KV heads or, where the model width does not
    divide them, by rows, zero-padded past S; ``cross_k``/``cross_v`` (L, B,
    S_enc, Hkv, Dh) by KV heads, else by frames, else whole. Returns the
    logits as a ``Sharded`` (B, V) split over the data axes and by vocab over
    ``model`` where the embedding is, and the cache as a dict of
    ``Sharded``."""
    B, S = batch["tokens"].shape
    S_enc = batch["frames"].shape[1]
    spec, _, logit_spec = L.serve_layout(params, cfg, B, mesh,
                                         "sharded_prefill", tied=True)
    Smax = max(max_len, S)
    sh = _cache_layout(cfg, mesh, B, Smax, S_enc)
    shapes = {"self_k": (cfg.num_layers, B, Smax, cfg.num_kv_heads,
                         cfg.head_dim),
              "cross_k": (cfg.num_layers, B, S_enc, cfg.num_kv_heads,
                          cfg.head_dim)}
    dtype = L.torch_dtype(cfg.dtype)

    def body(params, batch):
        enc = _encode_shards(params, cfg, batch["frames"].parts, mesh, False)
        x = _decoder_input(params, cfg, batch["tokens"].parts, S)
        positions = [torch.arange(S, device=d)[None, :] for d in mesh.devices]
        regions = {k: [shard_region(shape, sh[k].spec, mesh, pos)
                       for pos in range(mesh.size)]
                   for k, shape in shapes.items()}
        out = {k: [torch.zeros(tuple(r.stop - r.start for r in reg),
                               dtype=dtype, device=d)
                   for reg, d in zip(regions[k[:-1] + "k"], mesh.devices)]
               for k in _CACHE_LEAVES[:4]}
        for i, p in enumerate(params["dec_layers"]):
            x, kvs, (ck, cv) = _dec_layer_shards(cfg, p, x, positions, enc,
                                                 mesh, sh["cross_k"].spec)
            for pos, (k, v) in enumerate(kvs):
                reg = regions["self_k"][pos]
                out["self_k"][pos][i] = L.kv_block(k, reg, S,
                                                   cfg.num_kv_heads)
                out["self_v"][pos][i] = L.kv_block(v, reg, S,
                                                   cfg.num_kv_heads)
                out["cross_k"][pos][i] = ck[pos]
                out["cross_v"][pos][i] = cv[pos]
        h = _norm_shards([t[:, -1] for t in x], params["dec_norm"],
                         params["dec_norm_b"], cfg)
        logits, _ = L.logits_shards(params, cfg, h, tied=True)
        lengths = [torch.full((t.shape[0],), S, dtype=torch.int32,
                              device=t.device) for t in h]
        return (logits,) + tuple(out[k] for k in _CACHE_LEAVES[:4]) + (
            lengths,)

    logits, *leaves_ = spmd.shard_map(
        body, mesh, (None, spec),
        (logit_spec,) + tuple(sh[k].spec for k in _CACHE_LEAVES))(params,
                                                                  batch)
    return logits, dict(zip(_CACHE_LEAVES, leaves_))


def sharded_decode_step(params, cfg: ModelConfig,
                        batch: Dict[str, torch.Tensor], cache, mesh: Mesh):
    """``decode_step`` on ``mesh`` -> (logits, cache). ``batch``: {"tokens":
    (B,)} whole; ``cache``: the dict of ``Sharded`` that ``sharded_prefill``
    returns or that ``cache_shardings`` places. Each layer writes its new
    self-attention row IN PLACE and runs ``layers.attention_decode_shards``
    (the heads or the sequence form, as the cache is laid out), then
    cross-attends to its cross K and V in their layout
    (``layers.cross_attention_shards``); lengths + 1. Each position adds its
    own device's position table at its rows' lengths, clamped to
    ``cfg.max_seq_len`` - 1 as unsharded."""
    B = batch["tokens"].shape[0]
    spec, batch_axes, logit_spec = L.serve_layout(
        params, cfg, B, mesh, "sharded_decode_step", tied=True)
    L.check_cache(cache, mesh, batch_axes, B, "sharded_decode_step")
    sk, sv, ck, cv, lc = (cache[k] for k in _CACHE_LEAVES)

    def body(params, batch):
        tables = position_tables(params["embed"], cfg, cfg.max_seq_len)
        x = spmd.each(lambda e, t, n: e + t[torch.clamp(
            n, max=cfg.max_seq_len - 1).long()],
            L.embed_shards(params["embed"], batch["tokens"].parts), tables,
            lc.parts)
        for i, p in enumerate(params["dec_layers"]):
            hs = _norm_shards(x, p["ln1"], p["ln1b"], cfg)
            x = spmd.each(torch.add, x, L.attention_decode_shards(
                p["self_attn"], hs, cfg, [t[i] for t in sk.parts],
                [t[i] for t in sv.parts], lc.parts, mesh, sk.spec))
            hs = _norm_shards(x, p["ln_x"], p["ln_xb"], cfg)
            x = spmd.each(torch.add, x, L.cross_attention_shards(
                p["cross_attn"], hs, cfg, [t[i] for t in ck.parts],
                [t[i] for t in cv.parts], mesh, ck.spec))
            hs = _norm_shards(x, p["ln2"], p["ln2b"], cfg)
            x = spmd.each(torch.add, x, L.mlp_block_shards(p["mlp"], hs, cfg,
                                                           mesh))
        h = _norm_shards(x, params["dec_norm"], params["dec_norm_b"], cfg)
        logits, _ = L.logits_shards(params, cfg, h, tied=True)
        return logits, [t + 1 for t in lc.parts]

    logits, lengths = spmd.shard_map(body, mesh, (None, spec),
                                     (logit_spec, lc.spec))(params, batch)
    return logits, {**cache, "lengths": lengths}
