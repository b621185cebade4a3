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
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
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


def position_table(params, cfg: ModelConfig, n: int) -> torch.Tensor:
    """The first ``n`` rows of ``sinusoidal_positions`` in ``cfg.dtype`` on
    the weights' device. The table, at least ``max_seq_len`` and
    ``encoder_seq_len`` rows, is computed on the host, so the card and the
    CPU add the same bits; it moves to the device once per set of weights
    (keyed by ``params["embed"]``) and is freed with them. Callers must not
    write into it."""
    emb = params["embed"]
    table = _TABLES.get(emb)
    if table is None or table.shape[0] < n:
        rows = max(n, cfg.max_seq_len, cfg.encoder_seq_len)
        table = L.sinusoidal_positions(rows, cfg.d_model).to(
            device=emb.device, dtype=L.torch_dtype(cfg.dtype))
        _TABLES[emb] = table
    return table[:n]


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
