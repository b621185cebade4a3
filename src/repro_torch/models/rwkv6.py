"""RWKV6 "Finch": an attention-free LM with data-dependent decay.

Counterpart of the JAX package's ``models/rwkv6.py``: token-shift lerps for
r/k/v/g, a LoRA tower giving the per-token decay w, a per-head bonus u, the
WKV recurrence, a per-head group norm on its output and a squared-ReLU
channel mix. Decode carries (wkv state, time-mix shift, channel-mix shift)
per layer: constant memory in the context length.

The sequence form runs the ``rwkv6_scan`` kernel through ``kernels.ops``
(its plain version on CPU tensors). The single-token step is plain PyTorch
on either device, as the reference's ``rwkv6_decode_step`` is plain jnp
outside any Pallas kernel.

Parameters: ``embed``, ``ln_in``, ``layers`` (one dict per layer),
``final_norm``, ``unembed``. The state (the serve engine's cache) keeps the
reference's keys and shapes: ``wkv`` (L, B, H, K, K) float32, ``shift_t``
and ``shift_c`` (L, B, D) in cfg.dtype, ``lengths`` (B,) int32.
``decode_step`` updates ``wkv``, ``shift_t`` and ``shift_c`` IN PLACE and
returns a dict with the same tensors and new ``lengths``.

``loss_fn`` trains it: on a card the scans run the ``rwkv6_scan`` kernels
forward and backward.

``sharded_loss_fn``, ``sharded_prefill`` and ``sharded_decode_step`` run it
on a model mesh (the reference's GSPMD behaviour under its sharding rules):
each position computes its block of the heads (all of them where the model
width does not divide them) from the column-parallel ``wr``, ``wk_t``,
``wv_t``, ``wg`` and the replicated decay LoRA and ``u`` cut to its heads,
scans them, and ``wo_t`` and ``w_cm_v`` are row-parallel with a ``psum``;
the state's ``wkv`` is split by heads as ``launch.sharding.cache_shardings``
lays it out, the shifts are whole at every model position.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (P, axes_of, cache_shardings,
                                         data_sharding)
from repro_torch.models import layers as L
from repro_torch.models.layers import meta_specs

LORA_DIM = 64


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card), with the reference's distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    H = D // cfg.rwkv_head_size

    def full(v):
        return torch.full((D,), v, dtype=torch.float32, device=dev).to(dtype)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(dtype)

    def layer():
        return {
            "ln1": full(1.0), "ln2": full(1.0),
            # time-mix
            "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
            "mu_w": full(0.5), "mu_g": full(0.5),
            "wr": L.dense_init(gen, D, D, dtype),
            "wk_t": L.dense_init(gen, D, D, dtype),
            "wv_t": L.dense_init(gen, D, D, dtype),
            "wg": L.dense_init(gen, D, D, dtype),
            "wo_t": L.dense_init(gen, D, D, dtype),
            # data-dependent decay LoRA: w = base + tanh(x @ A) @ B
            "w_base": full(-0.5),
            "w_lora_a": L.dense_init(gen, D, LORA_DIM, dtype),
            "w_lora_b": normal((LORA_DIM, D), 0.01),
            "u": normal((H, cfg.rwkv_head_size), 0.1),
            "ln_x": full(1.0),
            # channel-mix
            "mu_cm": full(0.5),
            "w_cm_k": L.dense_init(gen, D, cfg.d_ff, dtype),
            "w_cm_v": L.dense_init(gen, cfg.d_ff, D, dtype),
        }

    return {
        "embed": L.embed_init(gen, cfg.vocab_size, D, dtype),
        "ln_in": full(1.0),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": full(1.0),
        "unembed": L.dense_init(gen, D, cfg.vocab_size, dtype),
    }


def _tmix_rkvwg(p, x, shifted, cfg: ModelConfig):
    """r, k, v, w (float32), g from the token-shift lerps; r/k/v/w split
    into heads (..., H, hs)."""
    H = cfg.d_model // cfg.rwkv_head_size
    hs = cfg.rwkv_head_size

    def lerp(mu):
        return x + (shifted - x) * mu

    r = lerp(p["mu_r"]) @ p["wr"]
    k = lerp(p["mu_k"]) @ p["wk_t"]
    v = lerp(p["mu_v"]) @ p["wv_t"]
    g = F.silu(lerp(p["mu_g"]) @ p["wg"])
    xw = lerp(p["mu_w"])
    w = p["w_base"].to(torch.float32) + (
        torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).to(torch.float32)

    def split(t):
        return t.reshape(*t.shape[:-1], H, hs)

    return split(r), split(k), split(v), split(w), g


def _time_mix_seq(p, x, cfg: ModelConfig, state, shift_in):
    """x: (B, T, D); state: (B, H, K, V); shift_in: (B, D). Returns (out,
    new_state, new_shift)."""
    B, T, D = x.shape
    H = D // cfg.rwkv_head_size
    shifted = torch.cat([shift_in[:, None, :], x[:, :-1]], dim=1)
    r, k, v, w, g = _tmix_rkvwg(p, x, shifted, cfg)
    wkv, s_new = ops.rwkv6_scan(r, k, v, w, p["u"], state)
    wkv = wkv.reshape(B, T, D)
    out = (L.group_rms_norm(wkv, p["ln_x"], H) * g) @ p["wo_t"]
    return out, s_new, x[:, -1]


def rwkv6_decode_step(r, k, v, w, u, state):
    """One-token WKV6 step, the counterpart of the reference's
    ``ref.rwkv6_decode_step``. r, k, w (B, H, K), v (B, H, V), u (H, K),
    state (B, H, K, V) -> (o in r's type, new state in state's type)."""
    f32 = torch.float32
    rf, kf, vf, wf = (a.to(f32) for a in (r, k, v, w))
    uf = u.to(f32)
    sf = state.to(f32)
    kv = kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", rf, sf + uf[None, :, :, None] * kv)
    s_new = torch.exp(-torch.exp(wf))[..., None] * sf + kv
    return o.to(r.dtype), s_new.to(state.dtype)


def _time_mix_step(p, x, cfg: ModelConfig, state, shift_in):
    """x: (B, D), one token."""
    B, D = x.shape
    H = D // cfg.rwkv_head_size
    r, k, v, w, g = _tmix_rkvwg(p, x, shift_in, cfg)
    wkv, s_new = rwkv6_decode_step(r, k, v, w, p["u"], state)
    out = (L.group_rms_norm(wkv.reshape(B, D), p["ln_x"], H) * g) @ p["wo_t"]
    return out, s_new, x


def _channel_mix(p, x, shifted):
    lerped = x + (shifted - x) * p["mu_cm"]
    k = torch.square(F.relu(lerped @ p["w_cm_k"]))
    return k @ p["w_cm_v"]


def _layer_seq(cfg, p, x, state, shift_t, shift_c):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    att, s_new, new_shift_t = _time_mix_seq(p, h, cfg, state, shift_t)
    x = x + att
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    shifted = torch.cat([shift_c[:, None, :], h[:, :-1]], dim=1)
    x = x + _channel_mix(p, h, shifted)
    return x, s_new, new_shift_t, h[:, -1]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent"}): the token cross-entropy over ``labels`` (B, T) (and
    ``loss_mask``), as the reference's ``loss_fn``. Every layer starts from
    zero states, which nothing writes (autograd keeps the tensors it saved
    intact) and which the loss drops. ``cfg.remat`` recomputes each layer
    in the backward pass."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = L.rms_norm(params["embed"][tokens], params["ln_in"], cfg.norm_eps)
    D, hs = cfg.d_model, cfg.rwkv_head_size
    wkv0 = torch.zeros((B, D // hs, hs, hs), dtype=torch.float32,
                       device=x.device)
    shift0 = torch.zeros((B, D), dtype=L.torch_dtype(cfg.dtype),
                         device=x.device)
    for p in params["layers"]:
        x = L.remat(_layer_seq, cfg.remat, cfg, p, x, wkv0, shift0, shift0)[0]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = L.softmax_xent(h @ params["unembed"], batch["labels"],
                          batch.get("loss_mask"))
    return loss, {"xent": loss}


def init_state(cfg: ModelConfig, batch: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    D = cfg.d_model
    hs = cfg.rwkv_head_size
    dtype = L.torch_dtype(cfg.dtype)
    return {
        "wkv": torch.zeros((cfg.num_layers, batch, D // hs, hs, hs),
                           dtype=torch.float32, device=dev),
        "shift_t": torch.zeros((cfg.num_layers, batch, D), dtype=dtype,
                               device=dev),
        "shift_c": torch.zeros((cfg.num_layers, batch, D), dtype=dtype,
                               device=dev),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """The state stands in for the KV cache: its size does not depend on
    ``max_len``."""
    return init_state(cfg, batch, device=device)



def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Full-sequence forward; returns (last logits (B, V), state)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = L.rms_norm(params["embed"][tokens], params["ln_in"], cfg.norm_eps)
    state = init_state(cfg, B, device=x.device)
    for i, p in enumerate(params["layers"]):
        x, s_new, sh_t, sh_c = _layer_seq(cfg, p, x, state["wkv"][i],
                                          state["shift_t"][i],
                                          state["shift_c"][i])
        state["wkv"][i] = s_new
        state["shift_t"][i] = sh_t
        state["shift_c"][i] = sh_c
    state["lengths"] += T
    h = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return h @ params["unembed"], state


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One-token decode. batch: {"tokens": (B,) int}. Returns (logits (B,
    V), state updated in place with lengths + 1)."""
    x = L.rms_norm(params["embed"][batch["tokens"]], params["ln_in"],
                   cfg.norm_eps)
    for i, p in enumerate(params["layers"]):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        att, s_new, sh_t = _time_mix_step(p, h, cfg, cache["wkv"][i],
                                          cache["shift_t"][i])
        x = x + att
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _channel_mix(p, h, cache["shift_c"][i])
        cache["wkv"][i] = s_new
        cache["shift_t"][i] = sh_t
        cache["shift_c"][i] = h
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["unembed"], {**cache, "lengths": cache["lengths"] + 1}


# ---------------------------------------------------------------------------
# on a model mesh
# ---------------------------------------------------------------------------
def _heads(cfg: ModelConfig, mesh: Mesh):
    """(heads, head size, whether each position holds its model block of
    the heads, each position's first head, the count it holds)."""
    hs = cfg.rwkv_head_size
    H = cfg.d_model // hs
    blocks = [L.heads_of(H, mesh, pos) for pos in range(mesh.size)]
    return (H, hs, L.heads_axis(H, mesh) is not None,
            [lo for lo, _ in blocks], blocks[0][1])


def _tmix_shards(p, xs, shifted, cfg: ModelConfig, mesh: Mesh, states,
                 step: bool):
    """The time mix at every position -> (out, new state) per position, out
    replicated over ``model``. Each position computes its block of the
    heads (all of them where the model width does not divide them): r, k,
    v and g from the column-parallel ``wr``, ``wk_t``, ``wv_t`` and ``wg``,
    the decay from the replicated LoRA cut to its heads' columns, u cut to
    its heads' rows; the scan (``rwkv6_scan``, or ``rwkv6_decode_step`` for
    one token, ``step``) over its heads' state; the group norm per head with
    its heads' slice of ``ln_x`` (``group_rms_norm`` is per head, so no sum
    crosses positions); then ``wo_t`` row-parallel and a ``psum`` over
    ``model``."""
    H, hs, local, los, n = _heads(cfg, mesh)
    width = n * hs
    starts = [lo * hs for lo in los]

    def cols(w):
        return L.model_block(w, 1) if local else spmd.whole(w)

    wr, wk, wv, wg = (cols(p[k]) for k in ("wr", "wk_t", "wv_t", "wg"))
    lora_a = spmd.whole(p["w_lora_a"])
    lora_b = L.cut(p["w_lora_b"], 1, width, starts)
    base = L.cut(p["w_base"], 0, width, starts)
    us = L.cut(p["u"], 0, n, los)
    ln_x = L.cut(p["ln_x"], 0, width, starts)
    mus = {k: spmd.whole(p[k]) for k in ("mu_r", "mu_k", "mu_v", "mu_w",
                                         "mu_g")}
    outs, new_states = [], []
    for pos, (x, sh) in enumerate(zip(xs, shifted)):
        d = sh - x

        def lerp(name):
            return x + d * mus[name][pos]

        def split(t):
            return t.reshape(*t.shape[:-1], n, hs)

        r = split(lerp("mu_r") @ wr[pos])
        k = split(lerp("mu_k") @ wk[pos])
        v = split(lerp("mu_v") @ wv[pos])
        g = F.silu(lerp("mu_g") @ wg[pos])
        w = split(base[pos].to(torch.float32) + (
            torch.tanh(lerp("mu_w") @ lora_a[pos])
            @ lora_b[pos]).to(torch.float32))
        if step:
            wkv, s_new = rwkv6_decode_step(r, k, v, w, us[pos], states[pos])
        else:
            wkv, s_new = ops.rwkv6_scan(r, k, v, w.contiguous(),
                                        us[pos].contiguous(), states[pos])
        wkv = wkv.reshape(*wkv.shape[:-2], width)
        outs.append(L.group_rms_norm(wkv, ln_x[pos], n) * g)
        new_states.append(s_new)
    return L.row_parallel(outs, p["wo_t"], local), new_states


def _cmix_shards(p, xs, shifted, mesh: Mesh):
    """The channel mix at every position, replicated over ``model``:
    ``w_cm_k`` column-parallel where the model width divides d_ff, the
    squared ReLU, ``w_cm_v`` row-parallel and a ``psum``."""
    local = p["w_cm_k"].shape[1] % L.model_width(mesh) == 0
    wk = L.model_block(p["w_cm_k"], 1) if local else spmd.whole(p["w_cm_k"])
    mu = spmd.whole(p["mu_cm"])
    hs = [torch.square(F.relu((x + (sh - x) * m) @ w))
          for x, sh, m, w in zip(xs, shifted, mu, wk)]
    return L.row_parallel(hs, p["w_cm_v"], local)


def _layer_seq_shards(cfg, p, xs, states, shift_t, shift_c, mesh: Mesh):
    """``_layer_seq`` at every position: (x, new state, new time-mix shift,
    new channel-mix shift), each a list over the positions."""
    hs = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, p["ln1"].parts)]
    shifted = [torch.cat([s[:, None, :], h[:, :-1]], dim=1)
               for s, h in zip(shift_t, hs)]
    att, s_new = _tmix_shards(p, hs, shifted, cfg, mesh, states, False)
    xs = spmd.each(torch.add, xs, att)
    h2 = [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(xs, p["ln2"].parts)]
    shifted = [torch.cat([s[:, None, :], h[:, :-1]], dim=1)
               for s, h in zip(shift_c, h2)]
    xs = spmd.each(torch.add, xs, _cmix_shards(p, h2, shifted, mesh))
    return xs, s_new, [h[:, -1] for h in hs], [h[:, -1] for h in h2]


def _embed_shards(params, cfg: ModelConfig, ids):
    return [L.rms_norm(x, g, cfg.norm_eps) for x, g in zip(
        L.embed_shards(params["embed"], ids), params["ln_in"].parts)]


def _zero_states(cfg: ModelConfig, mesh: Mesh, xs):
    """Each position's zero wkv state (B_local, its heads, K, V) and zero
    shift (B_local, D)."""
    _, hs, _, _, n = _heads(cfg, mesh)
    wkv = spmd.each(lambda x: torch.zeros(
        (x.shape[0], n, hs, hs), dtype=torch.float32, device=x.device), xs)
    shift = spmd.each(lambda x: torch.zeros(
        (x.shape[0], cfg.d_model), dtype=L.torch_dtype(cfg.dtype),
        device=x.device), xs)
    return wkv, shift


def sharded_loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    mesh: Mesh):
    """``loss_fn`` on ``mesh`` -> (loss, {"xent"}), 0-d tensors on the mesh's
    first device. ``params`` is a tree of ``Sharded`` placed by
    ``param_shardings``; ``batch`` holds whole tensors, split over the data
    axes by ``data_sharding``. The embedding is vocab-split with a ``psum``
    over ``model``, each layer runs per shard (``_layer_seq_shards``) from
    zero states, the logits stay split by vocab and the cross-entropy takes
    the log-sum-exp across the shards. ``cfg.remat`` recomputes each layer,
    its collectives included, in the backward pass (``spmd.remat``)."""
    B = batch["tokens"].shape[0]
    spec = data_sharding(mesh, 1, B).spec
    batch_axes = axes_of(spec[0])

    def body(params, batch):
        x = _embed_shards(params, cfg, batch["tokens"].parts)
        wkv0, shift0 = _zero_states(cfg, mesh, x)
        for p in params["layers"]:
            x = L.layer_call(lambda q, xs: _layer_seq_shards(
                cfg, q, xs, wkv0, shift0, shift0, mesh)[0], p, x, cfg.remat)
        h = [L.rms_norm(t, g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, split = L.logits_shards(params, cfg, h)
        masks = batch["loss_mask"].parts if "loss_mask" in batch else None
        return L.softmax_xent_shards(logits, batch["labels"].parts, masks,
                                     mesh, split, batch_axes)

    loss = spmd.shard_map(body, mesh, (None, spec), P())(params, batch)
    return loss.parts[0], {"xent": loss.parts[0]}


def _cache_specs(cfg: ModelConfig, mesh: Mesh, B: int):
    return cache_shardings(cfg, mesh, meta_specs(
        lambda: init_state(cfg, B, device="cpu")))


def sharded_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    max_len: int, mesh: Mesh):
    """``prefill`` on ``mesh`` -> (last logits, state). The state is laid
    out by ``launch.sharding.cache_shardings``: ``wkv`` by heads over
    ``model`` where the width divides them (each position keeps the state
    of the heads it computed), ``shift_t`` and ``shift_c`` whole and equal
    at every model position, everything split over the data axes as the
    batch is. Returns the logits as a ``Sharded`` (B, V) split by vocab over
    ``model`` and the state as a dict of ``Sharded``."""
    B, T = batch["tokens"].shape
    spec, _, logit_spec = L.serve_layout(params, cfg, B, mesh,
                                         "sharded_prefill")
    sh = _cache_specs(cfg, mesh, B)

    def body(params, batch):
        x = _embed_shards(params, cfg, batch["tokens"].parts)
        wkv0, shift0 = _zero_states(cfg, mesh, x)
        def stacked(t):
            return torch.zeros((cfg.num_layers,) + t.shape, dtype=t.dtype,
                               device=t.device)
        wkv = spmd.each(stacked, wkv0)
        st, sc = (spmd.each(stacked, shift0) for _ in range(2))
        for i, p in enumerate(params["layers"]):
            x, s_new, sh_t, sh_c = _layer_seq_shards(cfg, p, x, wkv0, shift0,
                                                     shift0, mesh)
            for pos in range(mesh.size):
                wkv[pos][i] = s_new[pos]
                st[pos][i] = sh_t[pos]
                sc[pos][i] = sh_c[pos]
        h = [L.rms_norm(t[:, -1], g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, _ = L.logits_shards(params, cfg, h)
        lengths = spmd.each(lambda t: torch.full(
            (t.shape[0],), T, dtype=torch.int32, device=t.device), h)
        return logits, wkv, st, sc, lengths

    logits, wkv, st, sc, lengths = spmd.shard_map(
        body, mesh, (None, spec), (logit_spec, sh["wkv"].spec,
                                   sh["shift_t"].spec, sh["shift_c"].spec,
                                   sh["lengths"].spec))(params, batch)
    return logits, {"wkv": wkv, "shift_t": st, "shift_c": sc,
                    "lengths": lengths}


def sharded_decode_step(params, cfg: ModelConfig,
                        batch: Dict[str, torch.Tensor], cache, mesh: Mesh):
    """``decode_step`` on ``mesh`` -> (logits, state). ``cache``: the dict of
    ``Sharded`` that ``sharded_prefill`` returns or that ``cache_shardings``
    places. Each position steps its heads' rows of ``wkv`` with
    ``rwkv6_decode_step`` and writes them IN PLACE, as it writes the shifts,
    whole at every model position; lengths + 1."""
    B = batch["tokens"].shape[0]
    spec, batch_axes, logit_spec = L.serve_layout(params, cfg, B, mesh,
                                                  "sharded_decode_step")
    L.check_cache(cache, mesh, batch_axes, B, "sharded_decode_step")
    wkv, st, sc = (cache[k].parts for k in ("wkv", "shift_t", "shift_c"))
    lc = cache["lengths"]

    def body(params, batch):
        x = _embed_shards(params, cfg, batch["tokens"].parts)
        for i, p in enumerate(params["layers"]):
            hs = [L.rms_norm(t, g, cfg.norm_eps)
                  for t, g in zip(x, p["ln1"].parts)]
            att, s_new = _tmix_shards(p, hs, [t[i] for t in st], cfg, mesh,
                                      [t[i] for t in wkv], True)
            x = spmd.each(torch.add, x, att)
            h2 = [L.rms_norm(t, g, cfg.norm_eps)
                  for t, g in zip(x, p["ln2"].parts)]
            x = spmd.each(torch.add, x, _cmix_shards(
                p, h2, [t[i] for t in sc], mesh))
            for pos in range(mesh.size):
                wkv[pos][i] = s_new[pos]
                st[pos][i] = hs[pos]
                sc[pos][i] = h2[pos]
        h = [L.rms_norm(t, g, cfg.norm_eps)
             for t, g in zip(x, params["final_norm"].parts)]
        logits, _ = L.logits_shards(params, cfg, h)
        return logits, [t + 1 for t in lc.parts]

    logits, lengths = spmd.shard_map(body, mesh, (None, spec),
                                     (logit_spec, lc.spec))(params, batch)
    return logits, {**cache, "lengths": lengths}
