"""Building blocks of the models: init, norms, positions, attention, MLP,
MoE.

Counterpart of the JAX package's ``models/layers.py``. Parameters are plain
dicts of tensors with the JAX layout: a projection is stored (d_in, d_out)
and applied as ``x @ w``. Every cast follows the reference: norms and RoPE
compute in float32 and return the input's type, attention computes in
float32 and returns q's type.

Self-attention goes through ``kernels.ops``: on a CUDA tensor prefill (and
whisper's encoder) runs the ``flash_attention`` kernel and decode the
``decode_attention`` kernel; on a CPU tensor their plain versions run.
Whisper's cross-attention and the MoE dispatch are plain PyTorch on every
device, as they are plain jnp in the reference.

The ``*_shards`` forms run the same blocks on a model mesh
(``launch/mesh.py``), written per shard, Megatron-style: an activation is a
list with one tensor per mesh position, split over the data axes and
replicated over ``model``; weights are ``launch.sharding.Sharded``. Attention
takes the position's heads (``heads_axis``), ``wq``/``wk``/``wv`` and the
MLP's ``w_gate``/``w_up``/``wi`` are column-parallel, ``wo`` and
``w_down``/``wd`` row-parallel followed by a ``psum`` over ``model``. Where
the model width does not divide a head count or a dim, every model position
computes the whole of it from the all-gathered weight, as the reference's
constraints then replicate it. The MoE's expert-parallel branch is the
reference's ``shard_map`` branch. Decode on a mesh
(``attention_decode_shards``) takes the cache as
``launch.sharding.cache_shardings`` lays it out: by KV heads (the heads form)
or, where the model width does not divide them, by rows (the sequence form,
each shard's partial output merged by its log-sum-exp, ``lse_merge``).
``heads_of``, ``cut``, ``rms_norm_shards`` and ``layer_call`` are the
pieces the ssm and hybrid families add: a position's heads, its slice of a
replicated leaf, a norm over a dim split over ``model``, and a layer under
``spmd.remat``; ``group_rms_norm`` is per head and runs on a position's
heads with its slice of the gain as it is. ``cross_kv_shards`` and
``cross_attention_shards`` are whisper's cross-attention in the cross
cache's layout: by heads, by frames (the partials merged by ``lse_merge``)
or whole.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (DATA_AXES, MODEL_AXIS, P, Sharded,
                                         axes_of, data_sharding)
from repro_torch.tree import leaves, map_tree, unflatten

Params = Dict[str, torch.Tensor]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def meta_specs(build: Callable[[], Any]) -> Any:
    """The tree ``build()`` returns, each leaf an empty tensor of its shape
    and type on the ``meta`` device (the reference's ``jax.eval_shape``):
    ``build`` runs on the CPU under a fake-tensor mode, so nothing is
    allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = build()
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


# ---------------------------------------------------------------------------
# initialization: the JAX package's distributions, from a torch.Generator
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """normal * 1/sqrt(d_in), (d_in, d_out), on the generator's device."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    """normal * 0.02, (vocab, d)."""
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary position embedding
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)).to(x.dtype)


def group_rms_norm(x: torch.Tensor, gamma: torch.Tensor, num_heads: int,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMS norm per head over the trailing dim split into ``num_heads``
    (rwkv6's WKV output), then the gain; float32 inside, x's type out."""
    *lead, D = x.shape
    xh = x.reshape(*lead, num_heads, D // num_heads).to(torch.float32)
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    y = (xh * torch.rsqrt(var + eps)).reshape(*lead, D)
    return (y * gamma.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim (population variance), float32 inside,
    x's type out: ``F.layer_norm`` in float32, one fused operation where the
    reference's formula is seven."""
    return F.layer_norm(x.to(torch.float32), x.shape[-1:],
                        gamma.to(torch.float32), beta.to(torch.float32),
                        eps).to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int) -> torch.Tensor:
    """(seq_len, d_model) float32 on the CPU: sin of pos / 10000^(2i/D) in
    the first half, cos in the second, the reference's formula."""
    pos = torch.arange(seq_len, dtype=torch.float32)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0), 2 * dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., H, D) with positions (..., S) or (...,).
    The frequencies follow the reference formula, exp(-log(theta) * i /
    half) in float32."""
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]          # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> Params:
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }


def attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, *, causal: bool = True,
                      return_kv: bool = False):
    """x: (B, S, D). Returns out, and (k, v) after RoPE if ``return_kv``."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ops.attention(q, k, v, causal=causal)
    out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor):
    """One-token decode. x: (B, D); caches (B, Smax, Hkv, Dh); lengths (B,)
    int32 on the caches' device. Returns (out (B, D), k_cache, v_cache).

    The new K/V row is written IN PLACE at ``lengths[b]``, clamped to
    Smax - 1 as the reference's ``dynamic_update_slice`` clamps its start:
    a sequence that runs past Smax keeps overwriting the last row. Attention
    then covers ``lengths + 1`` positions (all Smax once past the end)."""
    B, _ = x.shape
    q = (x @ p["wq"]).reshape(B, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, cfg.num_kv_heads, cfg.head_dim)
    o = _write_and_attend(cfg, q, k, v, k_cache, v_cache, lengths)
    out = o.reshape(B, cfg.q_dim) @ p["wo"]
    return out, k_cache, v_cache


def _write_and_attend(cfg: ModelConfig, q, k, v, k_cache, v_cache,
                      lengths) -> torch.Tensor:
    """RoPE at ``lengths``, the new K/V row written IN PLACE at
    ``lengths[b]`` clamped to Smax - 1, then ``decode_attention`` over
    ``lengths + 1`` rows: q (B, Hq, Dh), k and v (B, Hkv, Dh) -> (B, Hq,
    Dh)."""
    if cfg.rope_theta > 0:
        q = rope(q, lengths, cfg.rope_theta)
        k = rope(k, lengths, cfg.rope_theta)
    rows = torch.arange(q.shape[0], device=k_cache.device)
    at = torch.clamp(lengths, max=k_cache.shape[1] - 1).long()
    k_cache[rows, at] = k.to(k_cache.dtype)
    v_cache[rows, at] = v.to(v_cache.dtype)
    return ops.decode_attention(q, k_cache, v_cache, lengths + 1)


def cross_attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x: (B, Sq, D) or (B, D); k, v: (B, Skv, Hkv, Dh) precomputed by
    ``cross_kv``."""
    single = x.dim() == 2
    if single:
        x = x[:, None, :]
    B, Sq, _ = x.shape
    q = (x @ p["wq"]).reshape(B, Sq, cfg.num_heads, cfg.head_dim)
    # plain float32 PyTorch on every device, as the reference's jnp
    # cross_attention_ref: flash_attention's plain version in full mode,
    # which takes k and v of another length than q
    o = ref.attention_ref(q, k, v, causal=False)
    out = o.reshape(B, Sq, cfg.q_dim) @ p["wo"]
    return out[:, 0] if single else out


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    B, Skv, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    return k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> Params:
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_activation == "swiglu":
        return {
            "w_gate": dense_init(gen, cfg.d_model, Fd, dtype),
            "w_up": dense_init(gen, cfg.d_model, Fd, dtype),
            "w_down": dense_init(gen, Fd, cfg.d_model, dtype),
        }
    return {
        "wi": dense_init(gen, cfg.d_model, Fd, dtype),
        "wd": dense_init(gen, Fd, cfg.d_model, dtype),
    }


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU; else GeLU (the tanh form, as ``jax.nn.gelu``'s default) for
    ``"gelu"`` and relu^2 for any other activation, as the reference."""
    if cfg.mlp_activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["wi"]
    if cfg.mlp_activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = torch.square(F.relu(h))
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# MoE: token-choice top-k with a capacity per expert
# ---------------------------------------------------------------------------
def moe_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """The router (D, E) in float32 whatever ``dtype`` is, and the experts'
    SwiGLU weights (E, D, F), (E, D, F), (E, F, D) in ``dtype``."""
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    return {
        "router": dense_init(gen, D, E, torch.float32),
        "we_gate": experts(D, Fd),
        "we_up": experts(D, Fd),
        "we_down": experts(Fd, D),
    }


def moe_gate(p: Params, xf: torch.Tensor, cfg: ModelConfig):
    """Router, top-K and the Switch aux loss over tokens xf (T, D): (gate
    weights (T, K) in xf's type, expert ids (T, K) int64, aux float32).
    The router runs in float32. The top K come from a stable descending
    sort, so equal probabilities give the lower expert id first, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order among ties)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gw, gi = torch.sort(probs, dim=-1, descending=True, stable=True)
    gw, gi = gw[:, :K], gi[:, :K]
    gw = (gw / (torch.sum(gw, dim=-1, keepdim=True) + 1e-9)).to(xf.dtype)
    me = torch.mean(probs, dim=0)
    n = gi.numel()
    frac = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, gi.reshape(-1), torch.ones(n, dtype=torch.float32,
                                      device=xf.device)) / n
    return gw, gi, E * torch.sum(frac * me)


def moe_slots(eidx: torch.Tensor, E: int, C: int):
    """Each (token, choice)'s rank among the choices of its expert, in token
    order, from a stable argsort and ``searchsorted``: (keep = rank < C,
    slot = expert * C + rank)."""
    n = eidx.numel()
    order = torch.argsort(eidx, stable=True)
    sorted_e = eidx[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=eidx.device))
    rank_sorted = torch.arange(n, device=eidx.device) - start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return rank < C, eidx * C + rank


def _moe_dispatch_compute(xf, gate_w, gate_i, we_gate, we_up, we_down, *,
                          E: int, K: int, C: int, e_lo: int = 0,
                          E_local: Optional[int] = None) -> torch.Tensor:
    """Capacity dispatch and the FFN of experts [e_lo, e_lo + E_local) (all
    E by default; their weights ``we_*`` hold those experts) over tokens xf
    (T, D): each kept (token, choice) goes to slot ``(expert - e_lo) * C +
    rank`` of an (E_local * C) buffer of token ids, the expert inputs are a
    gather, the outputs are gathered back, weighted by the gate and summed
    over the K choices in xf's type. Ranks count every expert's choices, so
    the capacity is the same however the experts are split; a choice past
    capacity or of another position's expert scatters into one extra slot
    that is cut off (the reference's ``mode="drop"``) and adds nothing."""
    T, D = xf.shape
    E_local = E if E_local is None else E_local
    eidx = gate_i.reshape(-1)
    tok = torch.arange(T, device=xf.device).repeat_interleave(K)
    keep, slot = moe_slots(eidx, E, C)
    if E_local != E:
        keep = keep & (eidx >= e_lo) & (eidx < e_lo + E_local)
        slot = slot - e_lo * C
    n = E_local * C
    buf = torch.full((n + 1,), T, dtype=torch.int64, device=xf.device)
    buf.scatter_(0, torch.where(keep, slot, n), tok)
    x_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    expert_in = x_pad[buf[:n]].reshape(E_local, C, D)
    h = F.silu(torch.bmm(expert_in, we_gate)) * torch.bmm(expert_in, we_up)
    expert_out = torch.bmm(h, we_down).reshape(n, D)
    gathered = expert_out[torch.where(keep, slot, 0)]
    w = keep.to(gathered.dtype) * gate_w.reshape(-1).to(gathered.dtype)
    return torch.sum((gathered * w[:, None]).reshape(T, K, D), dim=1)


def moe_experts(p: Params, xf: torch.Tensor, gate_w: torch.Tensor,
                gate_i: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The experts' output (T, D) for tokens xf (T, D) routed by ``gate_w``
    and ``gate_i`` (T, K), with a capacity per expert of ``max(ceil(T * K /
    E * moe_capacity_factor), 1)``. T counts every row of the batch, padding
    included, so a token's output depends on what else is in its batch, as
    in the reference."""
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(int(math.ceil(xf.shape[0] * K / E * cfg.moe_capacity_factor)), 1)
    return _moe_dispatch_compute(xf, gate_w, gate_i, p["we_gate"], p["we_up"],
                                 p["we_down"], E=E, K=K, C=C)


def moe_block(p: Params, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE over x (B, S, D): ``moe_gate``, then
    ``moe_experts`` over the B * S tokens. Returns (out (B, S, D), aux).

    This is the reference's single-device branch; its expert-parallel
    ``shard_map`` branch is ``moe_block_shards``. Every shape is fixed by
    (T, E, K, C): nothing here waits for the device."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gate_w, gate_i, aux = moe_gate(p, xf, cfg)
    return moe_experts(p, xf, gate_w, gate_i, cfg).reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def remat(fn, on: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``) when ``on``: its activations are recomputed in the
    backward pass instead of kept."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, S, V), labels (B, S) int. Log-softmax in float32, then the
    mean of -log p(label) over all positions, or over the positions where
    ``mask`` is nonzero (at least one counted), as the reference."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -torch.mean(ll)
    m = mask.to(torch.float32)
    return -torch.sum(ll * m) / torch.clamp(torch.sum(m), min=1.0)


# ---------------------------------------------------------------------------
# sharded forms: per-shard blocks over a model mesh's positions, in lockstep
# ---------------------------------------------------------------------------
def model_width(mesh: Mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def heads_axis(num_heads: int, mesh: Mesh) -> Optional[str]:
    """``model`` if the mesh has a model axis and its width divides
    ``num_heads``, else None (every model position computes all the
    heads)."""
    if MODEL_AXIS not in mesh.axis_names:
        return None
    return MODEL_AXIS if num_heads % mesh.shape[MODEL_AXIS] == 0 else None


def split_over_model(w: Sharded, dim: int) -> bool:
    """Whether ``w`` is stored split over ``model`` on ``dim`` and on no
    other axis."""
    spec = tuple(w.spec) + (None,) * (len(w.shape) - len(w.spec))
    return all(axes_of(e) == ((MODEL_AXIS,) if i == dim else ())
               for i, e in enumerate(spec))


def model_block(w: Sharded, dim: int) -> List[torch.Tensor]:
    """Each position's block of ``w`` along ``dim`` for its model
    coordinate: its own part where ``w`` is stored so, else cut from the
    all-gathered whole."""
    mesh, tp = w.mesh, model_width(w.mesh)
    if tp > 1 and split_over_model(w, dim):
        return list(w.parts)
    full = spmd.whole(w)
    if tp == 1:
        return full
    n = w.shape[dim] // tp
    return [f.narrow(dim, mesh.coord(pos, MODEL_AXIS) * n, n)
            for pos, f in enumerate(full)]


def row_parallel(hs: List[torch.Tensor], w: Sharded,
                 local: bool) -> List[torch.Tensor]:
    """``h @ w`` at every position, replicated over ``model``. ``local``:
    each h holds the position's model block of w's rows (column-parallel
    activations): the partial products are summed over ``model``. Else each
    h holds every row: where w is stored split over ``model`` by rows, each
    position multiplies its rows' slice of h and the partials are summed;
    otherwise each position computes the whole product."""
    mesh, tp = w.mesh, model_width(w.mesh)
    if local:
        return spmd.psum(spmd.each(torch.matmul, hs, model_block(w, 0)),
                         mesh, MODEL_AXIS)
    if tp > 1 and split_over_model(w, 0):
        n = w.shape[0] // tp
        parts = [h[..., mesh.coord(pos, MODEL_AXIS) * n:][..., :n]
                 @ w.parts[pos] for pos, h in enumerate(hs)]
        return spmd.psum(parts, mesh, MODEL_AXIS)
    return spmd.each(torch.matmul, hs, spmd.whole(w))


def heads_of(num_heads: int, mesh: Mesh, pos: int) -> Tuple[int, int]:
    """(first head, count) of the heads position ``pos`` computes: its model
    block where ``heads_axis`` gives ``model``, else all of them. No
    position ever holds part of a head."""
    if heads_axis(num_heads, mesh) is None:
        return 0, num_heads
    n = num_heads // model_width(mesh)
    return mesh.coord(pos, MODEL_AXIS) * n, n


def cut(w: Sharded, dim: int, size: int,
        starts: List[int]) -> List[torch.Tensor]:
    """Each position's ``size`` entries of ``w`` along ``dim`` from
    ``starts[pos]``, cut from its whole copy (a replicated leaf's own
    part)."""
    return [f.narrow(dim, s, size) for f, s in zip(spmd.whole(w), starts)]


def rms_norm_shards(ys: List[torch.Tensor], gammas: List[torch.Tensor],
                    eps: float, dim: int, mesh: Mesh,
                    split: bool) -> List[torch.Tensor]:
    """``rms_norm`` over a last dim of ``dim`` entries. ``split``: each
    position holds its model block of them (and of the gain), and the
    float32 sums of squares are summed over ``model`` before the division,
    so every block is normalised by the whole dim's mean; else each holds
    all of them."""
    if not split:
        return [rms_norm(y, g, eps) for y, g in zip(ys, gammas)]
    yfs = [y.to(torch.float32) for y in ys]
    sums = spmd.psum([torch.sum(yf * yf, dim=-1, keepdim=True) for yf in yfs],
                     mesh, MODEL_AXIS)
    return [(yf * torch.rsqrt(s / dim + eps) * g.to(torch.float32)).to(y.dtype)
            for y, yf, s, g in zip(ys, yfs, sums, gammas)]


def layer_call(fn: Callable, p, xs: List[torch.Tensor],
               on: bool) -> List[torch.Tensor]:
    """``fn(p, xs)``, a lockstep layer from the per-position activations
    ``xs`` and a tree ``p`` of ``Sharded`` leaves to a flat list of
    per-position tensors, under ``spmd.remat`` when ``on``: its inputs
    flattened to the activations and every position's parameter parts, the
    parameters rebuilt around the recomputed run's copies."""
    params = leaves(p)
    n = len(xs)

    def run(flat):
        parts = iter(flat[n:])
        q = unflatten(p, [Sharded(w.mesh, w.spec, w.shape,
                                  [next(parts) for _ in w.parts])
                          for w in params])
        return fn(q, flat[:n])

    flat = list(xs) + [t for w in params for t in w.parts]
    return spmd.remat(run, flat) if on else run(flat)


def _kv_heads_for(k, v, lo: int, hq: int, group: int):
    """The KV heads that query heads [lo, lo + hq) read (head h reads KV
    head h // group), in the layout ``ops.attention`` takes: a contiguous
    run when each is read by hq / n consecutive query heads, else one per
    query head."""
    need = [(lo + i) // group for i in range(hq)]
    first, n = need[0], need[-1] - need[0] + 1
    if hq % n == 0 and need == [first + i // (hq // n) for i in range(hq)]:
        return (k[:, :, first:first + n].contiguous(),
                v[:, :, first:first + n].contiguous())
    idx = torch.tensor(need, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def attention_prefill_shards(p, xs: List[torch.Tensor], cfg: ModelConfig,
                             positions: List[torch.Tensor], mesh: Mesh, *,
                             causal: bool = True, return_kv: bool = False):
    """``attention_prefill`` per shard: x (B_local, S, D) at every position
    -> out (B_local, S, D), replicated over ``model``. A position computes
    its model block of the query heads when ``heads_axis`` gives ``model``
    (else all of them) and the KV heads those read; the reference's
    constraints put q, k and v on the same heads. With ``return_kv`` also
    each position's (k, v) after RoPE, (B_local, S, Hkv_local, Dh), as it
    computed them for the cache: its block of the KV heads where the model
    width divides them, else every KV head (taken before the heads its
    queries read are picked)."""
    tp = model_width(mesh)
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_local = heads_axis(H, mesh) is not None
    kv_local = q_local and heads_axis(Hkv, mesh) is not None
    hq = H // tp if q_local else H
    wq = model_block(p["wq"], 1) if q_local else spmd.whole(p["wq"])
    wk, wv = ((model_block(p[n], 1) if kv_local else spmd.whole(p[n]))
              for n in ("wk", "wv"))
    outs, kvs = [], []
    for pos, x in enumerate(xs):
        B, S, _ = x.shape
        q = (x @ wq[pos]).reshape(B, S, hq, Dh)
        k = (x @ wk[pos]).reshape(B, S, -1, Dh)
        v = (x @ wv[pos]).reshape(B, S, -1, Dh)
        if cfg.rope_theta > 0:
            q = rope(q, positions[pos], cfg.rope_theta)
            k = rope(k, positions[pos], cfg.rope_theta)
        kvs.append((k, v))
        if q_local and not kv_local:
            k, v = _kv_heads_for(k, v, mesh.coord(pos, MODEL_AXIS) * hq, hq,
                                 H // Hkv)
        o = ops.attention(q, k, v, causal=causal)
        outs.append(o.reshape(B, S, hq * Dh))
    out = row_parallel(outs, p["wo"], q_local)
    return (out, kvs) if return_kv else out


def all_columns(xs: List[torch.Tensor], w: Sharded) -> List[torch.Tensor]:
    """``x @ w`` with every output column at every position: where the
    model width divides w's columns, each position multiplies its block
    (column-parallel) and the products are all-gathered over ``model``;
    else each position multiplies the all-gathered w."""
    mesh, tp = w.mesh, model_width(w.mesh)
    if tp > 1 and w.shape[1] % tp == 0:
        return spmd.all_gather(spmd.each(torch.matmul, xs, model_block(w, 1)),
                               mesh, MODEL_AXIS, -1)
    return spmd.each(torch.matmul, xs, spmd.whole(w))


def attention_decode_shards(p, xs: List[torch.Tensor], cfg: ModelConfig,
                            k_caches: List[torch.Tensor],
                            v_caches: List[torch.Tensor],
                            lengths: List[torch.Tensor], mesh: Mesh,
                            cache_spec) -> List[torch.Tensor]:
    """``attention_decode`` per shard: x (B_local, D) at every position ->
    out (B_local, D), replicated over ``model``. ``k_caches``/``v_caches``:
    each position's block of one layer's cache, laid out by ``cache_spec``
    (the (L, B, S, Hkv, Dh) spec of ``launch.sharding.cache_shardings``);
    ``lengths``: each position's (B_local,) int32. The new row is written IN
    PLACE at ``lengths[b]``, clamped to Smax - 1 as ``attention_decode``
    clamps it.

    Heads form (the cache's KV heads over ``model``, or not split at all): a
    position holds its block of the query and KV heads (all of them when
    the cache is not split) and every row; it writes the row, launches
    ``decode_attention`` on its block, and ``row_parallel`` over ``wo``
    follows. Sequence form (the rows over ``model``: the width does not
    divide the KV heads): position j holds rows [j R, (j + 1) R) of every
    KV head, R = Smax / m; every query head's q and the new k and v come
    whole to every position (column-parallel products all-gathered over
    ``model``, or the all-gathered weight where the width does not divide
    its columns); only the position that owns the clamped row writes it;
    each launches ``decode_attention_lse`` over its rows with lengths
    clamp(lengths + 1 - j R, 0, R), and the partials merge over ``model`` in
    fixed mesh order: M = max lse, o = sum 2^(lse_j - M) o_j / sum 2^(lse_j -
    M) (lse in log2 units). A position with no valid row gives zeros and lse
    -inf, which weighs nothing."""
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = tuple(cache_spec) + (None,) * (5 - len(cache_spec))
    if MODEL_AXIS not in axes_of(spec[2]):
        split = MODEL_AXIS in axes_of(spec[3]) and model_width(mesh) > 1
        cols = ((lambda w: model_block(w, 1)) if split else spmd.whole)
        wq, wk, wv = (cols(p[n]) for n in ("wq", "wk", "wv"))
        outs = []
        for pos, x in enumerate(xs):
            B = x.shape[0]
            o = _write_and_attend(cfg, (x @ wq[pos]).reshape(B, -1, Dh),
                                  (x @ wk[pos]).reshape(B, -1, Dh),
                                  (x @ wv[pos]).reshape(B, -1, Dh),
                                  k_caches[pos], v_caches[pos], lengths[pos])
            outs.append(o.reshape(B, -1))
        return row_parallel(outs, p["wo"], split)

    qs = all_columns(xs, p["wq"])
    ks = all_columns(xs, p["wk"])
    vs = all_columns(xs, p["wv"])
    parts, lses = [], []
    for pos, x in enumerate(xs):
        B = x.shape[0]
        kc, vc, n = k_caches[pos], v_caches[pos], lengths[pos]
        R = kc.shape[1]
        lo = mesh.coord(pos, MODEL_AXIS) * R
        q = qs[pos].reshape(B, H, Dh)
        k = ks[pos].reshape(B, Hkv, Dh)
        v = vs[pos].reshape(B, Hkv, Dh)
        if cfg.rope_theta > 0:
            q = rope(q, n, cfg.rope_theta)
            k = rope(k, n, cfg.rope_theta)
        rows = torch.arange(B, device=kc.device)
        at = torch.clamp(n, max=R * model_width(mesh) - 1).long()
        own = ((at >= lo) & (at < lo + R))[:, None, None]
        idx = torch.clamp(at - lo, 0, R - 1)
        kc[rows, idx] = torch.where(own, k.to(kc.dtype), kc[rows, idx])
        vc[rows, idx] = torch.where(own, v.to(vc.dtype), vc[rows, idx])
        o, lse = ops.decode_attention_lse(q, kc, vc,
                                          torch.clamp(n + 1 - lo, 0, R))
        parts.append(o)
        lses.append(lse)
    outs = [o.to(x.dtype).reshape(x.shape[0], H * Dh)
            for o, x in zip(lse_merge(parts, lses, mesh), xs)]
    return row_parallel(outs, p["wo"], False)


def lse_merge(parts: List[torch.Tensor], lses: List[torch.Tensor],
              mesh: Mesh, axis: str = MODEL_AXIS) -> List[torch.Tensor]:
    """Partial attention outputs (B, H, Dh), each normalised over its own
    keys, merged over ``axis`` by their log-sum-exps (B, H) in log2 units:
    M = max lse over the group, then sum 2^(lse_j - M) o_j / sum 2^(lse_j -
    M), both sums in float32 in fixed mesh order (``spmd.psum``). A partial
    with lse -inf (no valid key) weighs nothing; a group with none at all
    gives zeros. Every member of a group gets the merged float32 output."""
    top = spmd.pmax(lses, mesh, axis)
    ws = [torch.exp2(lse - torch.where(torch.isinf(t), 0.0, t))
          for lse, t in zip(lses, top)]
    num = spmd.psum([w[..., None] * o.to(torch.float32)
                     for w, o in zip(ws, parts)], mesh, axis)
    den = spmd.psum(ws, mesh, axis)
    return [a / torch.clamp(d, min=1e-30)[..., None]
            for a, d in zip(num, den)]


def _cross_form(spec) -> str:
    """Which dim of a cross cache laid out by ``spec`` (the (L, B, S_enc,
    Hkv, Dh) spec of ``launch.sharding.cache_shardings``) is split over
    ``model``: ``"heads"``, ``"frames"`` or ``"whole"``."""
    spec = tuple(spec) + (None,) * (5 - len(spec))
    if MODEL_AXIS in axes_of(spec[3]):
        return "heads"
    return "frames" if MODEL_AXIS in axes_of(spec[2]) else "whole"


def cross_kv_shards(p, enc_outs: List[torch.Tensor], cfg: ModelConfig,
                    mesh: Mesh, spec):
    """``cross_kv`` per shard: the encoder's output (B_local, S_enc, D) at
    every position, replicated over ``model`` -> each position's block of
    one layer's cross K and V as the cross cache's ``spec`` lays them out:
    its KV heads (``wk``/``wv``'s column block) over every frame, or every
    KV head over its frames, (B_local, S_enc / m, Hkv, Dh), from the
    all-gathered weights, or every head over every frame."""
    form, Dh = _cross_form(spec), cfg.head_dim
    if form == "heads":
        wk, wv = model_block(p["wk"], 1), model_block(p["wv"], 1)
    else:
        wk, wv = spmd.whole(p["wk"]), spmd.whole(p["wv"])
    if form == "frames":
        R = enc_outs[0].shape[1] // model_width(mesh)
        enc_outs = [e[:, mesh.coord(pos, MODEL_AXIS) * R:][:, :R]
                    for pos, e in enumerate(enc_outs)]
    ks, vs = [], []
    for e, a, b in zip(enc_outs, wk, wv):
        B, S, _ = e.shape
        ks.append((e @ a).reshape(B, S, -1, Dh))
        vs.append((e @ b).reshape(B, S, -1, Dh))
    return ks, vs


def cross_attention_shards(p, xs: List[torch.Tensor], cfg: ModelConfig,
                           ks: List[torch.Tensor], vs: List[torch.Tensor],
                           mesh: Mesh, spec) -> List[torch.Tensor]:
    """``cross_attention`` per shard: x (B_local, Sq, D) or (B_local, D) at
    every position -> out of the same shape, replicated over ``model``;
    ``ks``/``vs`` each position's block as ``cross_kv_shards`` gives it for
    ``spec``. Plain float32 PyTorch (``ref.attention_ref``) on every device,
    as unsharded. Heads: each position attends with its block of the query
    heads (``wq``'s column block), and ``row_parallel`` over ``wo`` sums the
    blocks. Frames: every query head at every position (``all_columns``)
    over the position's frames; each partial, normalised over its own
    frames, and its log-sum-exp (``ref.attention_lse_ref``) stay float32
    and merge over ``model`` (``lse_merge``). Whole: every head over every
    frame at every position."""
    single = xs[0].dim() == 2
    if single:
        xs = [x[:, None, :] for x in xs]
    form, Dh = _cross_form(spec), cfg.head_dim
    qs = (spmd.each(torch.matmul, xs, model_block(p["wq"], 1))
          if form == "heads" else all_columns(xs, p["wq"]))
    outs, lses = [], []
    for x, q, k, v in zip(xs, qs, ks, vs):
        B, Sq, _ = x.shape
        q = q.reshape(B, Sq, -1, Dh)
        if form == "frames":
            q = q.to(torch.float32)
            lses.append(ref.attention_lse_ref(q, k, causal=False)
                        .transpose(1, 2))
        outs.append(ref.attention_ref(q, k, v, causal=False))
    if form == "frames":
        outs = lse_merge(outs, lses, mesh)
    outs = [o.to(x.dtype).reshape(x.shape[0], x.shape[1], -1)
            for o, x in zip(outs, xs)]
    out = row_parallel(outs, p["wo"], form == "heads")
    return [o[:, 0] for o in out] if single else out


def mlp_block_shards(p, xs: List[torch.Tensor], cfg: ModelConfig,
                     mesh: Mesh) -> List[torch.Tensor]:
    """``mlp_block`` per shard: the hidden dim over ``model`` where the
    model width divides it (the rules then store the weights so), else all
    of it at every position."""
    up = p["w_gate"] if cfg.mlp_activation == "swiglu" else p["wi"]
    local = up.shape[1] % model_width(mesh) == 0

    def cols(w):
        return model_block(w, 1) if local else spmd.whole(w)

    if cfg.mlp_activation == "swiglu":
        hs = spmd.each(lambda x, a, b: F.silu(x @ a) * (x @ b), xs,
                       cols(p["w_gate"]), cols(p["w_up"]))
        return row_parallel(hs, p["w_down"], local)
    hs = spmd.each(torch.matmul, xs, cols(p["wi"]))
    if cfg.mlp_activation == "gelu":
        hs = [F.gelu(h, approximate="tanh") for h in hs]
    else:
        hs = [torch.square(F.relu(h)) for h in hs]
    return row_parallel(hs, p["wd"], local)


def _gathered_but(w: Sharded, keep: int) -> List[torch.Tensor]:
    """Each position's part of ``w`` all-gathered over every axis that
    splits a dim other than ``keep`` (the experts' FSDP dim)."""
    parts = list(w.parts)
    for dim, e in enumerate(w.spec):
        if dim != keep and axes_of(e):
            parts = spmd.all_gather(parts, w.mesh, axes_of(e), dim)
    return parts


def moe_block_shards(p, xs: List[torch.Tensor], cfg: ModelConfig,
                     mesh: Mesh, batch_axes: Tuple[str, ...]):
    """``moe_block`` on a mesh -> (out per position, aux per position, both
    replicated over ``model``). ``batch_axes``: the data axes the batch is
    split over (none when ``data_sharding`` replicated it).

    With a model axis whose width divides E, the reference's expert-parallel
    branch: routing, top-K and the aux loss on each data shard's tokens
    (T_local = T / dp), the capacity ``max(ceil(T_local * K / E * cf), 1)``,
    aux averaged over the data axes, each model position the FFN of its E /
    tp experts (their FSDP dim all-gathered over the data axes) on its data
    shard's tokens, the partial outputs summed over ``model`` in the
    activations' type. A batch the data width does not divide raises a
    ``ValueError``, where the reference's ``shard_map`` fails. Otherwise the
    reference's global branch: every position routes all the batch's tokens
    through all the experts and keeps its own rows."""
    E, K = cfg.num_experts, cfg.experts_per_token
    tp = model_width(mesh)
    dp_axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    B, S, D = xs[0].shape
    if MODEL_AXIS in mesh.axis_names and E % tp == 0:
        if mesh.axis_size(dp_axes) > 1 and tuple(batch_axes) != dp_axes:
            raise ValueError(f"moe_block: the expert-parallel branch splits "
                             f"the batch over {dp_axes} "
                             f"({mesh.axis_size(dp_axes)} ways), which "
                             "does not divide it")
        E_local = E // tp
        C = max(int(math.ceil(B * S * K / E * cfg.moe_capacity_factor)), 1)
        wg, wu, wd = (_gathered_but(p[n], 0)
                      for n in ("we_gate", "we_up", "we_down"))
        ys, auxs = [], []
        for pos, x in enumerate(xs):
            xl = x.reshape(B * S, D)
            gw, gi, aux = moe_gate({"router": p["router"].parts[pos]}, xl,
                                   cfg)
            e_lo = spmd.axis_index(mesh, pos, MODEL_AXIS) * E_local
            y = _moe_dispatch_compute(xl, gw, gi, wg[pos], wu[pos], wd[pos],
                                      E=E, K=K, C=C, e_lo=e_lo,
                                      E_local=E_local)
            ys.append(y.to(x.dtype))
            auxs.append(aux)
        ys = spmd.psum(ys, mesh, MODEL_AXIS)
        return ([y.reshape(B, S, D) for y in ys],
                spmd.pmean(auxs, mesh, dp_axes))
    full = spmd.all_gather(list(xs), mesh, batch_axes, 0)
    experts = {n: spmd.whole(p[n]) for n in ("router", "we_gate", "we_up",
                                             "we_down")}
    ys, auxs = [], []
    for pos, x in enumerate(full):
        y, aux = moe_block({n: w[pos] for n, w in experts.items()}, x, cfg)
        ys.append(y[mesh.index_over(pos, batch_axes) * B:][:B])
        auxs.append(aux)
    return ys, auxs


def embed_shards(embed: Sharded,
                 ids: List[torch.Tensor]) -> List[torch.Tensor]:
    """The token embeddings at every position, replicated over ``model``:
    with the vocab split over ``model``, each position looks up the ids in
    its range (zeros for the others) and the rows are summed over
    ``model``."""
    mesh, tp = embed.mesh, model_width(embed.mesh)
    if not (tp > 1 and split_over_model(embed, 0)):
        return spmd.each(lambda w, t: w[t], spmd.whole(embed), ids)
    n = embed.shape[0] // tp
    outs = []
    for pos, t in enumerate(ids):
        lo = mesh.coord(pos, MODEL_AXIS) * n
        inside = (t >= lo) & (t < lo + n)
        rows = embed.parts[pos][torch.clamp(t - lo, 0, n - 1)]
        outs.append(rows * inside[..., None].to(rows.dtype))
    return spmd.psum(outs, mesh, MODEL_AXIS)


def softmax_xent_shards(logits: List[torch.Tensor],
                        labels: List[torch.Tensor],
                        masks: Optional[List[torch.Tensor]], mesh: Mesh,
                        vocab_split: bool,
                        batch_axes: Tuple[str, ...]) -> List[torch.Tensor]:
    """``softmax_xent`` over logits split over ``model`` by vocab when
    ``vocab_split`` (each position holds V / tp columns): the log-sum-exp
    from the cross-shard max and the summed exponentials, the label's logit
    from the position whose range holds it; then the sum of -log p over the
    whole batch (over ``batch_axes``) divided by the number of positions, or
    by the masked count (at least one), never a mean of shard means."""
    tp = model_width(mesh)
    lfs = [lg.to(torch.float32) for lg in logits]
    tops = [lf.amax(dim=-1) for lf in lfs]
    if vocab_split:
        tops = spmd.pmax(tops, mesh, MODEL_AXIS)
    else:
        tops = [t.detach() for t in tops]
    sums = [torch.sum(torch.exp(lf - t[..., None]), dim=-1)
            for lf, t in zip(lfs, tops)]
    picked = []
    for pos, (lf, y) in enumerate(zip(lfs, labels)):
        y = y.long()
        if vocab_split:
            n = lf.shape[-1]
            lo = mesh.coord(pos, MODEL_AXIS) * n
            inside = (y >= lo) & (y < lo + n)
            got = torch.gather(lf, -1, torch.clamp(y - lo, 0, n - 1)[..., None])
            picked.append(got[..., 0] * inside.to(torch.float32))
        else:
            picked.append(torch.gather(lf, -1, y[..., None])[..., 0])
    if vocab_split and tp > 1:
        sums = spmd.psum(sums, mesh, MODEL_AXIS)
        picked = spmd.psum(picked, mesh, MODEL_AXIS)
    lls = [pk - (t + torch.log(s)) for pk, t, s in zip(picked, tops, sums)]
    if masks is None:
        num = [torch.sum(ll) for ll in lls]
        den = [torch.tensor(float(ll.numel()), device=ll.device) for ll in lls]
    else:
        ms = [m.to(torch.float32) for m in masks]
        num = [torch.sum(ll * m) for ll, m in zip(lls, ms)]
        den = [torch.sum(m) for m in ms]
    num = spmd.psum(num, mesh, batch_axes)
    den = spmd.psum(den, mesh, batch_axes)
    return [-a / torch.clamp(b, min=1.0) for a, b in zip(num, den)]


def logits_shards(params, cfg: ModelConfig, hs: List[torch.Tensor], *,
                  tied: Optional[bool] = None):
    """(logits per position, whether they hold the position's vocab block
    over ``model``): ``h @ unembed`` (or the tied ``embed``'s transpose)
    with the vocab split as the weight is stored, then the soft cap.
    ``tied`` overrides ``cfg.tie_embeddings``: whisper reads the embedding's
    transpose whatever its config says."""
    tied = cfg.tie_embeddings if tied is None else tied
    w = params["embed"] if tied else params["unembed"]
    vdim = 0 if tied else 1
    split = model_width(w.mesh) > 1 and split_over_model(w, vdim)
    ws = w.parts if split else spmd.whole(w)
    logits = [h @ (x.T if tied else x) for h, x in zip(hs, ws)]
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = [torch.tanh(lg / c) * c for lg in logits]
    return logits, split


def serve_layout(params, cfg: ModelConfig, B: int, mesh: Mesh, what: str,
                 *, tied: Optional[bool] = None):
    """(the batch's spec, its data axes, the logits' spec) of a serve call
    on ``mesh``: the batch over the data axes unless their width does not
    divide B (``data_sharding``); the logits (B, V) as the reference's
    ``constrain(logits, DATA, MODEL)``, the vocab over ``model`` where the
    unembedding (the embedding when ``tied``, by default
    ``cfg.tie_embeddings``) is stored split so. Parameters not placed on
    ``mesh`` are refused."""
    tied = cfg.tie_embeddings if tied is None else tied
    w = params["embed"] if tied else params["unembed"]
    if not isinstance(w, Sharded) or w.mesh != mesh:
        raise ValueError(f"{what}: the parameters must be placed on the "
                         "active mesh: place_tree(params, mesh, "
                         "param_shardings(mesh, params))")
    spec = data_sharding(mesh, 1, B).spec
    split = model_width(mesh) > 1 and split_over_model(w, 0 if tied else 1)
    return spec, axes_of(spec[0]), P(spec[0], MODEL_AXIS if split else None)


def check_cache(cache, mesh: Mesh, batch_axes, B: int, what: str) -> None:
    """Refuse a cache some leaf of which is not placed on ``mesh``, or
    whose ``lengths`` split the batch over other axes than the batch of
    ``B`` goes over."""
    if not all(isinstance(c, Sharded) and c.mesh == mesh
               for c in cache.values()):
        raise ValueError(f"{what}: the cache must be placed on the active "
                         "mesh (launch.sharding.cache_shardings)")
    lc = cache["lengths"]
    if axes_of(lc.spec[0] if lc.spec else None) != tuple(batch_axes):
        raise ValueError(f"{what}: the cache splits its batch over "
                         f"{axes_of(lc.spec[0]) if lc.spec else ()}, the "
                         f"batch of {B} goes over {tuple(batch_axes)}")


def kv_block(t: torch.Tensor, region, S: int,
             num_kv_heads: int) -> torch.Tensor:
    """A position's block of one layer's K or V for a cache padded past the
    S prompt rows: ``t`` (B_local, S, Hkv or the position's KV-head block,
    Dh) as ``attention_prefill_shards`` returns it, ``region`` the
    position's slices of the (L, B, Smax, Hkv, Dh) cache -> (B_local, its
    rows, its heads, Dh), zeros past S."""
    rows, heads = region[2], region[3]
    if t.shape[2] == num_kv_heads:
        t = t[:, :, heads]
    out = t.new_zeros((t.shape[0], rows.stop - rows.start) + t.shape[2:])
    got = t[:, rows.start:min(rows.stop, S)]
    out[:, :got.shape[1]] = got
    return out
