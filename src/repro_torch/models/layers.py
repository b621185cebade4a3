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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref

Params = Dict[str, torch.Tensor]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


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
    x's type out."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


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
    if cfg.rope_theta > 0:
        q = rope(q, lengths, cfg.rope_theta)
        k = rope(k, lengths, cfg.rope_theta)
    rows = torch.arange(B, device=k_cache.device)
    at = torch.clamp(lengths, max=k_cache.shape[1] - 1).long()
    k_cache[rows, at] = k.to(k_cache.dtype)
    v_cache[rows, at] = v.to(v_cache.dtype)
    o = ops.decode_attention(q, k_cache, v_cache, lengths + 1)
    out = o.reshape(B, cfg.q_dim) @ p["wo"]
    return out, k_cache, v_cache


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
                          E: int, K: int, C: int) -> torch.Tensor:
    """Capacity dispatch and the experts' FFN over tokens xf (T, D): each
    kept (token, choice) goes to slot ``expert * C + rank`` of an (E * C)
    buffer of token ids, the expert inputs are a gather, the outputs are
    gathered back, weighted by the gate and summed over the K choices in
    xf's type. Choices past capacity scatter into one extra slot that is cut
    off (the reference's ``mode="drop"``) and add nothing."""
    T, D = xf.shape
    eidx = gate_i.reshape(-1)
    tok = torch.arange(T, device=xf.device).repeat_interleave(K)
    keep, slot = moe_slots(eidx, E, C)
    buf = torch.full((E * C + 1,), T, dtype=torch.int64, device=xf.device)
    buf.scatter_(0, torch.where(keep, slot, E * C), tok)
    x_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    expert_in = x_pad[buf[:E * C]].reshape(E, C, D)
    h = F.silu(torch.bmm(expert_in, we_gate)) * torch.bmm(expert_in, we_up)
    expert_out = torch.bmm(h, we_down).reshape(E * C, D)
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

    This is the reference's single-device branch: the port has no mesh, so
    its expert-parallel ``shard_map`` branch is not ported. Every shape is
    fixed by (T, E, K, C): nothing here waits for the device."""
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
