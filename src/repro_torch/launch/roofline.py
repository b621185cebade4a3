"""Three-term roofline analysis on one NVIDIA H100 SXM.

    compute term    = FLOPs / (devices x 989 TFLOP/s, dense bf16)
    memory term     = HBM bytes / (devices x 3.35 TB/s)
    collective term = collective bytes / 450 GB/s

The peaks are NVIDIA's data sheet figures for the H100 SXM (80 GB HBM3,
700 W): 989e12 FLOP/s of dense bf16 on the tensor cores (``PEAK_FLOPS``),
67e12 FLOP/s of float32 outside them (``PEAK_FLOPS_FP32``), 3.35e12 bytes/s
of HBM (``HBM_BW``), and NVLink 4's 900 GB/s of a card, 450e9 bytes/s in
each direction (``LINK_BW``, one direction: what a card sends while it also
receives). On one card the collective term is 0.

Counterpart of the JAX package's ``launch/roofline.py``: the analytic FLOP
and byte counts below are its arithmetic over the port's own ``ModelConfig``
and ``ShapeConfig``, and give the same numbers; only the peaks are the
card's. MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); the ratio
MODEL_FLOPS / the analytic FLOPs (``hlo_equiv``, the JAX package's name:
forward, backward and remat) exposes remat recompute, attention, and MoE
capacity waste.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.config import ModelConfig, ShapeConfig

# NVIDIA H100 SXM (data sheet; dense rates, no sparsity)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s per card
PEAK_FLOPS_FP32 = 67e12      # float32 FLOP/s per card, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink 4 bytes/s per card, one direction


# ---------------------------------------------------------------------------
# analytic FLOPs (per-token forward, whole model)
# ---------------------------------------------------------------------------
def _attn_flops_per_tok(cfg: ModelConfig, ctx: float) -> float:
    """qk^T + pv for one token attending to `ctx` keys."""
    return 2 * cfg.num_heads * cfg.head_dim * ctx * 2


def _dense_layer_flops(cfg: ModelConfig, ctx: float) -> float:
    proj = 2 * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * cfg.q_dim * cfg.d_model
    mlp_mats = 3 if cfg.mlp_activation == "swiglu" else 2
    mlp = mlp_mats * 2 * cfg.d_model * cfg.d_ff
    return proj + _attn_flops_per_tok(cfg, ctx) + mlp


def _moe_layer_flops(cfg: ModelConfig, ctx: float) -> float:
    proj = 2 * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * cfg.q_dim * cfg.d_model
    router = 2 * cfg.d_model * cfg.num_experts
    experts = 3 * 2 * cfg.d_model * cfg.d_ff * cfg.experts_per_token * cfg.moe_capacity_factor
    return proj + _attn_flops_per_tok(cfg, ctx) + router + experts


def _rwkv_layer_flops(cfg: ModelConfig) -> float:
    D = cfg.d_model
    proj = 5 * 2 * D * D + 2 * D * 64 + 2 * 64 * D
    wkv = 5 * D * cfg.rwkv_head_size
    cmix = 2 * 2 * D * cfg.d_ff
    return proj + wkv + cmix


def _mamba_layer_flops(cfg: ModelConfig) -> float:
    D, Din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    H = Din // cfg.ssm_head_dim
    proj = 2 * D * (2 * Din + 2 * N + H) + 2 * Din * D
    conv = 2 * cfg.ssm_conv_width * (Din + 2 * N)
    ssd = 5 * Din * N
    return proj + conv + ssd


def fwd_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    """Whole-model forward FLOPs for ONE decoder token with context `ctx`."""
    unembed = 2 * cfg.d_model * cfg.vocab_size
    if cfg.family in ("dense", "vlm"):
        return cfg.num_layers * _dense_layer_flops(cfg, ctx) + unembed
    if cfg.family == "moe":
        return cfg.num_layers * _moe_layer_flops(cfg, ctx) + unembed
    if cfg.family == "ssm":
        return cfg.num_layers * _rwkv_layer_flops(cfg) + unembed
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // max(cfg.attn_every, 1)
        shared = _dense_layer_flops(cfg, ctx)
        return cfg.num_layers * _mamba_layer_flops(cfg) + n_attn * shared + unembed
    if cfg.family == "encdec":
        # decoder token: self-attn + cross-attn + mlp
        proj = 2 * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * cfg.q_dim * cfg.d_model
        mlp = 2 * 2 * cfg.d_model * cfg.d_ff
        cross = 2 * cfg.d_model * cfg.q_dim + 2 * cfg.q_dim * cfg.d_model \
            + _attn_flops_per_tok(cfg, cfg.encoder_seq_len)
        per_tok = cfg.num_layers * (proj + _attn_flops_per_tok(cfg, ctx) + cross + mlp)
        return per_tok + unembed
    raise ValueError(cfg.family)


def encoder_flops(cfg: ModelConfig) -> float:
    """Whisper encoder (runs once per prefill/train step, per sequence)."""
    if cfg.family != "encdec":
        return 0.0
    Senc = cfg.encoder_seq_len
    proj = 2 * cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * cfg.q_dim * cfg.d_model
    mlp = 2 * 2 * cfg.d_model * cfg.d_ff
    per_tok = proj + _attn_flops_per_tok(cfg, Senc) + mlp
    cross_kv = 2 * cfg.d_model * cfg.kv_dim * 2 * cfg.num_layers  # per enc token
    return Senc * (cfg.encoder_layers * per_tok + cross_kv)


@dataclass
class FlopsReport:
    fwd_total: float          # whole step, all devices
    hlo_equiv: float          # incl. train backward (+ remat recompute)
    model_flops: float        # 6·N(active)·D  (spec definition)


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> FlopsReport:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        ctx = float(S)
        tokens = B  # one new token per sequence
        fwd = tokens * fwd_flops_per_token(cfg, ctx)
    else:
        ctx = (S + 1) / 2  # causal average
        tokens = B * S
        fwd = tokens * fwd_flops_per_token(cfg, ctx) + B * encoder_flops(cfg)
    if shape.is_train:
        mult = 4.0 if cfg.remat else 3.0   # fwd + 2x bwd (+ remat refwd)
    else:
        mult = 1.0
    n_active = cfg.param_count(active_only=True)
    if shape.is_train:
        model = 6.0 * n_active * tokens
    else:
        model = 2.0 * n_active * tokens
    return FlopsReport(fwd_total=fwd, hlo_equiv=fwd * mult, model_flops=model)


# ---------------------------------------------------------------------------
# analytic HBM bytes (per device per step, leading terms)
# ---------------------------------------------------------------------------
@dataclass
class BytesReport:
    weights: float
    optimizer: float
    activations: float
    cache: float
    total: float


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig, *, num_devices: int,
                   tp: int, microbatches: int = 1) -> BytesReport:
    B, S = shape.global_batch, shape.seq_len
    p_bytes = cfg.param_count() * 2  # bf16
    p_local = p_bytes / tp
    dp = num_devices // tp

    if shape.is_train:
        weights = p_local * 3.0 * microbatches   # fwd + bwd(dW, dX) re-reads
        if cfg.remat:
            weights += p_local * microbatches
        # AdamW: m,v fp32 read+write (ZeRO-1: sharded over all devices),
        # fp32 grads read+write on the TP shard
        opt = (cfg.param_count() * 4 * 4) / num_devices + (cfg.param_count() * 4 * 2) / tp
    else:
        weights = p_local
        opt = 0.0

    tokens_local = (B / dp) * (1 if shape.kind == "decode" else S)
    act_tensors = 10.0  # materialized per layer (resid, norms, proj, mlp, ...)
    act = tokens_local * cfg.d_model * 2 * act_tensors * cfg.num_layers
    if shape.is_train:
        act *= 2.0  # backward re-touches activations

    cache = 0.0
    if shape.kind == "decode":
        b_local = B / dp
        if cfg.family in ("dense", "moe", "vlm"):
            cache = cfg.num_layers * b_local * S * cfg.kv_dim * 2 * 2  # k+v, bf16
            cache /= tp  # heads-sharded if divisible, else sequence-sharded
        elif cfg.family == "ssm":
            H = cfg.d_model // cfg.rwkv_head_size
            cache = cfg.num_layers * b_local * H * cfg.rwkv_head_size ** 2 * 4 * 2 / tp
        elif cfg.family == "hybrid":
            Din, N = cfg.d_inner, cfg.ssm_state_dim
            H = Din // cfg.ssm_head_dim
            ssd = cfg.num_layers * b_local * H * cfg.ssm_head_dim * N * 4 * 2 / tp
            G = cfg.num_layers // max(cfg.attn_every, 1)
            kv = G * b_local * S * cfg.kv_dim * 2 * 2 / tp
            cache = ssd + kv
        elif cfg.family == "encdec":
            cache = cfg.num_layers * b_local * (S + cfg.encoder_seq_len) * cfg.kv_dim * 2 * 2 / tp
    elif shape.kind == "prefill":
        b_local = B / dp
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            cache = cfg.num_layers * b_local * S * cfg.kv_dim * 2 * 2 / tp  # write k+v

    total = weights + opt + act + cache
    return BytesReport(weights, opt, act, cache, total)


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------
def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, *, num_devices: int,
                   tp: int, collective_bytes_per_dev: float,
                   microbatches: int = 1) -> Dict[str, float]:
    fl = analytic_flops(cfg, shape)
    by = analytic_bytes(cfg, shape, num_devices=num_devices, tp=tp,
                        microbatches=microbatches)
    compute_s = fl.hlo_equiv / (num_devices * PEAK_FLOPS)
    memory_s = by.total / HBM_BW
    collective_s = collective_bytes_per_dev / LINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    useful_ratio = fl.model_flops / max(fl.hlo_equiv, 1.0)
    step_s = max(compute_s, memory_s, collective_s)
    mfu = (fl.model_flops / num_devices / max(step_s, 1e-12)) / PEAK_FLOPS
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "hlo_flops_total": fl.hlo_equiv,
        "model_flops": fl.model_flops,
        "useful_ratio": useful_ratio,
        "roofline_mfu": mfu,
        "bytes_weights": by.weights,
        "bytes_opt": by.optimizer,
        "bytes_act": by.activations,
        "bytes_cache": by.cache,
        "bytes_total": by.total,
    }
