"""Mamba2 block (SSD), the backbone of the zamba2 hybrid.

Counterpart of the JAX package's ``models/mamba2.py``. in_proj -> [z | x | B
| C | dt]; a causal depthwise convolution over [x | B | C]; the SSD
recurrence; a gated RMSNorm; out_proj. Decode carries (conv_state,
ssd_state).

The sequence form runs the ``mamba2_ssd`` kernel through ``kernels.ops`` (its
plain version on CPU tensors). The single-token step is plain PyTorch on
either device, as the reference's ``mamba2_decode_step`` is plain jnp outside
any Pallas kernel; it lives here and not in ``kernels/ref.py``, which holds
only the plain versions of kernels.

``mamba2_seq_shards`` and ``mamba2_step_shards`` run the block on a model
mesh: ``w_in``'s column blocks are all-gathered as activations (its blocks
do not fall on head boundaries), each position scans its block of the
heads with the shared B and C, ``norm_g`` normalises over the whole d_inner
(the sums of squares summed over ``model``), ``w_out`` is row-parallel, and
every position keeps the whole conv state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, num_heads, head_dim, conv_dim)."""
    Din = cfg.d_inner
    P = cfg.ssm_head_dim
    H = Din // P
    conv_dim = Din + 2 * cfg.ssm_state_dim
    return Din, H, P, conv_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's distributions; ``A_log``, ``dt_bias`` and ``D_skip``
    are float32 whatever ``dtype`` is, as in the reference."""
    D = cfg.d_model
    Din, H, P, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    dev = gen.device
    f32 = torch.float32
    d_proj = 2 * Din + 2 * N + H  # z, x, B, C, dt
    conv_w = torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                         dtype=f32, device=dev) * 0.2
    return {
        "w_in": L.dense_init(gen, D, d_proj, dtype),
        "w_out": L.dense_init(gen, Din, D, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "D_skip": torch.ones((H,), dtype=f32, device=dev),
        "norm_g": torch.ones((Din,), dtype=dtype, device=dev),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    Din, H, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    z = proj[..., :Din]
    xbc = proj[..., Din:Din + Din + 2 * N]
    dt = proj[..., Din + Din + 2 * N:]
    return z, xbc, dt


def _causal_conv_seq(xbc, conv_w, conv_b, conv_state):
    """xbc: (B, T, C); conv_state: (B, W-1, C) carried from earlier tokens.
    The taps are summed in the reference's order, in the activation type."""
    W = conv_w.shape[0]
    T = xbc.shape[1]
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(W):
        out = out + full[:, i:i + T] * conv_w[i]
    new_state = full[:, -(W - 1):] if W > 1 else conv_state
    return F.silu(out + conv_b), new_state


def _causal_conv_step(xbc, conv_w, conv_b, conv_state):
    """xbc: (B, C), one token."""
    window = torch.cat([conv_state.to(xbc.dtype), xbc[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window, conv_w.to(xbc.dtype)) + conv_b
    return F.silu(out), window[:, 1:]


def _dt_and_A(p, dt: torch.Tensor):
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def mamba2_seq(p, x: torch.Tensor, cfg: ModelConfig, ssd_state: torch.Tensor,
               conv_state: torch.Tensor):
    """x: (B, T, D). Returns (out, new_ssd_state, new_conv_state)."""
    B, T, _ = x.shape
    Din, H, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    z, xbc, dt = _split_proj(x @ p["w_in"], cfg)
    xbc, new_conv = _causal_conv_seq(xbc, p["conv_w"], p["conv_b"], conv_state)
    # the kernel takes contiguous tensors: x, B and C are column slices
    xs = xbc[..., :Din].reshape(B, T, H, P).contiguous()
    Bm = xbc[..., Din:Din + N].contiguous()
    C = xbc[..., Din + N:].contiguous()
    dt, A = _dt_and_A(p, dt)
    y, s_new = ops.mamba2_ssd(xs, dt.contiguous(), A, Bm, C,
                              ssd_state.contiguous())
    y = y + xs * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, T, Din)
    y = L.rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["w_out"], s_new, new_conv


def mamba2_decode_step(x, dt, A, Bm, C, state):
    """One-token SSD step, the counterpart of the reference's
    ``ref.mamba2_decode_step``. x (B, H, P), dt (B, H), A (H,), Bm and C (B,
    N), state (B, H, P, N) -> (y in x's type, new state in state's type)."""
    f32 = torch.float32
    xf, dtf, Bf, Cf = (a.to(f32) for a in (x, dt, Bm, C))
    sf = state.to(f32)
    decay = torch.exp(dtf * A.to(f32)[None, :])
    upd = (dtf[..., None] * xf)[..., None] * Bf[:, None, None, :]
    s_new = decay[..., None, None] * sf + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, Cf)
    return y.to(x.dtype), s_new.to(state.dtype)


def mamba2_step(p, x: torch.Tensor, cfg: ModelConfig, ssd_state: torch.Tensor,
                conv_state: torch.Tensor):
    """x: (B, D), one token. Returns (out, new_ssd_state, new_conv_state)."""
    B, _ = x.shape
    Din, H, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    z, xbc, dt = _split_proj(x @ p["w_in"], cfg)
    xbc, new_conv = _causal_conv_step(xbc, p["conv_w"], p["conv_b"],
                                      conv_state)
    xs = xbc[..., :Din].reshape(B, H, P)
    Bm = xbc[..., Din:Din + N]
    C = xbc[..., Din + N:]
    dt, A = _dt_and_A(p, dt)
    y, s_new = mamba2_decode_step(xs, dt, A, Bm, C, ssd_state)
    y = y + xs * p["D_skip"].to(y.dtype)[None, :, None]
    y = y.reshape(B, Din)
    y = L.rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["w_out"], s_new, new_conv


def state_shapes(cfg: ModelConfig, batch: int):
    """((B, H, P, N) SSD state, float32), ((B, W-1, conv_dim) conv state)."""
    Din, H, P, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    W = cfg.ssm_conv_width
    return (batch, H, P, N), (batch, W - 1, conv_dim)


# ---------------------------------------------------------------------------
# on a model mesh
# ---------------------------------------------------------------------------
def _projected(p, cfg: ModelConfig, mesh: Mesh, hs):
    """The whole packed projection ``x @ w_in`` at every position, and the
    heads each computes. ``w_in`` (D, 2 Din + 2N + H) is split over
    ``model`` at column boundaries that are not its heads': each position
    multiplies its block and the blocks are all-gathered over ``model``, so
    that it holds its heads' z, x and dt and the B and C every head reads.
    Returns (per position (z of its heads, the whole x|B|C, dt of its
    heads), whether the heads are split, each position's first head, the
    count)."""
    Din, H, P, _ = mamba2_dims(cfg)
    los = [L.heads_of(H, mesh, pos)[0] for pos in range(mesh.size)]
    n = L.heads_of(H, mesh, 0)[1]
    out = []
    for lo, proj in zip(los, L.all_columns(hs, p["w_in"])):
        z, xbc, dt = _split_proj(proj, cfg)
        out.append((z[..., lo * P:(lo + n) * P], xbc, dt[..., lo:lo + n]))
    return out, L.heads_axis(H, mesh) is not None, los, n


def _gated_out(p, cfg: ModelConfig, mesh: Mesh, ys, zs, split, los, n):
    """y * silu(z), normalised by ``norm_g`` over the whole d_inner (its sum
    of squares summed over ``model`` where the heads are split), then
    ``w_out`` row-parallel and a ``psum``."""
    Din, _, P, _ = mamba2_dims(cfg)
    gains = L.cut(p["norm_g"], 0, n * P, [lo * P for lo in los])
    gated = [y * F.silu(z) for y, z in zip(ys, zs)]
    normed = L.rms_norm_shards(gated, gains, cfg.norm_eps, Din, mesh, split)
    return L.row_parallel(normed, p["w_out"], split)


def mamba2_seq_shards(p, hs, cfg: ModelConfig, mesh: Mesh, ssd_states,
                      conv_states):
    """``mamba2_seq`` at every position: hs (B_local, T, D) each -> (out
    replicated over ``model``, each position's new SSD state of its heads,
    each position's whole new conv state). Each position runs the conv on
    its heads' x channels and on B and C, ``mamba2_ssd`` on its heads (all
    of them where the model width does not divide them) with the shared B
    and C, and keeps the whole conv input's last W-1 rows as the new conv
    state, equal at every model position, as the cache rule replicates it.
    ``ssd_states``: each position's (B_local, its heads, P, N); conv_states
    (B_local, W-1, conv_dim) whole."""
    Din, _, P, _ = mamba2_dims(cfg)
    N, W = cfg.ssm_state_dim, cfg.ssm_conv_width
    parts, split, los, n = _projected(p, cfg, mesh, hs)
    A_log, dt_bias, D_skip = (L.cut(p[k], 0, n, los)
                              for k in ("A_log", "dt_bias", "D_skip"))
    conv_w, conv_b = spmd.whole(p["conv_w"]), spmd.whole(p["conv_b"])
    ys, new_ssd, new_conv = [], [], []
    for pos, (z, xbc, dt) in enumerate(parts):
        lo, cs = los[pos] * P, conv_states[pos]

        def mine(t):
            return torch.cat([t[..., lo:lo + n * P], t[..., Din:]], dim=-1)

        out, _ = _causal_conv_seq(mine(xbc), mine(conv_w[pos]),
                                  mine(conv_b[pos]), mine(cs))
        full = torch.cat([cs.to(xbc.dtype), xbc], dim=1)
        new_conv.append(full[:, -(W - 1):] if W > 1 else cs)
        # [its heads' x | B | C]: the kernel takes contiguous tensors
        xs = out[..., :n * P].reshape(*out.shape[:2], n, P).contiguous()
        Bm = out[..., n * P:n * P + N].contiguous()
        C = out[..., n * P + N:].contiguous()
        dtf = F.softplus(dt.to(torch.float32) + dt_bias[pos])
        y, s_new = ops.mamba2_ssd(xs, dtf.contiguous(),
                                  -torch.exp(A_log[pos]), Bm, C,
                                  ssd_states[pos].contiguous())
        y = y + xs * D_skip[pos].to(y.dtype)[None, None, :, None]
        ys.append(y.reshape(*y.shape[:2], n * P))
        new_ssd.append(s_new)
    return (_gated_out(p, cfg, mesh, ys, [t[0] for t in parts], split, los,
                       n), new_ssd, new_conv)


def mamba2_step_shards(p, hs, cfg: ModelConfig, mesh: Mesh, ssd_states,
                       conv_states):
    """``mamba2_step`` at every position: hs (B_local, D) each, one token ->
    (out replicated over ``model``, each position's new SSD state of its
    heads, each position's whole new conv state, equal at every model
    position). The conv runs over every channel of the whole window (a few
    products a channel), and each position takes its heads' x, B and C from
    it."""
    Din, _, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    parts, split, los, n = _projected(p, cfg, mesh, hs)
    A_log, dt_bias, D_skip = (L.cut(p[k], 0, n, los)
                              for k in ("A_log", "dt_bias", "D_skip"))
    conv_w, conv_b = spmd.whole(p["conv_w"]), spmd.whole(p["conv_b"])
    ys, new_ssd, new_conv = [], [], []
    for pos, (z, xbc, dt) in enumerate(parts):
        lo = los[pos] * P
        out, state = _causal_conv_step(xbc, conv_w[pos], conv_b[pos],
                                       conv_states[pos])
        new_conv.append(state)
        xs = out[:, lo:lo + n * P].reshape(-1, n, P)
        dtf = F.softplus(dt.to(torch.float32) + dt_bias[pos])
        y, s_new = mamba2_decode_step(xs, dtf, -torch.exp(A_log[pos]),
                                      out[:, Din:Din + N], out[:, Din + N:],
                                      ssd_states[pos])
        y = y + xs * D_skip[pos].to(y.dtype)[None, :, None]
        ys.append(y.reshape(-1, n * P))
        new_ssd.append(s_new)
    return (_gated_out(p, cfg, mesh, ys, [t[0] for t in parts], split, los,
                       n), new_ssd, new_conv)
