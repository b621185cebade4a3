"""Chunked RWKV6 (Finch) WKV scan (rwkv6's prefill and training): wrappers
of the CUDA kernels, forward and backward.

Counterpart of the JAX package's ``kernels/rwkv6_scan.py``. r, k (B, T, H,
K), v (B, T, H, V), w (B, T, H, K) float32 (raw: the decay is
exp(-exp(w))), u (H, K) (the bonus), state (B, H, K, V) float32 -> (o (B, T,
H, V) in r's type, final state float32). r, k, v and u are bf16 or float32,
one type for the four. ``T`` must be at most ``chunk`` or a multiple of it,
as the reference requires. The kernel is ``csrc/rwkv6_scan.cu``; CPU tensors
take the plain version, ``ref.rwkv6_chunked``.

On a card the wrapper dispatches on r's type: bf16 launches the
tensor-core kernel (``mma.sync`` on three-term bf16 splits of the f32
operands, 16-token sub-chunks, a block per (head, slice of 32 or 64
columns of V, batch), 64 only where K <= 64, as shared memory allows; K and
V zero-padded to a multiple of 8 where they are not), float32 the
CUDA-core kernel. Either launches or raises: nothing falls back.

The float32 kernel keeps its (K, V) state in shared memory, or, where the
whole working set would pass 227 KB (K = V = 128), in the final state's
output in global memory (``fwd_state_in_global``).

With grad enabled and an input that requires grad, the call goes through
``RWKV6Scan``, a ``torch.autograd.Function``. On CUDA tensors its forward
launches the same forward kernel, asking it for the state that enters each
chunk, and its backward launches ``csrc/rwkv6_scan_bwd.cu``
(``rwkv6_scan_bwd``), which reads those states and computes the gradient
the reference gets by differentiating its jnp chunked scan: in bf16 on the
tensor cores (16-token sub-chunks, ``mma.sync`` on three-term splits, dS in
registers; K and V zero-padded to a multiple of 8 where they are not), in
float32 on the CUDA cores. On CPU tensors the Function runs the plain
forward and the plain backward (``ref.rwkv6_scan_bwd_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels.ref import (SCAN_CHUNK, rwkv6_chunked,
                                     rwkv6_scan_bwd_ref, scan_chunk)

COUNT = _build.LaunchCount("rwkv6_scan")
BWD_COUNT = _build.LaunchCount("rwkv6_scan_bwd")
DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128               # K and V: the state and the tiles in shared memory
MAX_SMEM = 227 * 1024       # the most shared memory a block may take (H100)


def _check_shapes(name, r, k, v, w, u, state) -> None:
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected r, k, w (B, T, H, K) and v (B, T, "
                         f"H, V), got {tuple(r.shape)}, {tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (B, T, H, V)
            or u.shape != (H, K) or state.shape != (B, H, K, V)):
        raise ValueError(f"{name}: expected r, k, w (B, T, H, K), v (B, T, "
                         "H, V), u (H, K), state (B, H, K, V), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")


def _cuda_checks(name, chunk, r, k, v, w, u, state, *f32) -> torch.device:
    """The kernels' inputs: r, k, v, u (and the backward's do) of one type
    in ``DTYPES``; w, the states (and ds_out) float32; one CUDA device; a
    chunk and dims the shared-memory tiles hold."""
    dev = _build.check_cuda_inputs(name, r, k, v, u, dtypes=DTYPES)
    _build.check_cuda_inputs(name, w, state, *f32, dtypes=(torch.float32,))
    if any(t.device != dev for t in (w, state, *f32)):
        raise ValueError(f"{name}: inputs must all lie on one CUDA device")
    if not r.dtype == k.dtype == v.dtype == u.dtype:
        raise TypeError(f"{name}: r, k, v and u must share one type, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    K, V = r.shape[-1], v.shape[-1]
    if chunk > SCAN_CHUNK or K > MAX_DIM or V > MAX_DIM:
        raise ValueError(f"{name}: the kernel takes chunk <= {SCAN_CHUNK} "
                         f"and K, V <= {MAX_DIM}, got chunk={chunk}, K={K}, "
                         f"V={V}")
    return dev


def _forward(r, k, v, w, u, state, chunk, keep_states=False):
    """One launch of the forward kernel on CUDA tensors -> (o, final state,
    states), ``states`` (B, H, T / chunk, K, V) float32 the state that
    enters each chunk when ``keep_states`` (training), else None (the
    inference launch, which writes none)."""
    dev = _cuda_checks("rwkv6_scan", chunk, r, k, v, w, u, state)
    B, T, H, K = r.shape
    V = v.shape[-1]
    bf16 = r.dtype == torch.bfloat16
    width = 0                   # the float32 kernel takes no slice
    if bf16:                    # 16-byte rows for the asynchronous copies
        r, k, v, w, u = (_build.tma_ready(t) for t in (r, k, v, w, u))
        state = _build.tma_ready(state, 2)
        width = _build.scan_slice(B * H, v.shape[-1], _build.sms_of(r),
                                  widest=64 if K <= 64 else 32, narrowest=32)
    o = r.new_empty(v.shape)
    s_out = torch.empty_like(state)
    states = (state.new_empty((B, H, T // chunk) + state.shape[2:])
              if keep_states else None)
    _build.launch("rwkv6_scan", "memforest_rwkv6_scan", dev,
                  r, k, v, w, u, state, o, s_out, states, B, T, H,
                  r.shape[-1], v.shape[-1], chunk, int(bf16), width,
                  count=COUNT, ops=costs.rwkv_ops(B, T, H, K, V, chunk))
    if o.shape[-1] != V or s_out.shape[-2] != K:
        o, s_out = o[..., :V].contiguous(), s_out[..., :K, :V].contiguous()
        if states is not None:
            states = states[..., :K, :V].contiguous()
    return o, s_out, states


def _run(r, k, v, w, u, state, chunk, keep_states=False):
    """The plain version on CPU tensors (no chunk states: the plain backward
    recomputes them), else one launch of the forward kernel."""
    if r.device.type == "cpu":
        COUNT.plain_calls += 1
        return (*rwkv6_chunked(r, k, v, w, u, state, chunk=chunk), None)
    return _forward(r, k, v, w, u, state, chunk, keep_states)


class RWKV6Scan(torch.autograd.Function):
    """``rwkv6_scan`` with its gradient. The forward saves the inputs and,
    on a card, the state entering each chunk (the forward kernel writes
    them); the backward takes the cotangents of o and of the final state
    (either may be None) and calls ``rwkv6_scan_bwd``. On CPU tensors both
    sides run the plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk):
        ctx.set_materialize_grads(False)
        o, s_out, states = _run(r, k, v, w, u, state, chunk, keep_states=True)
        ctx.save_for_backward(r, k, v, w, u, state, states)
        ctx.chunk = chunk
        return o, s_out

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, w, u, state, states = ctx.saved_tensors
        do = r.new_zeros(v.shape) if do is None else do.contiguous()
        grads = rwkv6_scan_bwd(r, k, v, w, u, state, do,
                               None if ds is None else ds.contiguous(),
                               chunk=ctx.chunk, states=states)
        return (*grads, None)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               chunk: int = SCAN_CHUNK):
    _check_shapes("rwkv6_scan", r, k, v, w, u, state)
    chunk = scan_chunk("rwkv6_scan", r.shape[1], chunk)
    args = (r, k, v, w, u, state)
    _build.is_plain("rwkv6_scan", *args)       # one device, CPU or CUDA
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return RWKV6Scan.apply(*args, chunk)
    return _run(*args, chunk)[:2]


def fwd_smem_floats(K: int, V: int, chunk: int) -> int:
    """Floats of shared memory the float32 forward kernel needs
    (``smem_floats`` in ``csrc/rwkv6_scan.cu``): the carried (K, V) state,
    r, k and the log-decay sums (chunk x (K + 1) each), ce (chunk x K), v
    (chunk x V), A (chunk x chunk) and the bonus (K)."""
    c = chunk
    return K * V + 3 * c * (K + 1) + c * K + c * V + c * c + K


def fwd_state_in_global(K: int, V: int, chunk: int) -> bool:
    """Whether the float32 forward kernel carries its state in global memory
    (the final state's output, one state a block) because the whole working
    set would pass ``MAX_SMEM``: K = V = 128 at a chunk of 64 (247 KB)."""
    return 4 * fwd_smem_floats(K, V, chunk) > MAX_SMEM


def bwd_block_floats(K: int, V: int, chunk: int) -> int:
    """Floats of one block's working set in ``csrc/rwkv6_scan_bwd.cu``
    (``block_floats`` there): r, k, the inclusive and exclusive log-decay
    sums and the log-decays' cotangent (chunk x (K + 1) each), v and do
    (chunk x (V + 1)), A and dA (chunk x (chunk + 1)), three K-vectors and
    the 16 x 64 column partials."""
    c = chunk
    return 5 * c * (K + 1) + 2 * c * (V + 1) + 2 * c * (c + 1) + 3 * K + 1024


def bwd_tc_layout(K: int, V: int):
    """(bytes of shared memory, w and S0 staged, the f32 tiles in shared
    memory) of one block of the bf16 backward kernel (``BwdLayout`` in
    ``csrc/rwkv6_scan_bwd.cu``), K and V multiples of 8: the chunk's r, k,
    v and do, and where staged its w and S0 (f32); dS's three bf16 terms
    and, where staged, S0's; u, dA's diagonal and its 16 x 16 blocks, the
    key halves' A there, the per-key partials of dtotal; and where they fit
    cum, ce and the exchange tiles (64 x (Kp + 4) f32 each). The first of
    (staged, in shared memory), (not staged, in shared memory), (neither)
    within ``MAX_SMEM``."""
    Kp, Vp = -(-K // 16) * 16, -(-V // 16) * 16
    KS, VS, WS, SV = Kp + 8, Vp + 8, Kp + 4, Vp + 4
    for staged, f32_smem in ((True, True), (False, True), (False, False)):
        n = 2 * 64 * KS * 2 + 2 * 64 * VS * 2
        if staged:
            n += 64 * WS * 4 + Kp * SV * 4
        n += 3 * Kp * VS * 2 * (2 if staged else 1)
        n += Kp * 4 + 64 * 4 + 4 * 256 * 4 + 8 * 256 * 4 + 2 * 4 * Kp * 4
        if f32_smem:
            n += 4 * 64 * WS * 4
        if n <= MAX_SMEM:
            break
    return n, staged, f32_smem


def bwd_scratch_floats(B: int, H: int, K: int, V: int, chunk: int,
                       bf16: bool = False) -> int:
    """Floats of global scratch one ``rwkv6_scan_bwd`` call needs. float32:
    0 where a block's working set fits in shared memory (K = V = 64: 150
    KB), else one working set per (head, batch) block. bf16 (``K``, ``V``
    multiples of 8): 0 where shared memory holds the f32 tiles
    (``bwd_tc_layout``), else, per block, cum, ce and dr's and dk's
    diagonal gate terms (64 x (Kp + 4) each). The C entry refuses less."""
    if bf16:
        WS = -(-K // 16) * 16 + 4
        return 0 if bwd_tc_layout(K, V)[2] else B * H * 4 * 64 * WS
    n = bwd_block_floats(K, V, chunk)
    return 0 if 4 * n <= MAX_SMEM else B * H * n


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                   do: torch.Tensor, ds_out=None, *, chunk: int = SCAN_CHUNK,
                   states=None):
    """The gradient of ``rwkv6_scan``: its inputs, the cotangents ``do``
    (B, T, H, V) in r's type and ``ds_out`` (B, H, K, V) float32 or None
    (zeros) -> (dr, dk, dv, dw, du, dstate), each in its input's type. On
    CUDA tensors one launch of ``csrc/rwkv6_scan_bwd.cu``, which reads
    ``states`` (B, H, T / chunk, K, V) float32, the state entering each
    chunk as the training forward writes it (bf16: the inputs zero-padded
    to K and V multiples of 8, the outputs cut back); the batch rows'
    partial du are summed here. On CPU tensors ``rwkv6_scan_bwd_ref`` runs (it
    recomputes the states from ``state``)."""
    _check_shapes("rwkv6_scan_bwd", r, k, v, w, u, state)
    B, T, H, K = r.shape
    V = v.shape[-1]
    if do.shape != v.shape or (ds_out is not None
                               and ds_out.shape != state.shape):
        raise ValueError("rwkv6_scan_bwd: do must have v's shape and ds_out "
                         f"state's, got {tuple(do.shape)} and "
                         f"{None if ds_out is None else tuple(ds_out.shape)}")
    chunk = scan_chunk("rwkv6_scan_bwd", T, chunk)
    more = (do,) if ds_out is None else (do, ds_out)
    if _build.is_plain("rwkv6_scan_bwd", r, k, v, w, u, state, *more):
        BWD_COUNT.plain_calls += 1
        return rwkv6_scan_bwd_ref(r, k, v, w, u, state, do, ds_out,
                                  chunk=chunk)
    if states is None or states.shape != (B, H, T // chunk, K, V):
        raise ValueError("rwkv6_scan_bwd: the kernel reads the chunks' "
                         f"entering states, (B, H, T / chunk, K, V) = "
                         f"{(B, H, T // chunk, K, V)}, got "
                         f"{None if states is None else tuple(states.shape)}")
    f32 = (states,) if ds_out is None else (states, ds_out)
    dev = _cuda_checks("rwkv6_scan_bwd", chunk, r, k, v, w, u, state, *f32)
    if _build.check_cuda_inputs("rwkv6_scan_bwd", do,
                                dtypes=(r.dtype,)) != dev:
        raise ValueError("rwkv6_scan_bwd: do must lie on r's device")
    bf16 = r.dtype == torch.bfloat16
    if bf16:                    # 16-byte rows for the asynchronous copies
        r, k, v, w, u, do = (_build.tma_ready(t) for t in (r, k, v, w, u, do))
        states = _build.tma_ready(states, 2)
        if ds_out is not None:
            ds_out = _build.tma_ready(ds_out, 2)
    K8, V8 = r.shape[-1], v.shape[-1]
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    dstate = torch.empty((B, H, K8, V8), dtype=torch.float32, device=dev)
    du_part = torch.empty((B, H, K8), dtype=torch.float32, device=dev)
    n = bwd_scratch_floats(B, H, K8, V8, chunk, bf16)
    scratch = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
    _build.launch("rwkv6_scan_bwd", "memforest_rwkv6_scan_bwd", dev,
                  r, k, v, w, u, states, do, ds_out, dr, dk, dv, dw, du_part,
                  dstate, scratch, n, B, T, H, K8, V8, chunk, int(bf16),
                  count=BWD_COUNT, ops=costs.rwkv_bwd_ops(B, T, H, K, V))
    if K8 != K or V8 != V:
        dr, dk, dw = (t[..., :K].contiguous() for t in (dr, dk, dw))
        dv, dstate = dv[..., :V].contiguous(), dstate[..., :K, :V].contiguous()
        du_part = du_part[..., :K]
    return dr, dk, dv, dw, du_part.sum(dim=0).to(u.dtype), dstate
