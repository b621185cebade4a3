"""Chunked Mamba2 SSD scan (zamba2's prefill and training): wrappers of the
CUDA kernels, forward and backward.

Counterpart of the JAX package's ``kernels/mamba2_ssd.py``. x (B, T, H, P),
dt (B, T, H) float32 (after softplus), A (H,) float32 (negative), Bm and C
(B, T, N) (one SSD group, shared by every head), state (B, H, P, N) float32
-> (y (B, T, H, P) in x's type, final state float32). x, Bm and C are bf16
or float32, one type for the three. ``T`` must be at most ``chunk`` or a
multiple of it, as the reference requires. The kernel is
``csrc/mamba2_ssd.cu``; CPU tensors take the plain version,
``ref.mamba2_ssd_chunked``.

On a card the wrapper dispatches on x's type: bf16 launches the
tensor-core kernel (``mma.sync`` on three-term bf16 splits of the f32
operands, a block per (head, slice of P, batch); P and N zero-padded to a
multiple of 8 where they are not), float32 the CUDA-core kernel. Either
launches or raises: nothing falls back.

With grad enabled and an input that requires grad, the call goes through
``Mamba2SSD``, a ``torch.autograd.Function``. On CUDA tensors its forward
launches the same forward kernel, asking it for the state that enters each
chunk, and its backward launches ``csrc/mamba2_ssd_bwd.cu``
(``mamba2_ssd_bwd``), which reads those states and computes the gradient
the reference gets by differentiating its jnp chunked scan: in bf16 on the
tensor cores (``mma.sync`` on three-term splits, dS in registers, the
heads' dB and dC summed over a cluster of up to 8 heads in the launch; P
and N zero-padded to a multiple of 8 where they are not), in float32 on the
CUDA cores. On CPU tensors the Function runs the plain forward and the
plain backward (``ref.mamba2_ssd_bwd_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels.ref import (SCAN_CHUNK, mamba2_ssd_bwd_ref,
                                     mamba2_ssd_chunked, scan_chunk)

COUNT = _build.LaunchCount("mamba2_ssd")
BWD_COUNT = _build.LaunchCount("mamba2_ssd_bwd")
DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128               # P and N: the state and the tiles in shared memory


def _check_shapes(name, x, dt, A, Bm, C, state) -> None:
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"{name}: expected x (B, T, H, P) and Bm, C (B, T, "
                         f"N), got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, T, H) or A.shape != (H,) or Bm.shape != (B, T, N)
            or C.shape != (B, T, N) or state.shape != (B, H, P, N)):
        raise ValueError(f"{name}: expected x (B, T, H, P), dt (B, T, H), "
                         "A (H,), Bm and C (B, T, N), state (B, H, P, N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(C.shape)}, {tuple(state.shape)}")


def _cuda_checks(name, chunk, x, dt, A, Bm, C, state, *f32) -> torch.device:
    """The kernels' inputs: x, Bm, C (and the backward's dy) of one type in
    ``DTYPES``; dt, A, the states (and ds_out) float32; one CUDA device; a
    chunk and dims the shared-memory tiles hold."""
    dev = _build.check_cuda_inputs(name, x, Bm, C, dtypes=DTYPES)
    _build.check_cuda_inputs(name, dt, A, state, *f32,
                             dtypes=(torch.float32,))
    if any(t.device != dev for t in (dt, A, state, *f32)):
        raise ValueError(f"{name}: inputs must all lie on one CUDA device")
    if not x.dtype == Bm.dtype == C.dtype:
        raise TypeError(f"{name}: x, Bm and C must share one type, got "
                        f"{x.dtype}, {Bm.dtype}, {C.dtype}")
    P, N = x.shape[-1], Bm.shape[-1]
    if chunk > SCAN_CHUNK or P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"{name}: the kernel takes chunk <= {SCAN_CHUNK} "
                         f"and P, N <= {MAX_DIM}, got chunk={chunk}, P={P}, "
                         f"N={N}")
    return dev


def _forward(x, dt, A, Bm, C, state, chunk, keep_states=False):
    """One launch of the forward kernel on CUDA tensors -> (y, final state,
    states), ``states`` (B, H, T / chunk, P, N) float32 the state that
    enters each chunk when ``keep_states`` (training), else None (the
    inference launch, which writes none)."""
    dev = _cuda_checks("mamba2_ssd", chunk, x, dt, A, Bm, C, state)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    width = 0                   # the float32 kernel takes no slice
    if bf16:                    # 16-byte rows for the asynchronous copies
        x, Bm, C = (_build.tma_ready(t) for t in (x, Bm, C))
        state = _build.tma_ready(state, 2)
        width = _build.scan_slice(B * H, x.shape[-1], _build.sms_of(x))
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    states = (state.new_empty((B, H, T // chunk) + state.shape[2:])
              if keep_states else None)
    _build.launch("mamba2_ssd", "memforest_mamba2_ssd", dev,
                  x, dt, A, Bm, C, state, y, s_out, states, B, T, H,
                  x.shape[-1], Bm.shape[-1], chunk, int(bf16), width,
                  count=COUNT, ops=costs.ssd_ops(B, T, H, P, N, chunk))
    if y.shape[-1] != P or s_out.shape[-1] != N:
        y, s_out = y[..., :P].contiguous(), s_out[..., :P, :N].contiguous()
        if states is not None:
            states = states[..., :P, :N].contiguous()
    return y, s_out, states


def _run(x, dt, A, Bm, C, state, chunk, keep_states=False):
    """The plain version on CPU tensors (no chunk states: the plain backward
    recomputes them), else one launch of the forward kernel."""
    if x.device.type == "cpu":
        COUNT.plain_calls += 1
        return (*mamba2_ssd_chunked(x, dt, A, Bm, C, state, chunk=chunk),
                None)
    return _forward(x, dt, A, Bm, C, state, chunk, keep_states)


class Mamba2SSD(torch.autograd.Function):
    """``mamba2_ssd`` with its gradient. The forward saves the inputs and,
    on a card, the state entering each chunk (the forward kernel writes
    them); the backward takes the cotangents of y and of the final state
    (either may be None) and calls ``mamba2_ssd_bwd``. On CPU tensors both
    sides run the plain versions."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, state, chunk):
        ctx.set_materialize_grads(False)
        y, s_out, states = _run(x, dt, A, Bm, C, state, chunk,
                                keep_states=True)
        ctx.save_for_backward(x, dt, A, Bm, C, state, states)
        ctx.chunk = chunk
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds):
        x, dt, A, Bm, C, state, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = mamba2_ssd_bwd(x, dt, A, Bm, C, state, dy,
                               None if ds is None else ds.contiguous(),
                               chunk=ctx.chunk, states=states)
        return (*grads, None)


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, C: torch.Tensor, state: torch.Tensor, *,
               chunk: int = SCAN_CHUNK):
    _check_shapes("mamba2_ssd", x, dt, A, Bm, C, state)
    chunk = scan_chunk("mamba2_ssd", x.shape[1], chunk)
    args = (x, dt, A, Bm, C, state)
    _build.is_plain("mamba2_ssd", *args)       # one device, CPU or CUDA
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Mamba2SSD.apply(*args, chunk)
    return _run(*args, chunk)[:2]


def ssd_bwd_cluster(H: int, P: int, N: int) -> int:
    """Blocks of a cluster in the bf16 backward kernel (``bwd_cluster`` in
    ``csrc/mamba2_ssd_bwd.cu``): neighbouring heads of one batch row, whose
    dB and dC the cluster sums in head order, so the kernel writes (B, T,
    H / cluster, N) partials. The largest divisor of H up to 8 where N,
    padded to 8 and then 16, is at most 64 (the exchange holds one 64-column
    pass), else 1. ``P`` and ``N`` are the dims the kernel gets (multiples
    of 8)."""
    Np = -(-N // 16) * 16
    if Np > 64:
        return 1
    return next((c for c in range(8, 1, -1) if H % c == 0), 1)


def mamba2_ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, C: torch.Tensor, state: torch.Tensor,
                   dy: torch.Tensor, ds_out=None, *, chunk: int = SCAN_CHUNK,
                   states=None):
    """The gradient of ``mamba2_ssd``: its inputs, the cotangents ``dy``
    (B, T, H, P) in x's type and ``ds_out`` (B, H, P, N) float32 or None
    (zeros) -> (dx, ddt, dA, dB, dC, dstate), each in its input's type. On
    CUDA tensors one launch of ``csrc/mamba2_ssd_bwd.cu``, which reads
    ``states`` (B, H, T / chunk, P, N) float32, the state entering each
    chunk as the training forward writes it; the partial dB and dC (one
    per head in float32, one per cluster of heads in bf16:
    ``ssd_bwd_cluster``) and the batch rows' partial dA are summed here. On CPU tensors
    ``mamba2_ssd_bwd_ref`` runs (it recomputes the states from
    ``state``)."""
    _check_shapes("mamba2_ssd_bwd", x, dt, A, Bm, C, state)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape or (ds_out is not None
                               and ds_out.shape != state.shape):
        raise ValueError("mamba2_ssd_bwd: dy must have x's shape and ds_out "
                         f"state's, got {tuple(dy.shape)} and "
                         f"{None if ds_out is None else tuple(ds_out.shape)}")
    chunk = scan_chunk("mamba2_ssd_bwd", T, chunk)
    more = (dy,) if ds_out is None else (dy, ds_out)
    if _build.is_plain("mamba2_ssd_bwd", x, dt, A, Bm, C, state, *more):
        BWD_COUNT.plain_calls += 1
        return mamba2_ssd_bwd_ref(x, dt, A, Bm, C, state, dy, ds_out,
                                  chunk=chunk)
    if states is None or states.shape != (B, H, T // chunk, P, N):
        raise ValueError("mamba2_ssd_bwd: the kernel reads the chunks' "
                         f"entering states, (B, H, T / chunk, P, N) = "
                         f"{(B, H, T // chunk, P, N)}, got "
                         f"{None if states is None else tuple(states.shape)}")
    f32 = (states,) if ds_out is None else (states, ds_out)
    dev = _cuda_checks("mamba2_ssd_bwd", chunk, x, dt, A, Bm, C, state, *f32)
    if _build.check_cuda_inputs("mamba2_ssd_bwd", dy,
                                dtypes=(x.dtype,)) != dev:
        raise ValueError("mamba2_ssd_bwd: dy must lie on x's device")
    bf16 = x.dtype == torch.bfloat16
    if bf16:                    # 16-byte rows for the asynchronous copies
        x, dy, Bm8, C8 = (_build.tma_ready(t) for t in (x, dy, Bm, C))
        states = _build.tma_ready(states, 2)
        if ds_out is not None:
            ds_out = _build.tma_ready(ds_out, 2)
    else:
        Bm8, C8 = Bm, C
    P8, N8 = x.shape[-1], Bm8.shape[-1]
    cl = ssd_bwd_cluster(H, P8, N8) if bf16 else 1
    f = dict(dtype=torch.float32, device=dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dstate = torch.empty((B, H, P8, N8), **f)
    dA_part = torch.empty((B, H), **f)
    dB_part, dC_part = (torch.empty((B, T, H // cl, N8), **f) for _ in range(2))
    _build.launch("mamba2_ssd_bwd", "memforest_mamba2_ssd_bwd", dev,
                  x, dt, A, Bm8, C8, states, dy, ds_out, dx, ddt, dA_part,
                  dB_part, dC_part, dstate, B, T, H, P8, N8, chunk, int(bf16),
                  count=BWD_COUNT, ops=costs.ssd_bwd_ops(B, T, H, P, N))
    if P8 != P or N8 != N:
        dx, dstate = dx[..., :P].contiguous(), dstate[..., :P, :N].contiguous()
    return (dx, ddt, dA_part.sum(dim=0),
            dB_part.sum(dim=2).narrow(-1, 0, N).to(Bm.dtype),
            dC_part.sum(dim=2).narrow(-1, 0, N).to(C.dtype), dstate)
