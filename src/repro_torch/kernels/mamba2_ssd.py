"""Chunked Mamba2 SSD scan (zamba2's prefill): wrapper of the CUDA kernel.

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SCAN_CHUNK, mamba2_ssd_chunked, scan_chunk

COUNT = _build.LaunchCount("mamba2_ssd")
DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128               # P and N: the state and the tiles in shared memory


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, C: torch.Tensor, state: torch.Tensor, *,
               chunk: int = SCAN_CHUNK):
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError("mamba2_ssd: expected x (B, T, H, P) and Bm, C (B, "
                         f"T, N), got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, T, H) or A.shape != (H,) or Bm.shape != (B, T, N)
            or C.shape != (B, T, N) or state.shape != (B, H, P, N)):
        raise ValueError("mamba2_ssd: expected x (B, T, H, P), dt (B, T, H), "
                         "A (H,), Bm and C (B, T, N), state (B, H, P, N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(C.shape)}, {tuple(state.shape)}")
    chunk = scan_chunk("mamba2_ssd", T, chunk)
    if _build.is_plain("mamba2_ssd", x, dt, A, Bm, C, state):
        COUNT.plain_calls += 1
        return mamba2_ssd_chunked(x, dt, A, Bm, C, state, chunk=chunk)
    _build.refuse_grad("mamba2_ssd", x, dt, A, Bm, C, state)
    dev = _build.check_cuda_inputs("mamba2_ssd", x, Bm, C, dtypes=DTYPES)
    _build.check_cuda_inputs("mamba2_ssd", dt, A, state,
                             dtypes=(torch.float32,))
    if not (dt.device == A.device == state.device == dev):
        raise ValueError("mamba2_ssd: inputs must all lie on one CUDA device")
    if not x.dtype == Bm.dtype == C.dtype:
        raise TypeError("mamba2_ssd: x, Bm and C must share one type, got "
                        f"{x.dtype}, {Bm.dtype}, {C.dtype}")
    if chunk > SCAN_CHUNK or P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"mamba2_ssd: the kernel takes chunk <= {SCAN_CHUNK} "
                         f"and P, N <= {MAX_DIM}, got chunk={chunk}, P={P}, "
                         f"N={N}")
    bf16 = x.dtype == torch.bfloat16
    width = 0                   # the float32 kernel takes no slice
    if bf16:                    # 16-byte rows for the asynchronous copies
        x, Bm, C = (_build.tma_ready(t) for t in (x, Bm, C))
        state = _build.tma_ready(state, 2)
        width = _build.scan_slice(B * H, x.shape[-1], _build.sm_count(dev))
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    _build.launch("mamba2_ssd", "memforest_mamba2_ssd", dev,
                  x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                  C.data_ptr(), state.data_ptr(), y.data_ptr(),
                  s_out.data_ptr(), B, T, H, x.shape[-1], Bm.shape[-1], chunk,
                  int(bf16), width)
    COUNT.launched()
    if y.shape[-1] != P or s_out.shape[-1] != N:
        y, s_out = y[..., :P].contiguous(), s_out[..., :P, :N].contiguous()
    return y, s_out
