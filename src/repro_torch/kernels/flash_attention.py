"""GQA attention over one sequence (prefill, encoder, training): wrappers of
the CUDA kernels, forward and backward.

Counterpart of the JAX package's ``kernels/flash_attention.py``. q (B, S,
Hq, D), k and v (B, S, Hkv, D), bf16 or float32, causal or full -> (B, S,
Hq, D) in q's type, with the softmax in float32. Unlike the Pallas wrapper
it takes any S: the kernel masks the ragged tail itself. The kernel is
``csrc/flash_attention.cu`` (bf16 on the tensor cores, float32 on the CUDA
cores); CPU tensors take the plain version in ``ref.py``, which autograd
differentiates.

On CUDA tensors with grad enabled and an input that requires grad, the call
goes through ``FlashAttention``, a ``torch.autograd.Function``: its forward
launches the same forward kernel, and its backward launches
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``), which computes
the gradient the reference gets by differentiating its jnp attention. The
reference has no Pallas backward, and the port has no plain fallback on the
card, so the backward is a kernel of its own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

COUNT = _build.LaunchCount("flash_attention")
BWD_COUNT = _build.LaunchCount("flash_attention_bwd")
MAX_HEAD_DIM = 128          # the kernels' head-dim registers and tiles
DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(name, q, k, v) -> None:
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or k.shape[2] < 1 or q.shape[2] % k.shape[2] != 0):
        raise ValueError(f"{name}: expected q (B, S, Hq, D) and k, v "
                         "(B, S, Hkv, D) with Hq a multiple of Hkv, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _cuda_checks(name, q, k, v, *more) -> torch.device:
    dev = _build.check_cuda_inputs(name, q, k, v, *more, dtypes=DTYPES)
    if any(t.dtype != q.dtype for t in (k, v, *more)):
        raise TypeError(f"{name}: q, k and v must share one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {q.shape[3]} > {MAX_HEAD_DIM}")
    return dev


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors."""
    dev = _cuda_checks("flash_attention", q, k, v)
    B, S, Hq, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = _build.tma_ready(q), _build.tma_ready(k), _build.tma_ready(v)
    out = torch.empty_like(q)
    _build.launch("flash_attention", "memforest_flash_attention", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, Hq, k.shape[2], q.shape[3], D, int(causal), int(bf16))
    COUNT.launched()
    return out if out.shape[3] == D else out[..., :D].contiguous()


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient. The forward saves q, k, v and
    the (trimmed) output; the backward makes the output's gradient
    contiguous (it arrives as a view from the reshape in
    ``attention_prefill``) and calls ``flash_attention_bwd``. On CPU tensors
    both sides run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = flash_attention(q, k, v, causal=causal)   # grad mode is off here
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    _check_shapes("flash_attention", q, k, v)
    if _build.is_plain("flash_attention", q, k, v):
        COUNT.plain_calls += 1
        return attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True):
    """The gradient of ``flash_attention``: q, o and do (B, S, Hq, D), k and
    v (B, S, Hkv, D), all of one type -> (dq, dk, dv) in that type. On CUDA
    tensors one call is two launches of ``csrc/flash_attention_bwd.cu`` (dq
    with each row's log-sum-exp and dO . o, then dk and dv per KV head),
    counted once; on CPU tensors ``attention_bwd_ref`` runs."""
    _check_shapes("flash_attention_bwd", q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must have q's shape "
                         f"{tuple(q.shape)}, got {tuple(o.shape)} and "
                         f"{tuple(do.shape)}")
    if _build.is_plain("flash_attention_bwd", q, k, v, o, do):
        BWD_COUNT.plain_calls += 1
        return attention_bwd_ref(q, k, v, o, do, causal=causal)
    dev = _cuda_checks("flash_attention_bwd", q, k, v, o, do)
    B, S, Hq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty((2, B, Hq, S), dtype=torch.float32, device=dev)
    _build.launch("flash_attention_bwd", "memforest_flash_attention_bwd", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  scratch.data_ptr(), B, S, Hq, k.shape[2], D, int(causal),
                  int(q.dtype == torch.bfloat16))
    BWD_COUNT.launched()
    return dq, dk, dv
