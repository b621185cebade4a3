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
launches the same forward kernel, asking it for each row's log-sum-exp
(``flash_attention_lse``), and its backward launches
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``), which reads that
log-sum-exp and computes the gradient the reference gets by differentiating
its jnp attention. The reference has no Pallas backward, and the port has
no plain fallback on the card, so the backward is a kernel of its own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (attention_bwd_ref, attention_lse_ref,
                                     attention_ref)

COUNT = _build.LaunchCount("flash_attention")
BWD_COUNT = _build.LaunchCount("flash_attention_bwd")
MAX_HEAD_DIM = 128          # the kernels' head-dim registers and tiles
DTYPES = (torch.float32, torch.bfloat16)
TILE_ROWS = 64              # packed rows per warpgroup tile (bf16 kernels)


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


def packing(S: int, G: int):
    """The bf16 kernels' packed rows: (Gc, Mp, chunks, tiles). A tile of 64
    rows holds Gc = min(G, 64) query heads of a KV head's group at Mp = 64 //
    Gc positions, row r = (position - first) * Gc + head; the group takes
    ``chunks`` tiles side by side and the sequence ``tiles`` of them."""
    Gc = min(G, TILE_ROWS)
    Mp = TILE_ROWS // Gc
    return Gc, Mp, -(-G // Gc), -(-S // Mp)


def bwd_scratch_floats(B: int, S: int, Hq: int, Hkv: int, bf16: bool) -> int:
    """Floats of scratch one ``flash_attention_bwd`` call needs: bf16, a
    (lse, Di) pair per packed row of every tile, (B, Hkv, chunks, tiles, 64,
    2); float32, Di as (B, Hq, S). The C entry refuses less."""
    if not bf16:
        return B * Hq * S
    _, _, chunks, tiles = packing(S, Hq // Hkv)
    return B * Hkv * chunks * tiles * TILE_ROWS * 2


def _forward(q, k, v, causal: bool, with_lse: bool = False):
    """One launch of the forward kernel on CUDA tensors -> (out, lse), lse
    (B, Hq, S) float32 in log2 units when ``with_lse``, else None (the
    inference launch, which writes none)."""
    dev = _cuda_checks("flash_attention", q, k, v)
    B, S, Hq, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = _build.tma_ready(q), _build.tma_ready(k), _build.tma_ready(v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    _build.launch("flash_attention", "memforest_flash_attention", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  B, S, Hq, k.shape[2], q.shape[3], D, int(causal), int(bf16))
    COUNT.launched()
    return (out if out.shape[3] == D else out[..., :D].contiguous()), lse


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient. The forward saves q, k, v, the
    (trimmed) output and each row's log-sum-exp; under remat the recomputed
    forward saves its own. The backward makes the output's gradient
    contiguous (it arrives as a view from the reshape in
    ``attention_prefill``) and calls ``flash_attention_bwd``. On CPU tensors
    both sides run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_lse(q, k, v, causal=causal)  # grad off here
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
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
    return _forward(q, k, v, causal)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True):
    """``flash_attention`` that also returns each row's log-sum-exp, the
    forward of training: -> (out (B, S, Hq, D) in q's type, lse (B, Hq, S)
    float32 in log2 units, ``attention_lse_ref``'s domain). On CUDA tensors
    one launch of the forward kernel; on CPU tensors the plain versions."""
    _check_shapes("flash_attention", q, k, v)
    if _build.is_plain("flash_attention", q, k, v):
        COUNT.plain_calls += 1
        return (attention_ref(q, k, v, causal=causal),
                attention_lse_ref(q, k, causal=causal))
    _build.refuse_grad("flash_attention_lse", q, k, v)
    return _forward(q, k, v, causal, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True):
    """The gradient of ``flash_attention``: q, o and do (B, S, Hq, D), k and
    v (B, S, Hkv, D), all of one type, and lse (B, Hq, S) float32 from
    ``flash_attention_lse`` -> (dq, dk, dv) in that type. On CUDA tensors
    one call is two launches of ``csrc/flash_attention_bwd.cu`` (dq with
    each row's Di = dO . o, then dk and dv per KV head), counted once; both
    read the forward's lse. bf16 head dims that are not a multiple of 8 are
    zero-padded for the tensor maps and the gradients trimmed back. On CPU
    tensors ``attention_bwd_ref`` runs (it recomputes the softmax)."""
    _check_shapes("flash_attention_bwd", q, k, v)
    B, S, Hq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must have q's shape "
                         f"{tuple(q.shape)}, got {tuple(o.shape)} and "
                         f"{tuple(do.shape)}")
    if lse.shape != (B, Hq, S):
        raise ValueError("flash_attention_bwd: lse must be (B, Hq, S) = "
                         f"{(B, Hq, S)}, got {tuple(lse.shape)}")
    if _build.is_plain("flash_attention_bwd", q, k, v, o, lse, do):
        BWD_COUNT.plain_calls += 1
        return attention_bwd_ref(q, k, v, o, do, causal=causal)
    dev = _cuda_checks("flash_attention_bwd", q, k, v, o, do)
    if _build.check_cuda_inputs("flash_attention_bwd", lse,
                                dtypes=(torch.float32,)) != dev:
        raise ValueError("flash_attention_bwd: lse must lie on q's device")
    Hkv = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v, o, do = (_build.tma_ready(x) for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n = bwd_scratch_floats(B, S, Hq, Hkv, bf16)
    scratch = torch.empty(n, dtype=torch.float32, device=dev)
    _build.launch("flash_attention_bwd", "memforest_flash_attention_bwd", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), scratch.data_ptr(), n, B, S, Hq, Hkv,
                  q.shape[3], D, int(causal), int(bf16))
    BWD_COUNT.launched()
    if q.shape[3] != D:
        dq, dk, dv = (x[..., :D].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv
