"""The port's two recurrent scans against the JAX package's, on the CPU.

``mamba2_ssd`` and ``rwkv6_scan`` run their plain versions here (the CUDA
kernels run only on a card, where ``chip_smoke.py`` holds them against these
plain versions). Inputs are made with numpy from fixed seeds and handed to
both packages. Each plain version is held against ``repro.kernels.ref``'s
exact recurrence and chunked form and against the Pallas kernel in
interpret mode, at the shapes of tests/test_kernels.py plus a single chunk
of 16 and bf16 inputs; the single-token decode steps against the
reference's; both packages refuse T = 120.

Tolerances: the scans, 2e-4 absolute and 1e-2 relative, those of
tests/test_kernels.py (float32 sums in another order; with bf16 inputs both
sides compute in float32 from the same bf16 values and round once, so they
may differ by one bf16 ulp, 2^-8 relative, inside the 1e-2). The decode
steps, 1e-5 (one step, no chunking).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models.mamba2 import mamba2_decode_step
from repro_torch.models.rwkv6 import rwkv6_decode_step

ATOL, RTOL = 2e-4, 1e-2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype="float32"):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(np.asarray(a, np.float32), JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# rwkv6_scan
# ---------------------------------------------------------------------------
RWKV_CASES = [
    # B, T, H, K, V, chunk: tests/test_kernels.py's, then one chunk of 16
    (1, 64, 2, 8, 8, 16), (2, 128, 2, 16, 16, 32), (1, 96, 3, 8, 16, 32),
    (2, 16, 2, 8, 8, 64),
]


def _rwkv_inputs(seed, B, T, H, K, V, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda shape, s: rng.normal(size=shape) * s          # noqa: E731
    r, k, v = (_pair(mk(sh, 0.5), dtype) for sh in
               ((B, T, H, K), (B, T, H, K), (B, T, H, V)))
    w = _pair(mk((B, T, H, K), 0.5))                           # float32
    u = _pair(mk((H, K), 0.5), dtype)
    s0 = _pair(mk((B, H, K, V), 0.1))                          # float32
    return [x[0] for x in (r, k, v, w, u, s0)], [x[1] for x in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("B,T,H,K,V,chunk", RWKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_plain(B, T, H, K, V, chunk, dtype):
    J, Tt = _rwkv_inputs(B * 100 + T + K, B, T, H, K, V, dtype)
    before = kernels.COUNTS["rwkv6_scan"].plain_calls
    o, s = ops.rwkv6_scan(*Tt, chunk=chunk)
    assert kernels.COUNTS["rwkv6_scan"].plain_calls == before + 1
    assert o.dtype == TDT[dtype] and o.shape == (B, T, H, V)
    assert s.dtype == torch.float32 and s.shape == (B, H, K, V)
    exact = jax_ref.rwkv6_scan_ref(*J)
    chunked = jax_ref.rwkv6_chunked(*J, chunk=chunk)
    pallas = jax_ops.rwkv6_scan(*J, impl="pallas_interpret", chunk=chunk)
    for jo, js in (exact, chunked, pallas):
        _close(o, jo)
        _close(s, js)
    # the port's own exact recurrence, the oracle beside the plain version
    to, ts = ref.rwkv6_scan_ref(*Tt)
    _close(to, exact[0])
    _close(ts, exact[1])


def test_rwkv6_scan_plain_at_k_v_128():
    """The shape the float32 kernel carries its state in global memory at
    (K = V = 128: 247 KB of shared memory with the state, past 227 KB): the
    plain version the wrapper takes on the CPU equals the JAX reference's
    chunked scan there, and the wrapper's mirror of the kernel's shared
    memory sends this shape, and no narrower one, to global memory."""
    from repro_torch.kernels.rwkv6_scan import (MAX_SMEM, fwd_smem_floats,
                                                fwd_state_in_global)
    J, Tt = _rwkv_inputs(128, 2, 128, 4, 128, 128, "float32")
    o, s = ops.rwkv6_scan(*Tt)
    jo, js = jax_ref.rwkv6_chunked(*J, chunk=64)
    _close(o, jo)
    _close(s, js)
    assert fwd_smem_floats(128, 128, 64) == 61760
    assert 4 * fwd_smem_floats(128, 128, 64) > MAX_SMEM
    assert fwd_state_in_global(128, 128, 64)
    assert not fwd_state_in_global(64, 64, 64)
    assert not fwd_state_in_global(112, 112, 64)


def test_rwkv6_decode_step():
    rng = np.random.default_rng(11)
    B, H, K, V = 3, 2, 8, 16
    J, Tt = zip(*(_pair(rng.normal(size=sh) * sc) for sh, sc in (
        ((B, H, K), 1.0), ((B, H, K), 1.0), ((B, H, V), 1.0),
        ((B, H, K), 1.0), ((H, K), 1.0), ((B, H, K, V), 0.1))))
    o, s = rwkv6_decode_step(*Tt)
    jo, js = jax_ref.rwkv6_decode_step(*J)
    _close(o, jo, atol=1e-5, rtol=0)
    _close(s, js, atol=1e-5, rtol=0)
    # one step of the scan is the decode step
    so, ss = ops.rwkv6_scan(*(t[:, None] for t in Tt[:4]), Tt[4], Tt[5])
    _close(so[:, 0], o, atol=1e-5, rtol=0)
    _close(ss, s, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# mamba2_ssd
# ---------------------------------------------------------------------------
SSD_CASES = [
    # B, T, H, P, N, chunk: tests/test_kernels.py's, then one chunk of 16
    (1, 64, 2, 8, 4, 16), (2, 128, 3, 16, 8, 32), (1, 96, 2, 8, 8, 32),
    (2, 16, 2, 8, 8, 64),
]


def _ssd_inputs(seed, B, T, H, P, N, dtype):
    rng = np.random.default_rng(seed)
    x = _pair(rng.normal(size=(B, T, H, P)), dtype)
    dt = _pair(rng.random((B, T, H)) * 0.5 + 0.01)              # float32
    A = _pair(-(rng.random((H,)) + 0.1))                        # float32
    Bm = _pair(rng.normal(size=(B, T, N)), dtype)
    C = _pair(rng.normal(size=(B, T, N)), dtype)
    s0 = _pair(rng.normal(size=(B, H, P, N)) * 0.1)             # float32
    return [t[0] for t in (x, dt, A, Bm, C, s0)], [t[1] for t in (x, dt, A, Bm, C, s0)]


@pytest.mark.parametrize("B,T,H,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_ssd_plain(B, T, H, P, N, chunk, dtype):
    J, Tt = _ssd_inputs(B * 100 + T + P, B, T, H, P, N, dtype)
    before = kernels.COUNTS["mamba2_ssd"].plain_calls
    y, s = ops.mamba2_ssd(*Tt, chunk=chunk)
    assert kernels.COUNTS["mamba2_ssd"].plain_calls == before + 1
    assert y.dtype == TDT[dtype] and y.shape == (B, T, H, P)
    assert s.dtype == torch.float32 and s.shape == (B, H, P, N)
    exact = jax_ref.mamba2_ssd_ref(*J)
    chunked = jax_ref.mamba2_ssd_chunked(*J, chunk=chunk)
    pallas = jax_ops.mamba2_ssd(*J, impl="pallas_interpret", chunk=chunk)
    for jy, js in (exact, chunked, pallas):
        _close(y, jy)
        _close(s, js)
    ty, ts = ref.mamba2_ssd_ref(*Tt)
    _close(ty, exact[0])
    _close(ts, exact[1])


def test_mamba2_decode_step():
    rng = np.random.default_rng(12)
    B, H, P, N = 3, 2, 8, 4
    J, Tt = zip(*(_pair(a) for a in (
        rng.normal(size=(B, H, P)), rng.random((B, H)) * 0.5 + 0.01,
        -(rng.random((H,)) + 0.1), rng.normal(size=(B, N)),
        rng.normal(size=(B, N)), rng.normal(size=(B, H, P, N)) * 0.1)))
    y, s = mamba2_decode_step(*Tt)
    jy, js = jax_ref.mamba2_decode_step(*J)
    _close(y, jy, atol=1e-5, rtol=0)
    _close(s, js, atol=1e-5, rtol=0)
    x, dt, A, Bm, C, s0 = Tt
    sy, ss = ops.mamba2_ssd(x[:, None], dt[:, None], A, Bm[:, None],
                            C[:, None], s0)
    _close(sy[:, 0], y, atol=1e-5, rtol=0)
    _close(ss, s, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the reference's limit on T, matched
# ---------------------------------------------------------------------------
def test_both_packages_refuse_t_120():
    """T > 64 must be a multiple of 64: the JAX package asserts, the port
    raises a ValueError naming the limit, before any arithmetic."""
    Jr, Tr = _rwkv_inputs(1, 1, 120, 2, 8, 8, "float32")
    Js, Ts = _ssd_inputs(2, 1, 120, 2, 8, 4, "float32")
    with pytest.raises(AssertionError):
        jax_ref.rwkv6_chunked(*Jr)
    with pytest.raises(AssertionError):
        jax_ref.mamba2_ssd_chunked(*Js)
    before = {k: kernels.COUNTS[k].plain_calls for k in ("rwkv6_scan",
                                                         "mamba2_ssd")}
    with pytest.raises(ValueError, match="multiple of the chunk 64"):
        ops.rwkv6_scan(*Tr)
    with pytest.raises(ValueError, match="multiple of the chunk 64"):
        ops.mamba2_ssd(*Ts)
    after = {k: kernels.COUNTS[k].plain_calls for k in before}
    assert after == before
    # T <= 64 is one chunk of T, whatever T is
    ops.rwkv6_scan(*(t[:, :60] for t in Tr[:4]), Tr[4], Tr[5])
    ops.mamba2_ssd(Ts[0][:, :60], Ts[1][:, :60], Ts[2], Ts[3][:, :60],
                   Ts[4][:, :60], Ts[5])


def test_wrappers_check_shapes_and_devices():
    _, Ts = _ssd_inputs(3, 1, 16, 2, 8, 4, "float32")
    with pytest.raises(ValueError, match="state"):
        ops.mamba2_ssd(*Ts[:5], Ts[5][:, :1])
    _, Tr = _rwkv_inputs(4, 1, 16, 2, 8, 8, "float32")
    with pytest.raises(ValueError, match="u \\(H, K\\)"):
        ops.rwkv6_scan(*Tr[:4], Tr[4][:1], Tr[5])
    meta = [t.to("meta") for t in Tr]
    with pytest.raises(ValueError, match="CPU or all on a CUDA"):
        ops.rwkv6_scan(*meta)
