"""The scans' gradients and the scan families' training, on the CPU.

The CUDA backward kernels run only on a card (``chip_smoke.py`` holds them
against these plain versions there). Checked here, on inputs drawn with
numpy from fixed seeds:

- ``ref.mamba2_ssd_bwd_ref`` and ``ref.rwkv6_scan_bwd_ref`` against
  ``jax.vjp`` of the JAX package's chunked scans
  (``repro.kernels.ref.mamba2_ssd_chunked``, ``rwkv6_chunked``), T in {40,
  64, 128, 192} (one chunk and several), with a nonzero initial state and
  final-state cotangent and with neither, P or K = 20. float32 on both
  sides: each gradient within 2e-5 of its largest magnitude, the spread
  between two valid float32 evaluations (the reference's chunked gradient
  against its exact recurrence's lies within 1e-5 of it). dA is the
  exception: it sums B T terms dt_t revcumsum(dcum)_t that cancel to a
  value far below them, and each float32 evaluation carries the terms'
  rounding, so it is held within 2e-5 of the size of its terms, sum_{b,t}
  |dt ddt| / |A|, per head;
- ``Mamba2SSD`` and ``RWKV6Scan`` (the wrappers with inputs that require
  grad) on CPU tensors against ``torch.autograd`` through the plain chunked
  forwards, in float64 (1e-9 relative: the same math in another order),
  with the cotangent of y or o only, of the final state only, or both; in
  float32 and bf16 the gradients come back in the inputs' types. The
  plain versions run (their counts say so); on any other device than the
  CPU the wrappers raise;
- ``loss_fn`` of zamba2's and rwkv6's smoke configs differentiates on the
  CPU, with remat on and off, and writes none of the zero states it starts
  the layers from (their version counters stay 0); ``prefill`` still
  writes its cache in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref
from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd
from repro_torch.models import get_model, make_batch
from repro_torch.models import mamba2 as M
from repro_torch.models import rwkv6 as R
from repro_torch.tree import leaves

REL = 2e-5
F32 = dict(dtype="float32", param_dtype="float32")


def _f(rng):
    return lambda *shape: rng.standard_normal(shape).astype(np.float32)


def ssd_arrays(seed, B, T, H, P, N, with_state=True):
    """x, dt, A, Bm, C, state, dy, ds_out (None without a state)."""
    f = _f(np.random.default_rng(seed))
    x, dt, A = f(B, T, H, P), np.log1p(np.exp(f(B, T, H))), -np.exp(f(H))
    Bm, C = f(B, T, N), f(B, T, N)
    state = (0.5 * f(B, H, P, N) if with_state
             else np.zeros((B, H, P, N), np.float32))
    dy = f(B, T, H, P)
    ds = f(B, H, P, N) if with_state else None
    return [a.astype(np.float32) for a in (x, dt, A, Bm, C, state, dy)] + [ds]


def rwkv_arrays(seed, B, T, H, K, V, with_state=True):
    """r, k, v, w, u, state, do, ds_out (None without a state)."""
    f = _f(np.random.default_rng(seed))
    r, k, v = f(B, T, H, K), f(B, T, H, K), f(B, T, H, V)
    w, u = 0.5 * f(B, T, H, K) - 0.5, f(H, K)
    state = (0.5 * f(B, H, K, V) if with_state
             else np.zeros((B, H, K, V), np.float32))
    do = f(B, T, H, V)
    ds = f(B, H, K, V) if with_state else None
    return [a.astype(np.float32) for a in (r, k, v, w, u, state, do)] + [ds]


def _vjp(fn, arrays):
    *inputs, dout, ds = arrays
    (_, s), back = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    cot = jnp.zeros_like(s) if ds is None else jnp.asarray(ds)
    return [np.asarray(g) for g in back((jnp.asarray(dout), cot))]


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("T", [40, 64, 128, 192])
def test_mamba2_bwd_ref_matches_jax_vjp(T, with_state):
    arrays = ssd_arrays(T + with_state, 2, T, 3, 20, 16, with_state)
    want = _vjp(jax_ref.mamba2_ssd_chunked, arrays)
    got = ref.mamba2_ssd_bwd_ref(*_torch(arrays))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "state"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w)
        if name == "A":
            dt, ddt = arrays[1], got[1].numpy()
            terms = np.abs(dt * ddt).sum(axis=(0, 1)) / np.abs(arrays[2])
            assert (err <= REL * terms).all(), (err, terms)
        else:
            assert err.max() <= REL * np.abs(w).max(), (name, err.max())


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("T", [40, 64, 128, 192])
def test_rwkv6_bwd_ref_matches_jax_vjp(T, with_state):
    arrays = rwkv_arrays(T + with_state, 2, T, 3, 20, 12, with_state)
    want = _vjp(jax_ref.rwkv6_chunked, arrays)
    got = ref.rwkv6_scan_bwd_ref(*_torch(arrays))
    for name, g, w in zip(("r", "k", "v", "w", "u", "state"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max()
        assert err <= REL * np.abs(w).max(), (name, err)


# ---------------------------------------------------------------------------
# the autograd Functions on CPU tensors
# ---------------------------------------------------------------------------
SCANS = {
    "mamba2_ssd": (ssd_arrays, ops.mamba2_ssd, ref.mamba2_ssd_chunked,
                   (2, 128, 3, 20, 16)),
    "rwkv6_scan": (rwkv_arrays, ops.rwkv6_scan, ref.rwkv6_chunked,
                   (2, 128, 3, 20, 12)),
}


@pytest.mark.parametrize("cotangents", ["output", "state", "both"])
@pytest.mark.parametrize("kernel", sorted(SCANS))
def test_function_matches_autograd_of_the_plain_forward(kernel, cotangents):
    make, wrapper, plain, shape = SCANS[kernel]
    *inputs, dout, ds = _torch(make(7, *shape))
    inputs = [t.double().requires_grad_() for t in inputs]
    dout, ds = dout.double(), ds.double()
    counts = kernels.COUNTS[kernel], kernels.COUNTS[kernel + "_bwd"]
    before = [c.plain_calls for c in counts]
    y, s = wrapper(*inputs)
    assert y.grad_fn is not None and "Backward" in type(y.grad_fn).__name__
    outs, cots = {"output": ([y], [dout]), "state": ([s], [ds]),
                  "both": ([y, s], [dout, ds])}[cotangents]
    got = torch.autograd.grad(outs, inputs, cots)
    assert [c.plain_calls for c in counts] == [b + 1 for b in before]
    y2, s2 = plain(*inputs)
    outs = {"output": [y2], "state": [s2], "both": [y2, s2]}[cotangents]
    want = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
    for g, w, t in zip(got, want, inputs):
        w = torch.zeros_like(t) if w is None else w   # C: not in the state
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-9,
                                   atol=1e-9 * w.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(SCANS))
def test_function_gradients_keep_the_input_types(kernel, dtype):
    """x, B, C (r, k, v, u) in bf16 or float32; dt, A, the state (w, the
    state) float32: each gradient in its input's type."""
    make, wrapper, _, shape = SCANS[kernel]
    *inputs, dout, _ = _torch(make(3, *shape[:1], 64, *shape[2:]))
    low = (0, 3, 4) if kernel == "mamba2_ssd" else (0, 1, 2, 4)
    inputs = [(t.to(dtype) if i in low else t).requires_grad_()
              for i, t in enumerate(inputs)]
    y, _ = wrapper(*inputs)
    assert y.dtype == dtype
    got = torch.autograd.grad(y, inputs, dout.to(dtype))
    for g, t in zip(got, inputs):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g.float()).all())


@pytest.mark.parametrize("kernel", sorted(SCANS))
def test_wrappers_with_grad_never_fall_back_off_the_cpu(kernel):
    """Inputs that require grad anywhere but the CPU take the kernel's
    autograd Function, which launches or raises; the plain versions never
    run for them."""
    make, wrapper, _, shape = SCANS[kernel]
    *inputs, _, _ = _torch(make(5, 1, 64, 2, 8, 8))
    meta = [t.to("meta").requires_grad_() for t in inputs]
    counts = kernels.COUNTS[kernel], kernels.COUNTS[kernel + "_bwd"]
    before = [c.plain_calls for c in counts]
    with pytest.raises(ValueError):
        wrapper(*meta)
    mixed = [t.requires_grad_() for t in inputs]
    mixed[0] = mixed[0].detach().to("meta").requires_grad_()
    with pytest.raises(ValueError):
        wrapper(*mixed)
    assert [c.plain_calls for c in counts] == before


def test_bwd_wrappers_need_the_chunk_states_on_a_card():
    """Off the CPU the backward kernels read the forward's chunk states;
    without them the wrappers raise before any launch."""
    for make, bwd in ((ssd_arrays, mamba2_ssd_bwd),
                      (rwkv_arrays, rwkv6_scan_bwd)):
        args = [t.to("meta") for t in _torch(make(1, 1, 64, 2, 8, 8))[:7]]
        with pytest.raises(ValueError):
            bwd(*args)


# ---------------------------------------------------------------------------
# the loss path writes none of its states
# ---------------------------------------------------------------------------
class StateRecorder:
    """Wraps a sequence function of a model module to keep each state
    tensor it is handed."""

    def __init__(self, monkeypatch, module, name, state_args):
        self.seen = []
        real = getattr(module, name)

        def wrapped(*args):
            self.seen.extend(args[i] for i in state_args)
            return real(*args)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_1b6"])
def test_loss_differentiates_and_writes_no_state(arch, remat, monkeypatch):
    cfg = get_smoke_config(arch).replace(remat=remat, **F32)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch(cfg, "train", 2, 128, 1, device="cpu")
    rec = (StateRecorder(monkeypatch, M, "mamba2_seq", (3, 4))
           if cfg.family == "hybrid"
           else StateRecorder(monkeypatch, R, "_time_mix_seq", (3, 4)))
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, ps)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert rec.seen, "the loss path ran no scan layer"
    for t in rec.seen:
        assert t._version == 0 and not bool(t.any())


@pytest.mark.parametrize("arch", ["zamba2_7b", "rwkv6_1b6"])
def test_prefill_still_writes_its_cache_in_place(arch):
    cfg = get_smoke_config(arch).replace(**F32)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch(cfg, "prefill", 2, 64, 1, device="cpu")
    with torch.no_grad():
        _, cache = model.prefill(params, batch, 64)
    key = "ssd" if cfg.family == "hybrid" else "wkv"
    assert cache[key]._version > 0 and bool(cache[key].any())
