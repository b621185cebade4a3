"""The arithmetic of the two bf16 scan kernels, on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them against
their plain versions there). What their bf16 designs change is held here,
in plain PyTorch that follows each kernel's schedule step by step:

- every product runs on bf16 operands with f32 sums (``mma.sync``). An
  operand that is a bf16 input (x, B, C; r, k, v) enters as it is; one
  computed in f32 (G, the state, x*w, the rescaled r and k, A) enters as
  three bf16 terms hi + mid + lo, and of two split sides only the terms
  with i + j < 3 are kept;
- ``mamba2_ssd``: C.B^T once per chunk, G masked and scaled on its
  fragment, y = G.x + exp(cum) (C.S^T), S <- exp(total) S + (x w)^T.B;
- ``rwkv6_scan``: the 64-token chunk cut into four sub-chunks of 16; the
  gate's exponentials only in the diagonal 16 x 16 blocks, the blocks
  below a sub-chunk's diagonal one product of r and k rescaled about the
  last token before the sub-chunk (both factors <= 1), the column sums in
  row order and ce = cum - ld as the reference forms them;
- a block owns a slice of P (V) columns and recomputes G (A) for it;
- chunks of 64, 40, 32 and 16 rows in a 64-row tile, P, N, K, V padded.

Each emulation is held to the earlier bf16 criterion against the port's
plain version (``repro_torch.kernels.ref``): the output within one bf16 ulp
of the plain value beyond 2e-4, the f32 state within 1e-2 relative beyond
2e-4; at one shape also against the JAX package's own reference. Fewer bf16
terms fail that criterion, which is why the kernels take three.

``chip_smoke.py`` now holds the bf16 outputs to a float64 run of the plain
version instead (``chip_smoke.bf16_scan_excess``): one bf16 ulp plus
``SCAN_C`` * 2^-24 * T, T the size of the terms each output sums. The last
section pins ``SCAN_C`` and shows the rule passing the three-term schedule
at the stress shape, where the earlier criterion is tighter than float32
allows, and failing a one-term schedule. Inputs come from numpy with fixed
seeds.

The backward kernels' bf16 paths (``csrc/mamba2_ssd_bwd.cu``,
``csrc/rwkv6_scan_bwd.cu``: ``mma.sync`` on three-term splits) are emulated
block by block as well (``ssd_bwd_schedule``, ``rwkv_bwd_schedule``): the
chunks in reverse from the forward's chunk states, the log-decay sums in
row order, the products on bf16 operands with the f32 ones split, mamba2's
c x c products in the row form and again transposed in the column form,
rwkv6's gate by 16-token sub-chunks (the diagonal blocks' exponentials pair
by pair, the blocks below as products of rescaled r and k), the heads' dB
and dC summed in head order over a cluster, du per batch row, the reverse
sums for ddt and dw. In float64 they equal the plain backward (1e-10: the
same math in another order, no splits); in float32 and with bf16 inputs
they meet ``chip_smoke.SCAN_BWD_TOL`` against a float64 run, as the kernels
must on the card; with one bf16 term they do not.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ref
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels._build import scan_slice, tma_ready
from repro_torch.kernels.mamba2_ssd import ssd_bwd_cluster

import chip_smoke

BF16 = torch.bfloat16
TILE = 64           # rows of a chunk's tiles in shared memory
SUB = 16            # rwkv6's sub-chunk
ATOL, RTOL = 2e-4, 1e-2


def split(a, terms=3):
    """``a`` (f32) as ``terms`` bf16 values (as f32) that sum to it."""
    out = []
    for _ in range(terms):
        h = a.to(BF16).float()
        out.append(h)
        a = a - h
    return out


def mm(a_terms, b_terms):
    """Sum of a_i @ b_j over i + j < 3: the products ``mma.sync`` runs."""
    out = 0
    for i, a in enumerate(a_terms):
        for j, b in enumerate(b_terms):
            if i + j < 3:
                out = out + a @ b
    return out


def up(n, m):
    return -(-n // m) * m


def bf16_ulp(t):
    mag = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def excess(out, want):
    """How far ``out`` lies beyond chip_smoke.py's bf16 criterion (must be
    <= 2e-4): one bf16 ulp of the plain value for a bf16 output, 1e-2
    relative for the f32 state."""
    o, w = out.float(), want.float()
    slack = bf16_ulp(w) if out.dtype == BF16 else RTOL * w.abs()
    return ((o - w).abs() - slack).max().item()


# ---------------------------------------------------------------------------
# mamba2_ssd
# ---------------------------------------------------------------------------
def ssd_schedule(x, dt, A, Bm, C, state, chunk=64, width=64, terms=3):
    """The bf16 kernel's arithmetic, vectorised over (batch, head): x (B, T,
    H, P), Bm and C (B, T, N) bf16; dt, A and the state f32."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    c = ref.scan_chunk("mamba2_ssd", T, chunk)
    Np, Pp = up(N, 16), up(P, width)
    xf = torch.nn.functional.pad(x.float(), (0, Pp - P))
    Bf = torch.nn.functional.pad(Bm.float(), (0, Np - N))
    Cf = torch.nn.functional.pad(C.float(), (0, Np - N))
    s = torch.nn.functional.pad(state, (0, Np - N, 0, Pp - P))
    y = torch.zeros(B, T, H, Pp)
    idx = torch.arange(TILE)
    lower = idx[:, None] >= idx[None, :]
    for p0 in range(0, Pp, width):            # one block per slice
        S = s[:, :, p0:p0 + width]
        for t0 in range(0, T, c):
            xs = torch.zeros(B, H, TILE, width)
            xs[:, :, :c] = xf[:, t0:t0 + c, :, p0:p0 + width].permute(0, 2, 1, 3)
            Bt, Ct = torch.zeros(B, 1, TILE, Np), torch.zeros(B, 1, TILE, Np)
            Bt[:, 0, :c], Ct[:, 0, :c] = Bf[:, t0:t0 + c], Cf[:, t0:t0 + c]
            dts = torch.zeros(B, H, TILE)
            dts[:, :, :c] = dt[:, t0:t0 + c].permute(0, 2, 1)
            cum = torch.cumsum(dts * A[:, None], -1)
            total = cum[..., c - 1]
            cb = Ct @ Bt.transpose(-1, -2)            # bf16 inputs: one term
            G = torch.where(lower, cb * torch.exp(torch.clamp(
                cum[..., :, None] - cum[..., None, :], max=0.0)) * dts[..., None, :],
                torch.zeros(()))
            St = [t.transpose(-1, -2) for t in split(S, terms)]
            yt = mm(split(G, terms), [xs]) + torch.exp(cum)[..., None] * mm([Ct], St)
            w = dts * torch.exp(torch.clamp(total[..., None] - cum, max=0.0))
            xw = (xs * w[..., None]).transpose(-1, -2)
            S = torch.exp(total)[..., None, None] * S + mm(split(xw, terms), [Bt])
            y[:, t0:t0 + c, :, p0:p0 + width] = yt[:, :, :c].permute(0, 2, 1, 3)
        s[:, :, p0:p0 + width] = S
    return y[..., :P].to(x.dtype), s[:, :, :P, :N].contiguous()


def ssd_inputs(seed, B, T, H, P, N):
    """chip_smoke.py's inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))  # noqa: E731
    x = f(B, T, H, P).to(BF16)
    dt = torch.nn.functional.softplus(f(B, T, H))
    A = -torch.linspace(1.0, 16.0, H)
    return x, dt, A, f(B, T, N).to(BF16), f(B, T, N).to(BF16), 0.1 * f(B, H, P, N)


SSD_CASES = [
    # B, T, H, P, N, chunk, slice: the chip row cut in heads, a sliced
    # block, one chunk of 40 and of 16, ragged chunks of 32, P = N = 40
    (2, 128, 8, 64, 64, 64, 64), (1, 128, 4, 64, 64, 64, 32),
    (2, 40, 4, 64, 64, 64, 64), (2, 16, 4, 64, 64, 64, 16),
    (1, 96, 4, 64, 64, 32, 64), (2, 128, 4, 40, 40, 64, 48),
]


@pytest.mark.parametrize("B,T,H,P,N,chunk,width", SSD_CASES)
def test_ssd_schedule_meets_the_card_criterion(B, T, H, P, N, chunk, width):
    args = ssd_inputs(B * 1000 + T + P, B, T, H, P, N)
    y, s = ssd_schedule(*args, chunk=chunk, width=width)
    want_y, want_s = ref.mamba2_ssd_chunked(*args, chunk=chunk)
    assert y.dtype == BF16 and y.shape == want_y.shape and s.shape == want_s.shape
    assert excess(y, want_y) <= ATOL
    assert excess(s, want_s) <= ATOL


def test_ssd_schedule_against_the_jax_reference():
    args = ssd_inputs(7, 1, 128, 4, 64, 64)
    y, s = ssd_schedule(*args)
    jy, js = jax_ops.mamba2_ssd(*(jnp.asarray(a.float().numpy(),
                                              jnp.bfloat16 if a.dtype == BF16 else jnp.float32)
                                  for a in args), impl="reference")
    assert excess(y, torch.from_numpy(np.asarray(jy, np.float32)).to(BF16)) <= ATOL
    assert excess(s, torch.from_numpy(np.array(js))) <= ATOL


def test_ssd_slices_are_independent():
    """A block owning 16, 32 or 64 columns of P gives the same bits."""
    args = ssd_inputs(3, 1, 64, 2, 64, 48)
    outs = [ssd_schedule(*args, width=w) for w in (16, 32, 64)]
    for y, s in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(s, outs[0][1])


# ---------------------------------------------------------------------------
# rwkv6_scan
# ---------------------------------------------------------------------------
def rwkv_schedule(r, k, v, w, u, state, chunk=64, width=64, terms=3):
    """The bf16 kernel's arithmetic, vectorised over (batch, head): r, k
    (B, T, H, K), v (B, T, H, V), u (H, K) bf16; w and the state f32."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = ref.scan_chunk("rwkv6_scan", T, chunk)
    Kp, Vp = up(K, 16), up(V, width)
    pad = torch.nn.functional.pad
    rf, kf, wf = (pad(a.float(), (0, Kp - K)) for a in (r, k, w))
    vf = pad(v.float(), (0, Vp - V))
    uf = pad(u.float(), (0, Kp - K))[None, :, None, :]
    s = pad(state, (0, Vp - V, 0, Kp - K))
    o = torch.zeros(B, T, H, Vp)
    idx = torch.arange(SUB)
    strict = (idx[:, None] > idx[None, :])[..., None]
    eye = idx[:, None] == idx[None, :]

    def tile(a, d):
        out = torch.zeros(B, H, TILE, d)
        out[:, :, :c] = a.permute(0, 2, 1, 3)
        return out
    for v0 in range(0, Vp, width):            # one block per slice
        S = s[..., v0:v0 + width]
        for t0 in range(0, T, c):
            rs, ks, ws = (tile(a[:, t0:t0 + c], Kp) for a in (rf, kf, wf))
            vs = tile(vf[:, t0:t0 + c, :, v0:v0 + width], width)
            ld = -torch.exp(ws)                            # padded rows: w = 0
            cum = torch.cumsum(ld, 2)
            ce = cum - ld
            total = cum[:, :, c - 1]
            # A by sub-chunks, each warp's rows over half of the keys (the
            # diagonal over the first and second half, the blocks below it
            # over the even and odd 16-key steps), the halves then added
            halves = (torch.arange(Kp) < Kp // 2, torch.arange(Kp) // 16 % 2 == 0)
            Am = torch.zeros(2, B, H, TILE, TILE)
            for hf in range(2):
                dkeys = halves[0] if hf == 0 else ~halves[0]
                okeys = halves[1] if hf == 0 else ~halves[1]
                for i in range(TILE // SUB):
                    ri = slice(SUB * i, SUB * (i + 1))
                    gate = torch.exp(torch.clamp(ce[:, :, ri, None] - cum[:, :, None, ri], max=0.0))
                    rd, kd = rs[:, :, ri] * dkeys, ks[:, :, ri] * dkeys
                    blk = torch.einsum("bhtk,bhsk,bhtsk->bhts", rd, kd,
                                       torch.where(strict, gate, torch.zeros(())))
                    bonus = (rd * uf * kd).sum(-1)
                    Am[hf, :, :, ri, ri] = blk + torch.where(eye, bonus[..., None], torch.zeros(()))
                    if i:                            # below the diagonal: s <= b < t
                        rj, b = slice(0, SUB * i), SUB * i - 1
                        rp = rs[:, :, ri] * okeys * torch.exp(torch.clamp(
                            ce[:, :, ri] - cum[:, :, b, None], max=0.0))
                        kp = ks[:, :, rj] * okeys * torch.exp(torch.clamp(
                            cum[:, :, b, None] - cum[:, :, rj], max=0.0))
                        Am[hf, :, :, ri, rj] = mm(split(rp, terms),
                                                  [t.transpose(-1, -2) for t in split(kp, terms)])
            Am = Am[0] + Am[1]
            re = rs * torch.exp(ce)
            ot = mm(split(Am, terms), [vs]) + mm(split(re, terms), split(S, terms))
            kw = ks * torch.exp(torch.clamp(total[:, :, None] - cum, max=0.0))
            S = torch.exp(total)[..., None] * S + mm(split(kw.transpose(-1, -2), terms), [vs])
            o[:, t0:t0 + c, :, v0:v0 + width] = ot[:, :, :c].permute(0, 2, 1, 3)
        s[..., v0:v0 + width] = S
    return o[..., :V].to(r.dtype), s[:, :, :K, :V].contiguous()


def rwkv_inputs(seed, B, T, H, K, V, w_mean):
    """chip_smoke.py's inputs, drawn with numpy; w ~ N(w_mean, 0.5)."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))  # noqa: E731
    r, k = f(B, T, H, K).to(BF16), f(B, T, H, K).to(BF16)
    v = f(B, T, H, V).to(BF16)
    w = w_mean + 0.5 * f(B, T, H, K)
    return r, k, v, w, (0.1 * f(H, K)).to(BF16), 0.1 * f(B, H, K, V)


# w ~ N(-0.5, 0.5): chip_smoke.py's; N(1.5, 0.5): strong decay; N(-6, 0.5):
# decay close to 1, the long-memory channels of a trained RWKV6
W_MEANS = [-0.5, 1.5, -6.0]
RWKV_CASES = [
    # B, T, H, K, V, chunk, slice
    (1, 128, 4, 64, 64, 64, 64), (1, 128, 2, 64, 64, 64, 32),
    (2, 40, 2, 64, 64, 64, 64), (2, 16, 2, 64, 64, 64, 32),
    (1, 96, 2, 64, 64, 32, 64), (1, 128, 2, 40, 40, 64, 32),
]


@pytest.mark.parametrize("w_mean", W_MEANS)
@pytest.mark.parametrize("B,T,H,K,V,chunk,width", RWKV_CASES)
def test_rwkv_schedule_meets_the_card_criterion(B, T, H, K, V, chunk, width, w_mean):
    args = rwkv_inputs(B * 1000 + T + K, B, T, H, K, V, w_mean)
    o, s = rwkv_schedule(*args, chunk=chunk, width=width)
    want_o, want_s = ref.rwkv6_chunked(*args, chunk=chunk)
    assert o.dtype == BF16 and o.shape == want_o.shape and s.shape == want_s.shape
    assert excess(o, want_o) <= ATOL
    assert excess(s, want_s) <= ATOL


def test_rwkv_schedule_against_the_jax_reference():
    args = rwkv_inputs(8, 1, 128, 2, 64, 64, -0.5)
    o, s = rwkv_schedule(*args)
    jo, js = jax_ops.rwkv6_scan(*(jnp.asarray(a.float().numpy(),
                                              jnp.bfloat16 if a.dtype == BF16 else jnp.float32)
                                  for a in args), impl="reference")
    assert excess(o, torch.from_numpy(np.asarray(jo, np.float32)).to(BF16)) <= ATOL
    assert excess(s, torch.from_numpy(np.array(js))) <= ATOL


def test_rwkv_slices_are_independent():
    args = rwkv_inputs(4, 1, 64, 2, 48, 64, -0.5)
    outs = [rwkv_schedule(*args, width=w) for w in (32, 64)]
    for o, s in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(s, outs[0][1])


def test_rwkv_factors_never_exceed_one():
    """Both factors of every gate below the diagonal are exp of a sum of
    log-decays (<= 0, up to rounding where the kernel clamps), so <= 1
    however strong the decay: nothing overflows, and a factor that
    underflows to 0 stands for a product at least as small."""
    for w_mean in W_MEANS:
        w = w_mean + 0.5 * torch.from_numpy(
            np.random.default_rng(5).standard_normal((TILE, 8)).astype(np.float32))
        ld = -torch.exp(w)
        cum = torch.cumsum(ld, 0)
        ce = cum - ld
        for i in range(1, TILE // SUB):
            b = SUB * i - 1
            # ce[16i] - cum[b] is 0 but for rounding (the kernel clamps it)
            ulps = 4 * torch.finfo(torch.float32).eps * cum[b].abs()
            assert (ce[SUB * i:SUB * (i + 1)] - cum[b] <= ulps).all()
            assert (cum[b] - cum[:SUB * i] <= 0).all()


# ---------------------------------------------------------------------------
# why three terms: fewer fail the card's criterion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,terms", [("mamba2_ssd", 1), ("rwkv6_scan", 1),
                                          ("rwkv6_scan", 2)])
def test_fewer_terms_fail_the_criterion(kernel, terms):
    if kernel == "mamba2_ssd":
        args = ssd_inputs(11, 2, 128, 8, 64, 64)
        out, _ = ssd_schedule(*args, terms=terms)
        want, _ = ref.mamba2_ssd_chunked(*args)
    else:     # two terms fail only where the decay is close to 1
        args = rwkv_inputs(12, 1, 128, 4, 64, 64, -0.5 if terms == 1 else -6.0)
        out, _ = rwkv_schedule(*args, terms=terms)
        want, _ = ref.rwkv6_chunked(*args)
    assert excess(out, want) > ATOL


# ---------------------------------------------------------------------------
# the card's rule: a float64 run, one bf16 ulp + SCAN_C * 2^-24 * T
# ---------------------------------------------------------------------------
def rule_excess(kernel, args, out):
    plain = ref.mamba2_ssd_chunked if kernel == "mamba2_ssd" else ref.rwkv6_chunked
    return chip_smoke.bf16_scan_excess(out, plain, args, chip_smoke.SCAN_SIGNED[kernel])


def rule_ratio(kernel, args, out):
    """The least c for which ``out`` passes: max (|out - w| - ulp(w)) / (2^-24 T)."""
    plain = ref.mamba2_ssd_chunked if kernel == "mamba2_ssd" else ref.rwkv6_chunked
    signed = chip_smoke.SCAN_SIGNED[kernel]
    w, _ = plain(*(a.double() for a in args))
    terms, _ = plain(*(a.double().abs() if i in signed else a.double()
                       for i, a in enumerate(args)))
    e = (out.double() - w).abs() - chip_smoke.bf16_ulp(w)
    return torch.where(terms > 0, e / (2.0 ** -24 * terms), torch.zeros(())).max().item()


def test_the_rule_constant():
    """SCAN_C = 512. The float32 evaluation's error in this order is set by
    exp(cum_t - cum_s): cum is a float32 running sum of dt.A (of w's
    log-decays), several hundred deep at A = -16, so its rounding, a few
    units of 2^-24 |cum|, is a relative error of the term. Over eight draws
    at the stress shape 1x4096x112x64x64 the three-term schedule and the
    float32 plain version both reach c = 88-145 (rwkv6 at 1x4096x32: 7-14);
    a one-term schedule needs c >= 8,500 at every shape tried. 512 lies 3.5x
    above the first and 16x under the second. (The earlier criterion held
    the kernel to the float32 plain version, whose own error is that size:
    on the card it failed a correct kernel by 2.480e-04 beyond one bf16
    ulp.)"""
    assert chip_smoke.SCAN_C == 512
    assert chip_smoke.SCAN_SIGNED == {"mamba2_ssd": (0, 3, 4, 5),
                                      "rwkv6_scan": (0, 1, 2, 4, 5)}


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_three_terms_pass_the_rule_at_the_stress_shape(seed):
    """mamba2_ssd 1x4096x112x64x64, chip_smoke.py's stress row (seed 3 is
    the draw of the largest ratio found, 145)."""
    args = ssd_inputs(seed, 1, 4096, 112, 64, 64)
    y, _ = ssd_schedule(*args)
    assert rule_excess("mamba2_ssd", args, y) <= 0
    assert rule_ratio("mamba2_ssd", args, y) <= chip_smoke.SCAN_C / 3


@pytest.mark.parametrize("seed", [0, 4])
def test_three_terms_pass_the_rule_at_the_rwkv_stress_length(seed):
    """rwkv6_scan 1x4096 at 8 of the stress row's 32 heads."""
    args = rwkv_inputs(seed, 1, 4096, 8, 64, 64, -0.5)
    o, _ = rwkv_schedule(*args)
    assert rule_excess("rwkv6_scan", args, o) <= 0


@pytest.mark.parametrize("w_mean", W_MEANS)
@pytest.mark.parametrize("case", range(len(RWKV_CASES)))
def test_three_terms_pass_the_rule_at_every_rwkv_shape(case, w_mean):
    B, T, H, K, V, chunk, width = RWKV_CASES[case]
    args = rwkv_inputs(B * 1000 + T + K, B, T, H, K, V, w_mean)
    o, _ = rwkv_schedule(*args, chunk=chunk, width=width)
    plain = ref.rwkv6_chunked
    signed = chip_smoke.SCAN_SIGNED["rwkv6_scan"]
    assert chip_smoke.bf16_scan_excess(o, plain, args, signed, chunk) <= 0


@pytest.mark.parametrize("case", range(len(SSD_CASES)))
def test_three_terms_pass_the_rule_at_every_ssd_shape(case):
    B, T, H, P, N, chunk, width = SSD_CASES[case]
    args = ssd_inputs(B * 1000 + T + P, B, T, H, P, N)
    y, _ = ssd_schedule(*args, chunk=chunk, width=width)
    plain = ref.mamba2_ssd_chunked
    signed = chip_smoke.SCAN_SIGNED["mamba2_ssd"]
    assert chip_smoke.bf16_scan_excess(y, plain, args, signed, chunk) <= 0


@pytest.mark.parametrize("kernel,w_mean", [("mamba2_ssd", None), ("rwkv6_scan", -0.5),
                                           ("rwkv6_scan", -6.0)])
def test_one_term_fails_the_rule(kernel, w_mean):
    """The error the rule exists to catch: f32 operands cut to one bf16 term
    (about 2^-9 relative) fail it at the main shape."""
    if kernel == "mamba2_ssd":
        args = ssd_inputs(11, 2, 128, 8, 64, 64)
        out, _ = ssd_schedule(*args, terms=1)
    else:
        args = rwkv_inputs(12, 1, 128, 4, 64, 64, w_mean)
        out, _ = rwkv_schedule(*args, terms=1)
    assert rule_excess(kernel, args, out) > 0
    assert rule_ratio(kernel, args, out) > 8 * chip_smoke.SCAN_C


def test_the_plain_version_runs_in_float64_for_float64_inputs():
    """The rule's reference: float64 inputs keep float64 through the chunked
    scans (float32 and bf16 inputs compute in float32, as before)."""
    x, dt, A, Bm, C, s0 = ssd_inputs(2, 1, 64, 2, 16, 16)
    y64, s64 = ref.mamba2_ssd_chunked(*(a.double() for a in (x, dt, A, Bm, C, s0)))
    y32, _ = ref.mamba2_ssd_chunked(x.float(), dt, A, Bm.float(), C.float(), s0)
    assert y64.dtype == s64.dtype == torch.float64
    assert 0 < (y64 - y32.double()).abs().max() < 1e-4
    r, k, v, w, u, s1 = rwkv_inputs(3, 1, 64, 2, 16, 16, -0.5)
    o64, _ = ref.rwkv6_chunked(*(a.double() for a in (r, k, v, w, u, s1)))
    assert o64.dtype == torch.float64


# ---------------------------------------------------------------------------
# the wrappers' plan and padding
# ---------------------------------------------------------------------------
def test_scan_slice_fills_the_card():
    sms = 132
    assert scan_slice(8 * 112, 64, sms) == 64      # zamba2 prefill: 896 blocks
    assert scan_slice(112, 64, sms) == 32          # 1x4096 stress: 224 blocks
    assert scan_slice(1, 40, sms) == 16
    assert scan_slice(1000, 40, sms) == 48         # never wider than the dim
    # rwkv6_scan: 32 or 64 columns (64 only where K <= 64)
    assert scan_slice(8 * 32, 64, sms, narrowest=32) == 64   # prefill: 256 blocks
    assert scan_slice(32, 64, sms, narrowest=32) == 32       # 1x4096: 64 blocks
    assert scan_slice(1000, 40, sms, widest=32, narrowest=32) == 32
    for pairs in (1, 7, 32, 112, 896):
        for dim in (8, 40, 64, 128):
            w = scan_slice(pairs, dim, sms)
            assert w % 16 == 0 and 16 <= w <= 64
            w = scan_slice(pairs, dim, sms, narrowest=32)
            assert w in (32, 64)


def test_padded_dims_leave_both_scans_unchanged():
    """The wrappers zero-pad P, N, K and V to a multiple of 8 for the
    kernels' 16-byte copies; the padded scan restricted to the true dims is
    the scan."""
    x, dt, A, Bm, C, s0 = ssd_inputs(21, 1, 64, 2, 20, 12)
    y, s = ref.mamba2_ssd_chunked(x, dt, A, Bm, C, s0)
    yp, sp = ref.mamba2_ssd_chunked(tma_ready(x), dt, A, tma_ready(Bm), tma_ready(C),
                                    tma_ready(s0, 2))
    assert yp.shape[-1] == 24 and sp.shape[-2:] == (24, 16)
    torch.testing.assert_close(yp[..., :20], y, rtol=0, atol=0)
    torch.testing.assert_close(sp[..., :20, :12], s, rtol=1e-6, atol=1e-6)
    r, k, v, w, u, s0 = rwkv_inputs(22, 1, 64, 2, 20, 12, -0.5)
    o, s = ref.rwkv6_chunked(r, k, v, w, u, s0)
    op, sp = ref.rwkv6_chunked(*(tma_ready(t) for t in (r, k, v, w, u)), tma_ready(s0, 2))
    torch.testing.assert_close(op[..., :12], o, rtol=0, atol=2e-6)
    torch.testing.assert_close(sp[..., :20, :12], s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("device", ["meta", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_wrappers_never_fall_back_off_the_cpu(device, dtype):
    """A tensor anywhere but the CPU takes a kernel (by its type) or
    raises; the plain version never runs for it."""
    def make(*shape, dt=torch.float32):
        return torch.zeros(*shape, dtype=dt, device="meta")
    ssd = [make(1, 16, 2, 8, dt=dtype), make(1, 16, 2), make(2),
           make(1, 16, 4, dt=dtype), make(1, 16, 4, dt=dtype), make(1, 2, 8, 4)]
    wkv = [make(1, 16, 2, 8, dt=dtype), make(1, 16, 2, 8, dt=dtype),
           make(1, 16, 2, 8, dt=dtype), make(1, 16, 2, 8), make(2, 8, dt=dtype),
           make(1, 2, 8, 8)]
    if device == "mixed":
        ssd[1], wkv[3] = torch.zeros(1, 16, 2), torch.zeros(1, 16, 2, 8)
    before = {k: kernels.COUNTS[k].plain_calls for k in ("mamba2_ssd", "rwkv6_scan")}
    with pytest.raises(ValueError):
        ops.mamba2_ssd(*ssd)
    with pytest.raises(ValueError):
        ops.rwkv6_scan(*wkv)
    assert {k: kernels.COUNTS[k].plain_calls for k in before} == before


# ---------------------------------------------------------------------------
# the backward kernels (csrc/mamba2_ssd_bwd.cu, csrc/rwkv6_scan_bwd.cu)
# ---------------------------------------------------------------------------
def bsplit(a, terms):
    """An f32 operand the backward kernels split: ``split(a, terms)``; in
    float64 (the schedule run as math, against the plain backward) the
    operand as it is."""
    return [a] if a.dtype == torch.float64 else split(a, terms)


def mmf(a_terms, b_terms):
    """``mm`` in the operands' type (float64 when the schedule runs as math)."""
    out = 0
    for i, a in enumerate(a_terms):
        for j, b in enumerate(b_terms):
            if i + j < 3:
                out = out + a @ b
    return out


def ssd_bwd_schedule(x, dt, A, Bm, C, states, dy, ds_out=None, chunk=64, terms=3):
    """``mamba2_ssd_bwd``'s bf16 schedule (``csrc/mamba2_ssd_bwd.cu``),
    vectorised over its (head, batch) blocks: each block walks its chunks in
    reverse from dS = ds_out, reading the chunk's entering state from
    ``states`` (B, H, nc, P, N). cum and D (the sums of dt.A and of dt) in
    row order, one thread. The row form (warps 0-3, rows t): C.B^T and
    dy.x^T, Q, R's masked values, rowQ, dA's pair terms, dC = exp(cum) (dy.S0)
    + d(C.B^T).B and the carried state's dcum term from dy.S0. The column
    form (warps 4-7, rows s): B.C^T and x.dy^T computed again, transposed,
    colR, dB = wt (x.dS) + d(C.B^T)^T.C with w's cotangent from x.dS, dx =
    wt (B.dS^T) + G^T.dy. Every product on bf16 operands with f32 sums: x,
    dy, B and C enter as they are, d(C.B^T), G^T, S0, dS and exp(cum) dy as
    ``terms`` bf16 terms (as themselves in float64). Then the state's
    cotangent and one thread walks the rows in reverse for ddt and dA's
    terms. The heads' dB and dC are summed in head order over clusters of
    ``ssd_bwd_cluster`` heads. Returns the kernel's outputs: dx, ddt, dA
    per (batch, head), dB and dC per (batch, time, cluster) (the clusters
    not yet summed) and dstate."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    c = ref.scan_chunk("mamba2_ssd_bwd", T, chunk)
    cl = ssd_bwd_cluster(H, up(P, 8), up(N, 8))
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, dyf, dtf, Bf, Cf = (t.to(ct) for t in (x, dy, dt, Bm, C))
    a = A.to(ct)[None, :]
    dS = (torch.zeros(B, H, P, N, dtype=ct) if ds_out is None
          else ds_out.to(ct).clone())
    dx, dBh, dCh = (torch.empty(B, T, H, d, dtype=ct) for d in (P, N, N))
    ddt = torch.empty(B, T, H, dtype=ct)
    dA = torch.zeros(B, H, dtype=ct)
    idx = torch.arange(c)
    lower = idx[:, None] >= idx[None, :]
    zero = torch.zeros((), dtype=ct)
    tr = lambda t: t.transpose(-1, -2)  # noqa: E731
    for ci in reversed(range(T // c)):
        t0 = ci * c
        xs, dys = (t[:, t0:t0 + c].permute(0, 2, 1, 3) for t in (xf, dyf))
        dts = dtf[:, t0:t0 + c].permute(0, 2, 1)                   # (B, H, c)
        Bs, Cs = Bf[:, None, t0:t0 + c], Cf[:, None, t0:t0 + c]
        S0 = states[:, :, ci].to(ct)
        cum, D = torch.empty_like(dts), torch.empty_like(dts)
        run, rd = torch.zeros(B, H, dtype=ct), torch.zeros(B, H, dtype=ct)
        for t in range(c):
            run = run + dts[..., t] * a
            rd = rd + dts[..., t]
            cum[..., t], D[..., t] = run, rd
        total = cum[..., c - 1]
        ex = torch.exp(torch.clamp(total[..., None] - cum, max=0.0))
        wt = dts * ex
        ec = torch.exp(cum)
        L = torch.where(lower, torch.exp(torch.clamp(
            cum[..., :, None] - cum[..., None, :], max=0.0)), zero)
        # the row form
        CB, dG = Cs @ tr(Bs), dys @ tr(xs)
        dCB = dG * L * dts[..., None, :]
        Q = dG * CB * L * dts[..., None, :]
        rowQ = Q.sum(-1)
        dAq = (Q * (D[..., :, None] - D[..., None, :])).sum((-2, -1))
        dyS = mmf([dys], bsplit(S0, terms))
        dcumI = ec * (Cs * dyS).sum(-1)
        dCc = ec[..., None] * dyS + mmf(bsplit(dCB, terms), [Bs])
        # the column form: the transposes computed again
        BC, xd = Bs @ tr(Cs), xs @ tr(dys)
        LT = tr(L)
        colR = (xd * BC * LT).sum(-1)
        dCBT = xd * LT * dts[..., :, None]
        xdS = mmf([xs], bsplit(dS, terms))
        dwt = (Bs * xdS).sum(-1)
        dBc = wt[..., None] * xdS + mmf(bsplit(dCBT, terms), [Cs])
        GT = BC * LT * dts[..., :, None]
        dxc = wt[..., None] * mmf([Bs], bsplit(tr(dS), terms)) + mmf(bsplit(GT, terms), [dys])
        # the state's cotangent
        dtot = torch.exp(total) * (dS * S0).sum((-2, -1))
        dS = torch.exp(total)[..., None, None] * dS + mmf(
            bsplit(tr(ec[..., None] * dys), terms), [Cs])
        swd = torch.zeros(B, H, dtype=ct)
        for s in range(c):
            swd = swd + wt[..., s] * dwt[..., s]
        run, dAs = torch.zeros(B, H, dtype=ct), torch.zeros(B, H, dtype=ct)
        ddtc = torch.empty_like(dts)
        for s in reversed(range(c)):
            dcv = (rowQ[..., s] - dts[..., s] * colR[..., s] + dcumI[..., s]
                   - wt[..., s] * dwt[..., s])
            if s == c - 1:
                dcv = dcv + dtot + swd
            run = run + dcv
            ddtc[..., s] = colR[..., s] + ex[..., s] * dwt[..., s] + a * run
            dAs = dAs + dcumI[..., s] * D[..., s] + wt[..., s] * dwt[..., s] * (
                D[..., c - 1] - D[..., s])
        dA = dA + dAq + dAs + dtot * D[..., c - 1]
        dx[:, t0:t0 + c] = dxc.permute(0, 2, 1, 3)
        ddt[:, t0:t0 + c] = ddtc.permute(0, 2, 1)
        dBh[:, t0:t0 + c], dCh[:, t0:t0 + c] = (t.permute(0, 2, 1, 3) for t in (dBc, dCc))
    # the cluster's sum in head order, from zero
    dBp, dCp = (torch.zeros(B, T, H // cl, N, dtype=ct) for _ in range(2))
    for hh in range(cl):
        heads = [grp * cl + hh for grp in range(H // cl)]
        dBp, dCp = dBp + dBh[:, :, heads], dCp + dCh[:, :, heads]
    return dx.to(x.dtype), ddt, dA, dBp, dCp, dS


def rwkv_bwd_schedule(r, k, v, w, u, states, do, ds_out=None, chunk=64, terms=3):
    """``rwkv6_scan_bwd``'s bf16 schedule (``csrc/rwkv6_scan_bwd.cu``),
    vectorised over its (head, batch) blocks: each block walks its chunks
    in reverse from dS = ds_out, reading the chunk's entering state from
    ``states`` (B, H, nc, K, V). The log-decays' sums down each key column
    in row order and ce = cum - ld. dA = do.v^T (row form) and v.do^T
    (column form). The diagonal 16 x 16 blocks (the sweep): the gate's
    exponentials of the pairs s < t, each once, for A (each half of the
    keys summed, then the halves added), dr's and dk's gate terms and du's
    diagonal terms. Below the diagonal the gate is exp(ce_t - cum_b)
    exp(cum_b - cum_s) for any b with s <= b < t: dr's gate term is
    exp(ce_t - cum_b) (dA.k') with b = 16 m - 1 the token before t's
    sub-chunk m; A^T = k'.r'^T and dk's term exp(cum_b - cum_s) (dA^T.r')
    with b = 16 (i + 1) - 1 the last token of s's sub-chunk i; k' = k
    exp(cum_b - cum_s), r' = r exp(ce_t - cum_b), both sides split into
    ``terms`` bf16 terms. dv = (k ex).dS + A^T.do, dr, dk, the
    cotangents of ce and cum, dtotal from the sub-chunks' sums of Y in
    order, the state's cotangent; then one thread a key column walks the
    rows in reverse for dw. Returns the kernel's outputs: dr, dk, dv, dw, du
    per (batch, head) (not yet summed over the batch) and dstate."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = ref.scan_chunk("rwkv6_scan_bwd", T, chunk)
    ct = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf, dof = (t.to(ct) for t in (r, k, v, w, do))
    uf = u.to(ct)[None, :, None, :]
    dS = (torch.zeros(B, H, K, V, dtype=ct) if ds_out is None
          else ds_out.to(ct).clone())
    dr, dk, dw = (torch.empty(B, T, H, K, dtype=ct) for _ in range(3))
    dv = torch.empty(B, T, H, V, dtype=ct)
    du = torch.zeros(B, H, K, dtype=ct)
    half0 = torch.arange(K) < up(up(K, 8), 16) // 2
    zero = torch.zeros((), dtype=ct)
    tr = lambda t: t.transpose(-1, -2)  # noqa: E731
    idx = torch.arange(SUB)
    strict = (idx[:, None] > idx[None, :])[..., None]
    for ci in reversed(range(T // c)):
        t0 = ci * c
        rs, ks, ws, vs, dos = (t[:, t0:t0 + c].permute(0, 2, 1, 3)
                               for t in (rf, kf, wf, vf, dof))
        S0 = states[:, :, ci].to(ct)
        ld = -torch.exp(ws)
        cum = torch.empty_like(ld)
        run = torch.zeros(B, H, K, dtype=ct)
        for t in range(c):
            run = run + ld[..., t, :]
            cum[..., t, :] = run
        ce = cum - ld
        total = cum[..., c - 1, :]
        ex = torch.exp(torch.clamp(total[..., None, :] - cum, max=0.0))
        dAm = dos @ tr(vs)                       # row form: rows t
        dAT = vs @ tr(dos)                       # column form: rows s
        dAd = torch.diagonal(dAm, dim1=-2, dim2=-1)
        AT = torch.zeros(B, H, c, c, dtype=ct)
        drg, dkg = torch.zeros_like(rs), torch.zeros_like(ks)
        nsub = -(-c // SUB)
        for i in range(nsub):                    # the sweep of block i
            ri = slice(SUB * i, min(SUB * (i + 1), c))
            n = ri.stop - ri.start
            gate = torch.where(strict[:n, :n], torch.exp(torch.clamp(
                ce[..., ri, None, :] - cum[..., None, ri, :], max=0.0)), zero)
            prod = rs[..., ri, None, :] * ks[..., None, ri, :] * gate
            Ad = (prod * half0).sum(-1) + (prod * ~half0).sum(-1)
            bonus = rs[..., ri, :] * uf * ks[..., ri, :]
            Ad = Ad + torch.diag_embed((bonus * half0).sum(-1) + (bonus * ~half0).sum(-1))
            AT[..., ri, ri] = tr(Ad)
            dblk = torch.where(strict[:n, :n, 0], dAm[..., ri, ri], zero)
            drg[..., ri, :] = torch.einsum("bhts,bhsk,bhtsk->bhtk", dblk, ks[..., ri, :], gate)
            dkg[..., ri, :] = torch.einsum("bhts,bhtk,bhtsk->bhsk", dblk, rs[..., ri, :], gate)
        du = du + (dAd[..., None] * rs * ks).sum(-2)
        # below the diagonal. dr: t in sub-chunk m, s <= b = 16 m - 1 (the
        # token before t's sub-chunk); A^T and dk: s in sub-chunk i, t > b =
        # 16 (i + 1) - 1 (the last token of s's sub-chunk)
        gr, gk = torch.zeros_like(rs), torch.zeros_like(ks)
        for m in range(1, nsub):
            rm, rj, bref = slice(SUB * m, min(SUB * (m + 1), c)), slice(0, SUB * m), SUB * m - 1
            cb = cum[..., bref, None, :]
            fr = torch.exp(torch.clamp(ce[..., rm, :] - cb, max=0.0))
            kp = ks[..., rj, :] * torch.exp(torch.clamp(cb - cum[..., rj, :], max=0.0))
            gr[..., rm, :] = fr * mmf(bsplit(dAm[..., rm, rj], terms), bsplit(kp, terms))
        for i in range(nsub - 1):
            ri, rt, bref = slice(SUB * i, SUB * (i + 1)), slice(SUB * (i + 1), c), SUB * (i + 1) - 1
            cb = cum[..., bref, None, :]
            fk = torch.exp(torch.clamp(cb - cum[..., ri, :], max=0.0))
            kp = ks[..., ri, :] * fk
            rp = rs[..., rt, :] * torch.exp(torch.clamp(ce[..., rt, :] - cb, max=0.0))
            AT[..., ri, rt] = mmf(bsplit(kp, terms), [tr(t) for t in bsplit(rp, terms)])
            gk[..., ri, :] = fk * mmf(bsplit(dAT[..., ri, rt], terms), bsplit(rp, terms))
        dvc = mmf(bsplit(ks * ex, terms), bsplit(dS, terms)) + mmf(bsplit(AT, terms), [dos])
        ece = torch.exp(ce)
        Tr = gr + ece * mmf([dos], bsplit(tr(S0), terms))
        drc = dAd[..., None] * uf * ks + drg + Tr
        dce = rs * (drg + Tr)
        vds = mmf([vs], bsplit(tr(dS), terms))
        gate_k = dkg + gk
        dkc = dAd[..., None] * uf * rs + gate_k + ex * vds
        Y = ks * ex * vds
        dcum = -ks * gate_k - Y
        ycol = 0
        for i in range(nsub):
            ycol = ycol + Y[..., SUB * i:SUB * (i + 1), :].sum(-2)
        dtot = torch.exp(total) * (dS * S0).sum(-1) + ycol
        dS = torch.exp(total)[..., None] * dS + mmf(bsplit(tr(rs * ece), terms), [dos])
        run_c, run_e = torch.zeros(B, H, K, dtype=ct), torch.zeros(B, H, K, dtype=ct)
        dwc = torch.empty_like(ld)
        for s in reversed(range(c)):
            run_c = run_c + dcum[..., s, :] + (dtot if s == c - 1 else 0)
            dwc[..., s, :] = (run_c + run_e) * ld[..., s, :]
            run_e = run_e + dce[..., s, :]
        for out, val in ((dr, drc), (dk, dkc), (dv, dvc), (dw, dwc)):
            out[:, t0:t0 + c] = val.permute(0, 2, 1, 3)
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, dS


def ssd_states(x, dt, A, Bm, C, state, chunk=64):
    """The state entering each chunk, (B, H, nc, P, N), as the training
    forward writes it: the plain version run chunk by chunk."""
    c = ref.scan_chunk("mamba2_ssd", x.shape[1], chunk)
    out, s = [], state
    for t0 in range(0, x.shape[1], c):
        out.append(s)
        sl = slice(t0, t0 + c)
        _, s = ref.mamba2_ssd_chunked(x[:, sl], dt[:, sl], A, Bm[:, sl], C[:, sl], s, chunk=c)
    return torch.stack(out, dim=2)


def rwkv_states(r, k, v, w, u, state, chunk=64):
    c = ref.scan_chunk("rwkv6_scan", r.shape[1], chunk)
    out, s = [], state
    for t0 in range(0, r.shape[1], c):
        out.append(s)
        sl = slice(t0, t0 + c)
        _, s = ref.rwkv6_chunked(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, s, chunk=c)
    return torch.stack(out, dim=2)


def bwd_args(kernel, seed, B, T, H, d1, d2, dtype=torch.float32, w_mean=-0.5):
    """A scan's inputs, the output's cotangent and the final state's, drawn
    with numpy from the distributions of ``chip_smoke.scan_bwd_inputs``."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))  # noqa: E731
    if kernel == "mamba2_ssd":
        args = [f(B, T, H, d1).to(dtype), torch.nn.functional.softplus(f(B, T, H)),
                -torch.linspace(1.0, 16.0, H), f(B, T, d2).to(dtype), f(B, T, d2).to(dtype),
                0.1 * f(B, H, d1, d2)]
        return args, f(B, T, H, d1).to(dtype), f(B, H, d1, d2)
    args = [f(B, T, H, d1).to(dtype), f(B, T, H, d1).to(dtype), f(B, T, H, d2).to(dtype),
            w_mean + 0.5 * f(B, T, H, d1), (0.1 * f(H, d1)).to(dtype), 0.1 * f(B, H, d1, d2)]
    return args, f(B, T, H, d2).to(dtype), f(B, H, d1, d2)


BWD = {"mamba2_ssd": (ssd_bwd_schedule, ssd_states, ref.mamba2_ssd_bwd_ref),
       "rwkv6_scan": (rwkv_bwd_schedule, rwkv_states, ref.rwkv6_scan_bwd_ref)}


def bwd_sums(kernel, outs):
    """The wrapper's sums of the kernel's partials: dA over the batch, dB
    and dC over the clusters of heads (``ssd_bwd_cluster``); du over the
    batch."""
    if kernel == "mamba2_ssd":
        dx, ddt, dA, dB, dC, ds = outs
        return dx, ddt, dA.sum(0), dB.sum(2), dC.sum(2), ds
    dr, dk, dv, dw, du, ds = outs
    return dr, dk, dv, dw, du.sum(0), ds


BWD_CASES = [
    # kernel, B, T, H, P or K, N or V: several chunks, one ragged chunk of
    # 40 with dims 20 and 72, one chunk of 64
    ("mamba2_ssd", 2, 192, 3, 16, 24), ("mamba2_ssd", 1, 40, 2, 20, 72),
    ("mamba2_ssd", 2, 64, 2, 72, 20), ("rwkv6_scan", 2, 192, 3, 16, 24),
    ("rwkv6_scan", 1, 40, 2, 20, 72), ("rwkv6_scan", 2, 64, 2, 72, 20),
]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("kernel,B,T,H,d1,d2", BWD_CASES)
def test_bwd_schedule_matches_the_plain_backward_in_float64(kernel, B, T, H, d1, d2,
                                                            with_state):
    """In float64 the schedule (its order of sums, its partials, its dA
    terms) and the plain backward are the same math: 1e-10 of each
    gradient's largest value."""
    schedule, states, plain = BWD[kernel]
    args, dout, ds = bwd_args(kernel, T + d1, B, T, H, d1, d2)
    args = [a.double() for a in args]
    if not with_state:
        args[5] = torch.zeros_like(args[5])
    dout, ds = dout.double(), (ds.double() if with_state else None)
    got = bwd_sums(kernel, schedule(*args[:5], states(*args), dout, ds))
    want = plain(*args, dout, ds)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10 * w.abs().max().item())


@pytest.mark.parametrize("kernel,B,T,H,d1,d2,w_mean",
                         [c + (-0.5,) for c in BWD_CASES[:2]]
                         + [c + (w,) for c in BWD_CASES[3:5] for w in W_MEANS])
def test_bwd_schedule_meets_the_card_criterion(kernel, B, T, H, d1, d2, w_mean):
    """In float32, and with bf16 inputs, the schedule meets the criteria
    chip_smoke.py holds the kernels to against a float64 run of the plain
    backward (``chip_smoke.scan_bwd_errors``); rwkv6 also at its strong and
    slow decays."""
    schedule, states, plain = BWD[kernel]
    for dtype in (torch.float32, BF16):
        args, dout, ds = bwd_args(kernel, T + d1, B, T, H, d1, d2, dtype, w_mean)
        got = bwd_sums(kernel, schedule(*args[:5], states(*args), dout, ds))
        want = plain(*(a.double() for a in args), dout.double(), ds.double())
        worst = chip_smoke.scan_bwd_errors(kernel, got, want, args)
        assert all(e <= chip_smoke.SCAN_BWD_TOL[kind] for kind, e in worst.items()), worst


def test_bwd_partials_are_summed_in_one_order():
    """The partials (dA per batch row, du per batch row, dB and dC per
    head) come out of the blocks before any sum: two runs give the same
    bits, and the sums over them are the wrapper's."""
    for kernel, case in (("mamba2_ssd", BWD_CASES[0]), ("rwkv6_scan", BWD_CASES[3])):
        schedule, states, _ = BWD[kernel]
        args, dout, ds = bwd_args(kernel, 3, *case[1:])
        runs = [schedule(*args[:5], states(*args), dout, ds) for _ in range(2)]
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        part = runs[0][2] if kernel == "mamba2_ssd" else runs[0][4]
        assert part.shape[:2] == (case[1], case[3])


@pytest.mark.parametrize("kernel,case,w_mean", [("mamba2_ssd", 0, -0.5), ("rwkv6_scan", 3, -0.5),
                                                ("rwkv6_scan", 3, -6.0)])
def test_bwd_one_term_fails_the_card_criterion(kernel, case, w_mean):
    """The backward kernels split every f32 operand (d(C.B^T), G^T, S0, dS,
    exp(cum) dy; the rescaled r and k, A, dA, dS, S0) into three bf16 terms.
    With one term the emulated schedule lies beyond ``SCAN_BWD_TOL`` (the
    ``__main__`` table: about 2e-3 to 3e-2 of the largest value where the
    tolerances are 2e-5 and 2e-4); with two it passes at these shapes, and
    the kernels keep the forwards' three."""
    schedule, states, plain = BWD[kernel]
    _, B, T, H, d1, d2 = BWD_CASES[case]
    args, dout, ds = bwd_args(kernel, T + d1, B, T, H, d1, d2, BF16, w_mean)
    want = plain(*(a.double() for a in args), dout.double(), ds.double())
    got = bwd_sums(kernel, schedule(*args[:5], states(*args), dout, ds, terms=1))
    worst = chip_smoke.scan_bwd_errors(kernel, got, want, args)
    assert any(e > chip_smoke.SCAN_BWD_TOL[k] for k, e in worst.items()), worst


def test_rwkv_bwd_factors_never_exceed_one():
    """Every rescale factor of the backward is exp of a sum of log-decays <=
    0 (up to rounding where the kernel clamps): below the diagonal dr's
    pair, about b = 16 m - 1 (t in sub-chunk m, s <= b), and A^T's and dk's,
    about b = 16 (i + 1) - 1 (s in sub-chunk i, t > b); dv's and dk's
    exp(total - cum) and the state update's exp(ce). Nothing overflows, and a
    factor that underflows to 0 stands for a product at least as small."""
    for w_mean in W_MEANS:
        w = w_mean + 0.5 * torch.from_numpy(
            np.random.default_rng(6).standard_normal((TILE, 8)).astype(np.float32))
        ld = -torch.exp(w)
        cum = torch.cumsum(ld, 0)
        ce = cum - ld
        ulps = lambda x: 4 * torch.finfo(torch.float32).eps * x.abs()  # noqa: E731
        for m in range(1, TILE // SUB):            # dr: t in sub-chunk m
            b = SUB * m - 1
            assert (ce[SUB * m:SUB * (m + 1)] - cum[b] <= ulps(cum[b])).all()
            assert (cum[b] - cum[:SUB * m] <= 0).all()
        for i in range(TILE // SUB - 1):           # A^T and dk: s in sub-chunk i
            b = SUB * (i + 1) - 1
            assert (cum[b] - cum[SUB * i:SUB * (i + 1)] <= 0).all()
            assert (ce[b + 1:] - cum[b] <= ulps(cum[b])).all()
        assert (cum[-1] - cum <= 0).all() and (ce <= 0).all()


def test_bwd_launch_plans():
    """The wrappers' mirrors of the backward kernels' plans: the cluster of
    heads whose dB and dC ``mamba2_ssd_bwd`` sums in the launch (the largest
    divisor of H up to 8 while N fits one 64-column pass), and
    ``rwkv6_scan_bwd``'s shared memory (w and S0 staged and the f32 tiles
    there at K = V = 64; neither at K = V = 128, which takes a global
    scratch of four 64 x (Kp + 4) tiles a block)."""
    from repro_torch.kernels.rwkv6_scan import bwd_scratch_floats, bwd_tc_layout
    assert ssd_bwd_cluster(112, 64, 64) == 8        # zamba2: 14 partials of 8 heads
    assert ssd_bwd_cluster(4, 72, 24) == 4
    assert ssd_bwd_cluster(3, 16, 24) == 3
    assert ssd_bwd_cluster(9, 64, 64) == 3
    assert ssd_bwd_cluster(4, 24, 72) == 1          # N = 72: 80 columns, two passes
    assert ssd_bwd_cluster(112, 128, 128) == 1
    assert bwd_tc_layout(64, 64) == (211456, True, True)
    assert bwd_tc_layout(72, 24)[1:] == (True, True)
    assert bwd_tc_layout(128, 128) == (191232, False, False)
    assert bwd_scratch_floats(8, 32, 64, 64, 64, bf16=True) == 0
    assert bwd_scratch_floats(2, 4, 128, 128, 64, bf16=True) == 2 * 4 * 4 * 64 * 132


if __name__ == "__main__":
    # the table the kernels' notes cite: how far each schedule lies beyond
    # the card's criterion with 1, 2 and 3 bf16 terms (output, state)
    args = ssd_inputs(11, 2, 128, 8, 64, 64)
    want = ref.mamba2_ssd_chunked(*args)
    for terms in (1, 2, 3):
        y, s = ssd_schedule(*args, terms=terms)
        print(f"mamba2_ssd 2x128x8x64x64 terms={terms}: output {excess(y, want[0]):.2e} "
              f"state {excess(s, want[1]):.2e}")
    for w_mean in W_MEANS:
        args = rwkv_inputs(12, 1, 128, 4, 64, 64, w_mean)
        want = ref.rwkv6_chunked(*args)
        for terms in (1, 2, 3):
            o, s = rwkv_schedule(*args, terms=terms)
            print(f"rwkv6_scan 1x128x4x64x64 w~N({w_mean}, 0.5) terms={terms}: output "
                  f"{excess(o, want[0]):.2e} state {excess(s, want[1]):.2e}")
    # the backward schedules beyond SCAN_BWD_TOL's kinds with 1, 2 and 3
    # bf16 terms (bf16 inputs; the kernels' notes cite it)
    for kernel, B, T, H, d1, d2 in BWD_CASES:
        for w_mean in ([-0.5] if kernel == "mamba2_ssd" else W_MEANS):
            schedule, states, plain = BWD[kernel]
            args, dout, ds = bwd_args(kernel, T + d1, B, T, H, d1, d2, BF16, w_mean)
            want = plain(*(a.double() for a in args), dout.double(), ds.double())
            cells = []
            for terms in (1, 2, 3):
                got = bwd_sums(kernel, schedule(*args[:5], states(*args), dout, ds, terms=terms))
                worst = chip_smoke.scan_bwd_errors(kernel, got, want, args)
                cells.append(" ".join(f"{k}={e:.2e}" for k, e in sorted(worst.items())))
            print(f"{kernel}_bwd {B}x{T}x{H}x{d1}x{d2} w~N({w_mean}, 0.5): "
                  + " | ".join(f"terms={n}: {c}" for n, c in zip((1, 2, 3), cells)))
    # the ratios test_the_rule_constant cites: the least c each schedule and
    # the float32 plain version pass the rule with, over eight draws at the
    # stress shapes, and one-term schedules at the main shapes
    for seed in range(8):
        args = ssd_inputs(seed, 1, 4096, 112, 64, 64)
        y, _ = ssd_schedule(*args)
        print(f"mamba2_ssd 1x4096x112x64x64 seed {seed}: three terms "
              f"c >= {rule_ratio('mamba2_ssd', args, y):.1f}, float32 plain version "
              f"c >= {rule_ratio('mamba2_ssd', args, ref.mamba2_ssd_chunked(*args)[0]):.1f}")
    for seed in range(8):
        args = rwkv_inputs(seed, 1, 4096, 32, 64, 64, -0.5)
        o, _ = rwkv_schedule(*args)
        print(f"rwkv6_scan 1x4096x32x64x64 seed {seed}: three terms "
              f"c >= {rule_ratio('rwkv6_scan', args, o):.1f}")
    args = ssd_inputs(11, 2, 128, 8, 64, 64)
    print(f"mamba2_ssd 2x128x8x64x64 one term: c >= "
          f"{rule_ratio('mamba2_ssd', args, ssd_schedule(*args, terms=1)[0]):.1f}")
    for w_mean in W_MEANS:
        args = rwkv_inputs(12, 1, 128, 4, 64, 64, w_mean)
        print(f"rwkv6_scan 1x128x4x64x64 w~N({w_mean}, 0.5) one term: c >= "
              f"{rule_ratio('rwkv6_scan', args, rwkv_schedule(*args, terms=1)[0]):.1f}")
