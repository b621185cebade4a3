#!/usr/bin/env python3
"""Time the scans' backward kernels of an earlier checkout against this
checkout's on one card, in turns: old, new, new, old.

    python3 tools/compare_scan_bwd.py --old DIR [--seed 0]

DIR holds the earlier ``mamba2_ssd_bwd.cu`` and ``rwkv6_scan_bwd.cu`` and
the headers they include (``git show <commit>:src/repro_torch/kernels/csrc/
<file>`` for each). Both are built with this checkout's nvcc flags into DIR
and called through ctypes with the earlier C entries' output shapes: per
head (B, T, H, N) partials of dB and dC for ``mamba2_ssd_bwd``, a working
set a block in global scratch past 227 KB for ``rwkv6_scan_bwd``. The new
kernels run through their wrappers. Rows: zamba2's training shape
(8x512x112x64x64 bf16) and rwkv6's (8x512x32x64x64 bf16) at w ~ N(-0.5,
0.5), N(1.5, 0.5) (strong decay) and N(-6, 0.5) (slow decay), inputs from
``chip_smoke.scan_bwd_inputs``. Prints each timing (the median of
``chip_smoke.TIMING_REPS`` calls by CUDA events), the largest difference
between the two versions' gradients over the largest value, and the card's
name and power limit. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ROWS = (("mamba2_ssd", 8, 512, 112, 64, 64, None),
        ("rwkv6_scan", 8, 512, 32, 64, 64, -0.5),
        ("rwkv6_scan", 8, 512, 32, 64, 64, 1.5),
        ("rwkv6_scan", 8, 512, 32, 64, 64, -6.0))


def build_old(directory: Path, source: str):
    """The earlier source's C entry, built into ``directory``."""
    from repro_torch.kernels import _build
    so = directory / f"{source}.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, str(directory / source), "-o",
                          str(so)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{source}: nvcc failed\n{out.stdout}{out.stderr}")
    entry = "memforest_" + source[:-3]
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def old_call(torch, fn, kernel, args, dout, ds, states):
    """One call of the earlier kernel with its own output shapes -> the
    gradients as the earlier wrapper returned them."""
    stream = torch.cuda.current_stream().cuda_stream
    f = dict(dtype=torch.float32, device="cuda")
    if kernel == "mamba2_ssd":
        x, dt, A, Bm, C, s0 = args
        B, T, H, P = x.shape
        N = Bm.shape[-1]
        dx, ddt, dstate = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(s0)
        dA_part = torch.empty((B, H), **f)
        dB_part, dC_part = (torch.empty((B, T, H, N), **f) for _ in range(2))
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                 states.data_ptr(), dout.data_ptr(), ds.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
                 dstate.data_ptr(), B, T, H, P, N, 64, 1, stream)
        assert err == 0, f"the earlier mamba2_ssd_bwd refused the call: {err}"
        return (dx, ddt, dA_part.sum(0), dB_part.sum(2).to(Bm.dtype),
                dC_part.sum(2).to(C.dtype), dstate)
    r, k, v, w, u, s0 = args
    B, T, H, K = r.shape
    V = v.shape[-1]
    dr, dk, dv, dw, dstate = (torch.empty_like(t) for t in (r, k, v, w, s0))
    du_part = torch.empty((B, H, K), **f)
    scratch = torch.empty(1, **f)              # K = V = 64: shared memory holds it
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
             states.data_ptr(), dout.data_ptr(), ds.data_ptr(), dr.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), dstate.data_ptr(),
             scratch.data_ptr(), 0, B, T, H, K, V, 64, 1, stream)
    assert err == 0, f"the earlier rwkv6_scan_bwd refused the call: {err}"
    return dr, dk, dv, dw, du_part.sum(0).to(u.dtype), dstate


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_scan_bwd: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch.kernels import mamba2_ssd as M
    from repro_torch.kernels import rwkv6_scan as R
    print(c.card_line(), flush=True)
    olds = {"mamba2_ssd": build_old(opts.old, "mamba2_ssd_bwd.cu"),
            "rwkv6_scan": build_old(opts.old, "rwkv6_scan_bwd.cu")}
    mods = {"mamba2_ssd": M, "rwkv6_scan": R}
    g = torch.Generator(device="cuda").manual_seed(opts.seed + 5)
    for kernel, B, T, H, d1, d2, w_mean in ROWS:
        mod = mods[kernel]
        args, dout, ds = c.scan_bwd_inputs(torch, kernel, g, B, T, H, d1, d2, torch.bfloat16,
                                           -0.5 if w_mean is None else w_mean)
        with torch.no_grad():
            _, _, states = mod._forward(*args, 64, keep_states=True)
        bwd = M.mamba2_ssd_bwd if kernel == "mamba2_ssd" else R.rwkv6_scan_bwd
        calls = {"new": lambda: bwd(*args, dout, ds, states=states),
                 "old": lambda: old_call(torch, olds[kernel], kernel, args, dout, ds, states)}
        got_new, got_old = calls["new"](), calls["old"]()
        torch.cuda.synchronize()
        diff = max(((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
                   for a, b in zip(got_new, got_old))
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(c.device_ms(torch, calls[which]))
        label = f"{kernel}_bwd {B}x{T}x{H}x{d1}x{d2} bf16" + (
            f" w~N({w_mean},0.5)" if w_mean is not None else "")
        print(f"compare: {label} old_ms={times['old'][0]:.5f},{times['old'][1]:.5f} "
              f"new_ms={times['new'][0]:.5f},{times['new'][1]:.5f} "
              f"old_median={statistics.median(times['old']):.5f} "
              f"new_median={statistics.median(times['new']):.5f} "
              f"max_rel_diff={diff:.3e}", flush=True)
    print(c.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
