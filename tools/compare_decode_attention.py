#!/usr/bin/env python3
"""Time ``decode_attention`` of an earlier checkout against this checkout's
on one card, in turns: old, new, new, old; then this checkout's launch that
also writes each head's log-sum-exp.

    python3 tools/compare_decode_attention.py --old DIR [--seed 0]

DIR holds the earlier ``decode_attention.cu`` and the headers it includes
(``git show <commit>:src/repro_torch/kernels/csrc/<file>``). It is built with
this checkout's nvcc flags into DIR and called through ctypes with the
earlier C entry (no lse argument) and the scratch the wrapper gives it. The
new kernel runs through its wrappers: ``decode_attention`` (a null lse) and
``decode_attention_lse``. Rows: llama3-8b's decode step on one card
(8x512x32/8x128 bf16, ``chip_smoke.py``'s main row) and the shards of the
``sharded_serve`` phase (``chip_smoke.DECODE_LSE_ROWS``' bf16 rows with
valid entries). Each timing is the median of ``chip_smoke.TIMING_REPS``
calls by CUDA events; the old and new outputs must be equal bit for bit.
Prints the card's name and power limit. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OLD_SIGNATURE = ((ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) * 2
                 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))


def build_old(directory: Path):
    """The earlier source's C entry, built into ``directory``."""
    from repro_torch.kernels import _build
    src, so = directory / "decode_attention.cu", directory / "decode_attention.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, str(src), "-o",
                          str(so)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(so)).memforest_decode_attention
    fn.argtypes = OLD_SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as c
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                     decode_attention_lse,
                                                     plan_splits,
                                                     scratch_sizes)

    if not torch.cuda.is_available():
        print("compare_decode_attention: no CUDA card", file=sys.stderr)
        return 1
    old = build_old(args.old.resolve())
    print(f"card: {c.card_line()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    main_lens = np.random.default_rng(args.seed).integers(40, 200, size=8)
    rows = [(8, 512, 32, 8, 128, main_lens.tolist(), "llama decode")]
    for B, Smax, Hq, Hkv, D, lo, hi, dname, _, what in c.DECODE_LSE_ROWS:
        if dname == "bf16" and hi > 0:
            lens = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
            rows.append((B, Smax, Hq, Hkv, D, lens.tolist(), what))
    for B, Smax, Hq, Hkv, D, lengths, what in rows:
        q = torch.randn(B, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn(B, Smax, Hkv, D, generator=g,
                         device=dev).to(torch.bfloat16)
        vc = torch.randn(B, Smax, Hkv, D, generator=g,
                         device=dev).to(torch.bfloat16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        splits, chunk = plan_splits(Smax)
        out = torch.empty_like(q)
        n_part, n_cnt = scratch_sizes(B, Hq, Hkv, D, splits, True)
        stream = torch.cuda.current_stream().cuda_stream

        def old_call():
            part = torch.empty(max(n_part, 1), dtype=torch.float32,
                               device=dev)
            cnt = _build.counters(dev, n_cnt)
            err = old(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                      lens.data_ptr(), out.data_ptr(),
                      part.data_ptr() if splits > 1 else None,
                      cnt.data_ptr() if splits > 1 else None, n_part,
                      cnt.numel(), B, Smax, Hq, Hkv, D, D, chunk, splits, 1,
                      stream)
            if err:
                raise RuntimeError(f"old launch failed: cudaError {err}")
            return out

        old_call()
        torch.cuda.synchronize()
        new_out = decode_attention(q, kc, vc, lens)
        same = torch.equal(out, new_out)
        times = [c.device_ms(torch, f) for f in (
            old_call, lambda: decode_attention(q, kc, vc, lens),
            lambda: decode_attention(q, kc, vc, lens), old_call)]
        lse_ms = c.device_ms(torch, lambda: decode_attention_lse(
            q, kc, vc, lens))
        null = (times[1] + times[2]) / 2
        print(f"compare: decode_attention {what} {B}x{Smax}x{Hq}/{Hkv}x{D} "
              f"bf16 old/new/new/old ms=" + "/".join(f"{t:.5f}" for t in times)
              + f" new_over_old={null / ((times[0] + times[3]) / 2):.4f} "
              f"lse_ms={lse_ms:.5f} lse_over_null={lse_ms / null:.4f} "
              f"outputs_equal={same}", flush=True)
        if not same:
            print("compare: the outputs differ", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
