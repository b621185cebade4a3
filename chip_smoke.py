#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own line; any failed check exits nonzero:

  1. device   the card's name and power limit (nvidia-smi); compute
              capability 9.0 is required.
  2. build    nvcc builds the kernels from src/repro_torch/kernels/csrc.
  3. check    every kernel against its plain PyTorch version on the card, at
              the shapes the main paths give it and at stress and edge shapes,
              with the kernel's, the plain version's, the library call's and
              the bound's time in ms; two ``decode_attention`` calls must give
              equal bits, and one call must be one device launch.
  4. slice    the memory system's path through ``repro_torch.MemForestSystem``
              with its hashing encoder: ``ingest_batch`` of 500 sessions (about
              20k turns, 13k tree nodes) in batches of 16, then ``query_batch``
              of 64 queries in each of the six browse modes. Launch counts are
              reset just before and read just after; every kernel of the path
              must have launched and no plain version may have run. The same
              run on the CPU must give the same facts, trees, answers and
              evidence, and embeddings within 1e-5.
  5. serve    the serve engine on llama3-8b at its published width and depth
              (bf16, random weights from a seeded generator on the card):
              ``ServeEngine(max_batch=8, max_len=512)`` whose memory is a
              ``MemForestSystem(embed_dim=4096)`` with a ``ModelEncoder`` on the
              same weights. The 500 sessions go through the ingest lane, the 64
              queries through the query lane, and 16 decode requests (two
              rounds of 8 identical prefix-keyed prompts, 32 new tokens each)
              through the decode lane. Launch counts are reset just before and
              read just after: all five kernels must have launched, no plain
              version may have run, the prefix cache must have been reused and
              every query answered. A profiled repeat gives the device's idle
              share.
  6. parity   the same engine traffic at llama3-8b's full width but depth 2,
              in float32, on a few sessions, on the card and on the CPU: equal
              decoded tokens, facts, trees and answers; embeddings within 1e-4.
  7. zamba2   the serve engine on zamba2-7b at its published width and depth
              (81 Mamba2 layers, the shared attention block after every 6;
              bf16, random weights from a seeded generator on the card):
              ``ServeEngine(max_batch=8, max_len=512)`` whose memory is a
              ``MemForestSystem`` with the hashing encoder at the paper's
              defaults. The same two rounds of traffic as phase 5, with 8
              prefix-keyed prompts of exactly 128 tokens (the scans take T <= 64
              or a multiple of 64). ``mamba2_ssd`` must launch at least 81
              times, the attention kernels once per application of the shared
              block, the forest kernels at all; no plain version may run.
  8. rwkv6    the same on rwkv6-1.6b (24 layers); ``rwkv6_scan`` must launch
              at least 24 times.
  9. ssm_parity  zamba2 at full width and 7 layers (one group and one
              remainder layer) and rwkv6 at full width and 2 layers, float32,
              a few sessions, on the card and on the CPU with the same
              weights: equal decoded tokens, facts, trees and answers; the
              final ssd / wkv state within 1e-4.
  10. kernels one line per kernel, and the JSON summary of all of them.

The last line of output is ``{"ok": true, "device": {...}}``. Without a
visible CUDA device, or without the rest of the repository beside it, the
script exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODES = ("flat", "root-only", "emb", "emb+planner", "llm", "llm+planner")
SLEEP_CYCLES = 2_000_000     # keeps the stream busy while launches queue up
TIMING_REPS = 25
# memory rate (bytes/s), non-tensor fp32 rate and dense bf16 tensor-core rate
# (FLOP/s) of the H100 SXM, from NVIDIA's data sheet; the bounds are computed
# for this card only. A bf16 kernel's bound uses the bf16 rate: the least
# time the card could take for its work.
H100_SXM_PEAKS = {"bytes": 3.35e12, "fp32": 67e12, "bf16": 989e12}
REPLACES = {
    "tree_refresh": "src/repro/kernels/tree_refresh.py:54",
    "topk_sim": "src/repro/kernels/topk_sim.py:149",
    "browse_scores": "src/repro/kernels/browse_scores.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:116",
    "decode_attention": "src/repro/kernels/decode_attention.py:103",
    "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:119",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:125",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}
SLICE_KERNELS = ("tree_refresh", "topk_sim", "browse_scores")
SERVE_KERNELS = SLICE_KERNELS + ("flash_attention", "decode_attention")


class CheckFailed(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def device_ms(torch, fn) -> float:
    """Median device time of one call, CUDA events around it. A sleep kernel
    ahead of each call lets the host queue the call before the device reaches
    it, so host launch overhead stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_events(torch, fn):
    """Names of the device activities (kernels, copies, fills) of one call
    of ``fn``, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if str(ev.device_type).endswith("CUDA")]


def peaks_for(name: str):
    need("H100" in name and not any(v in name for v in ("PCIe", "NVL")),
         f"no peak figures for {name!r}: the bounds hold for the H100 SXM")
    return H100_SXM_PEAKS


def bound_ms(nbytes: float, flops: float, peaks, op: str = "fp32"):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and operations over the peak rate of type ``op``."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = flops / peaks[op] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(torch, peaks, seed: int):
    from repro_torch.kernels import ref
    from repro_torch.kernels.browse_scores import browse_scores
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.topk_sim import topk_sim
    from repro_torch.kernels.tree_refresh import tree_refresh

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    def record(name, label, err, tol, fn, plain, nbytes, flops, main,
               library=None, op="fp32"):
        """Time the kernel, its plain version and the library call. A main
        row is one the main paths run; the first main row of a kernel is
        its row in the JSON summary, the others ride along in it."""
        ms = device_ms(torch, fn)
        plain_ms = device_ms(torch, plain)
        lib_ms = device_ms(torch, library) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, peaks, op)
        peak = peaks["bytes"] / 1e12 if b_by == "bytes" else peaks[op] / 1e12
        unit = "TB/s" if b_by == "bytes" else f"TFLOP/s {op}"
        lib_txt = f"{lib_ms:.5f}" if lib_ms is not None else "none"
        print(f"check: {name} {label} max_abs_err={err:.3e} (tol {tol:.0e}) "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_txt} "
              f"bound_ms={b_ms:.5f} ({b_by} at {peak:g} {unit})", flush=True)
        if main:
            row = {"shape": label, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "peak": "bytes" if b_by == "bytes" else op,
                   "library_ms": lib_ms}
            if name not in results:
                results[name] = dict(row, other_main_rows=[])
            else:
                results[name]["other_main_rows"].append(row)

    # -- tree_refresh -------------------------------------------------------
    for (P, K, D), main in (((128, 8, 256), True), ((128, 8, 4096), True),
                            ((4096, 16, 256), False)):
        emb = ref.normalize_rows(torch.randn(P * K, D, generator=g, device=dev)
                                 ).reshape(P, K, D).contiguous()
        cnt = torch.randint(0, K + 1, (P,), generator=g, device=dev)
        cnt[: P // 16] = 0                      # parents with no real child
        mask = (torch.arange(K, device=dev)[None, :] < cnt[:, None]).float()
        out = tree_refresh(emb, mask)
        torch.cuda.synchronize()
        want = ref.tree_refresh_ref(emb, mask)
        err = (out - want).abs().max().item()
        need(err <= 1e-5, f"tree_refresh {P}x{K}x{D}: max err {err}")
        need(bool((out[cnt == 0] == 0).all()), "tree_refresh: empty parents "
             "must give zero rows")
        record("tree_refresh", f"{P}x{K}x{D}", err, 1e-5,
               lambda: tree_refresh(emb, mask),
               lambda: ref.tree_refresh_ref(emb, mask),
               (P * K * D + P * K + P * D) * 4, 2 * P * K * D + 3 * P * D, main)

    # -- browse_scores ------------------------------------------------------
    for (F, K, D), main in (((1024, 8, 256), True), ((512, 8, 4096), True),
                            ((4096, 16, 256), False)):
        # unit rows, as the browse gathers them from the forest
        child = ref.normalize_rows(torch.randn(F * K, D, generator=g,
                                               device=dev)).reshape(F, K, D)
        q = ref.normalize_rows(torch.randn(F, D, generator=g, device=dev))
        mask = (torch.rand(F, K, generator=g, device=dev) < 0.7).float()
        out = browse_scores(child, q, mask)
        torch.cuda.synchronize()
        want = ref.browse_scores_ref(child, q, mask)
        err = (out - want).abs().max().item()
        need(err <= 2e-5, f"browse_scores {F}x{K}x{D}: max err {err}")
        need(bool((out[mask == 0] == 0).all()), "browse_scores: padded slots "
             "must score exactly 0")

        # one library call computes the same function; timed for comparison
        def library():
            return torch.einsum("fkd,fd,fk->fk", child, q, mask)
        lib_err = (library() - want).abs().max().item()
        need(lib_err <= 2e-5, f"browse_scores library call: max err {lib_err}")
        record("browse_scores", f"{F}x{K}x{D}", err, 2e-5,
               lambda: browse_scores(child, q, mask),
               lambda: ref.browse_scores_ref(child, q, mask),
               (F * K * D + F * D + 2 * F * K) * 4, 2 * F * K * D, main,
               library)

    # -- topk_sim -----------------------------------------------------------
    def topk_case(Q, N, D, k, nv, *, main=False, plant=False, normalize=False):
        keys = ref.normalize_rows(torch.randn(N, D, generator=g, device=dev))
        q = ref.normalize_rows(torch.randn(Q, D, generator=g, device=dev))
        ties = []
        if plant:
            # exact ties: two equal key rows equal to a query, the pair in
            # one tile, in two splits, and one copy past num_valid
            spots = [(0, 5, 6), (1, 17, N // 2 + 3), (2, 100, nv - 1)]
            for qi, a, b in spots[: min(Q, 3)]:
                keys[a] = q[qi]
                keys[b] = q[qi]
                ties.append((qi, sorted((a, b))))
            if nv < N and Q > 3:
                keys[nv] = q[3]                 # masked: must never appear
        qn, kn = (q * 3.0, keys * 0.5) if normalize else (q, keys)
        vals, idx = topk_sim(qn, kn, k, normalize=normalize, num_valid=nv)
        torch.cuda.synchronize()
        kk = min(k + 1, N)
        pv, pi = ref.topk_sim_ref(qn, kn, kk, normalize=normalize,
                                  num_valid=nv)
        pv_k, pi_k = pv[:, :k], pi[:, :k]
        live = pv_k > -1e29
        err = (vals - pv_k).abs()[live].max().item() if live.any() else 0.0
        need(err <= 1e-5, f"topk_sim {Q}x{N} k={k}: value err {err}")
        need(bool((vals[~live] == -1e30).all() and (idx[~live] == -1).all()),
             f"topk_sim {Q}x{N} k={k}: dead slots must be -1e30 / -1")
        # an index may differ only where the plain version's neighbouring
        # scores lie within 1e-5 of each other
        gap_prev = torch.full_like(pv_k, float("inf"))
        gap_prev[:, 1:] = (pv_k[:, 1:] - pv_k[:, :-1]).abs()
        gap_next = torch.full_like(pv_k, float("inf"))
        nxt = pv[:, 1:k + 1]
        gap_next[:, : nxt.shape[1]] = (pv_k[:, : nxt.shape[1]] - nxt).abs()
        firm = (gap_prev > 1e-5) & (gap_next > 1e-5)
        bad = (idx != pi_k) & firm
        need(not bool(bad.any()), f"topk_sim {Q}x{N} k={k}: "
             f"{int(bad.sum())} indices differ where scores are apart")
        for qi, pair in ties:
            got = idx[qi, :2].tolist()
            need(got == pair and vals[qi, 0].item() == vals[qi, 1].item(),
                 f"topk_sim tie for query {qi}: got {got}, want {pair}")
        if nv < N and Q > 3:
            need(not bool((idx == nv).any()), "topk_sim: a key past "
                 "num_valid was returned")
        label = f"{Q}x{N}x{D} k={k} num_valid={nv}" + \
            (" normalize" if normalize else "")
        record("topk_sim", label, err, 1e-5,
               lambda: topk_sim(qn, kn, k, normalize=normalize, num_valid=nv),
               lambda: ref.topk_sim_ref(qn, kn, k, normalize=normalize,
                                        num_valid=nv),
               (N * D + Q * D) * 4 + Q * k * 8, 2 * Q * nv * D, main)

    topk_case(64, 256, 256, 16, 256)
    topk_case(64, 1024, 256, 24, 1024, main=True)
    topk_case(32, 1024, 4096, 24, 1024, main=True)      # the serve phase's D
    topk_case(64, 256, 256, 16, 5)                       # num_valid < k
    topk_case(8, 1000, 256, 7, 1000, normalize=True)
    big = 262144
    topk_case(64, big, 256, 16, big - 1, plant=True)
    topk_case(1, big, 256, 32, big - 1, plant=True)
    topk_case(200, big, 256, 32, big - 1, plant=True)

    # -- flash_attention ----------------------------------------------------
    # bf16 rows: tests/test_kernels.py's bf16 criterion, |err| <= 2e-2 +
    # 1e-2 |plain|. The kernel computes on the tensor cores from the same
    # bf16 inputs, keeps the softmax in f32 and rounds P to bf16 before P.V
    # (the plain version keeps P in f32); tests/test_torch_attention_design.py
    # shows on the CPU that this arithmetic stays within the criterion. f32
    # rows (the CUDA-core kernel): 2e-5 (f32 sums in another order).
    # The library call is checked only to show that it computes the same
    # function: its bf16 kernels round P to bf16 before P.V, so it is held
    # to 5e-2 (bf16) or 1e-3 (f32) beyond 5e-2 |plain|.
    F = torch.nn.functional
    tols = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (2e-5, 0.0)}
    lib_tols = {torch.bfloat16: (5e-2, 5e-2), torch.float32: (1e-3, 5e-2)}
    ops_of = {torch.bfloat16: "bf16", torch.float32: "fp32"}

    def agree(out, want, dt, what, tolerances=tols):
        atol, rtol = tolerances[dt]
        o, w = out.float(), want.float()
        excess = ((o - w).abs() - rtol * w.abs()).max().item()
        need(excess <= atol, f"{what}: differs from the plain version by "
             f"{excess:.3e} beyond rtol {rtol} (atol {atol})")
        return (o - w).abs().max().item()

    def row_scaled(out, want, what):
        """Stress rows, besides agree(): each output row (the last dim) within
        2e-2 of its own largest plain value. Over thousands of random keys
        the outputs are small (about 0.01 at 32k keys), where agree()'s 2e-2
        alone would pass a dropped or misweighed group of keys. An all-zero
        plain row (length 0) must come out zero."""
        o, w = out.float().flatten(0, -2), want.float().flatten(0, -2)
        top = w.abs().amax(-1)
        dev_ = (o - w).abs().amax(-1)
        worst = torch.where(top > 0, dev_ / top.clamp_min(1e-30),
                            dev_ * 1e30).max().item()
        print(f"check: {what} worst row max|err| / row max|plain| = "
              f"{worst:.3e} (tol 2e-2)", flush=True)
        need(worst <= 2e-2, f"{what}: a row differs from the plain version "
             f"by {worst:.3e} of its largest value (tol 2e-2)")

    def flash_case(B, S, Hq, Hkv, D, causal, dt, main, what):
        q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dt)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        label = (f"{what} {B}x{S}x{Hq}/{Hkv}x{D} "
                 f"{'causal' if causal else 'full'} {ops_of[dt]}")
        plain_out = ref.attention_ref(q, k, v, causal=causal)
        err = agree(out, plain_out, dt, f"flash_attention {label}")
        if what == "stress":
            row_scaled(out, plain_out, f"flash_attention {label}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():     # timed for comparison; the port never calls it
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        agree(library().transpose(1, 2), out, dt,
              f"flash_attention {label}: the library call", lib_tols)
        pairs = S * (S + 1) // 2 if causal else S * S
        elem = out.element_size()
        record("flash_attention", label, err, tols[dt][0],
               lambda: flash_attention(q, k, v, causal=causal),
               lambda: ref.attention_ref(q, k, v, causal=causal),
               (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * elem,
               4 * B * Hq * pairs * D, main, library, ops_of[dt])

    bf16, f32 = torch.bfloat16, torch.float32
    flash_case(336, 28, 32, 8, 128, True, bf16, True, "encoder")
    flash_case(8, 128, 32, 8, 128, True, bf16, True, "prefill")
    flash_case(8, 128, 32, 32, 112, True, bf16, True, "zamba2 prefill")
    flash_case(48, 28, 32, 8, 128, True, f32, False, "parity encoder")
    flash_case(64, 12, 32, 8, 128, True, bf16, False, "short encoder batch")
    flash_case(2, 77, 32, 8, 72, True, bf16, False, "head dim padded to 80")
    flash_case(4, 100, 16, 4, 64, False, bf16, False, "head dim 64")
    flash_case(2, 33, 8, 8, 20, True, bf16, False, "head dim padded to 24")
    flash_case(1, 40, 128, 1, 64, True, bf16, False, "group of 128")
    flash_case(1, 4096, 32, 8, 128, True, bf16, False, "stress")
    flash_case(2, 2048, 32, 32, 96, False, bf16, False, "stress")

    # -- decode_attention ---------------------------------------------------
    def decode_case(B, Smax, Hq, Hkv, D, lengths, dt, main, what):
        q = torch.randn(B, Hq, D, generator=g, device=dev).to(dt)
        kc = torch.randn(B, Smax, Hkv, D, generator=g, device=dev).to(dt)
        vc = torch.randn(B, Smax, Hkv, D, generator=g, device=dev).to(dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, lens)
        again = decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        label = f"{what} {B}x{Smax}x{Hq}/{Hkv}x{D} {ops_of[dt]}"
        need(torch.equal(out, again), f"decode_attention {label}: two calls "
             "on the same inputs differ")
        plain_out = ref.decode_attention_ref(q, kc, vc, lens)
        err = agree(out, plain_out, dt, f"decode_attention {label}")
        if what.startswith("stress"):
            row_scaled(out, plain_out, f"decode_attention {label}")
        need(bool((out[lens == 0] == 0).all()), "decode_attention: length 0 "
             "must give zeros")
        live = lens > 0                 # the library call has no answer at 0
        mask = (torch.arange(Smax, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

        def library():     # timed for comparison; the port never calls it
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        agree(library()[:, :, 0][live], out[live], dt,
              f"decode_attention {label}: the library call", lib_tols)
        rows = sum(min(max(n, 0), Smax) for n in lengths)
        elem = out.element_size()
        record("decode_attention", label, err, tols[dt][0],
               lambda: decode_attention(q, kc, vc, lens),
               lambda: ref.decode_attention_ref(q, kc, vc, lens),
               2 * rows * Hkv * D * elem + 2 * B * Hq * D * elem + 4 * B,
               4 * rows * Hq * D, main, library, ops_of[dt])

    rng = np.random.default_rng(seed)
    main_lens = rng.integers(40, 200, size=8).tolist()
    decode_case(8, 512, 32, 8, 128, main_lens, bf16, True, "decode")
    decode_case(8, 512, 32, 32, 112, rng.integers(128, 161, size=8).tolist(),
                bf16, True, "zamba2 decode")
    decode_case(4, 512, 32, 8, 128, rng.integers(20, 80, size=4).tolist(),
                f32, False, "parity decode")
    decode_case(8, 512, 32, 8, 128, [1, 64, 127, 128, 100, 5, 128, 77], bf16,
                False, "one live chunk")
    decode_case(8, 512, 32, 8, 128, [128, 256, 384, 512, 129, 255, 0, 600],
                bf16, False, "chunk boundaries")
    decode_case(3, 300, 8, 2, 36, [300, 37, 1], bf16, False, "head dim 36")
    decode_case(4, 512, 32, 2, 128, [300, 0, 512, 77], bf16, False,
                "group of 16")
    decode_case(2, 512, 64, 2, 64, [400, 129], bf16, False, "group of 32")
    decode_case(1, 32768, 32, 8, 128, [32760], bf16, False, "stress split-KV")
    wide = rng.integers(1, 4097, size=64).tolist()
    wide[0], wide[1] = 0, 5000          # an empty row, a row past Smax
    decode_case(64, 4096, 32, 8, 128, wide, bf16, False, "stress")

    # the C entry refuses a scratch smaller than its layout and a head dim
    # the tensor maps cannot take (the wrapper pads those)
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import _counters, scratch_sizes
    q = torch.zeros(2, 8, 40, dtype=bf16, device=dev)
    kc = torch.zeros(2, 1024, 2, 40, dtype=bf16, device=dev)
    lens = torch.full((2,), 1000, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    n_part, n_cnt = scratch_sizes(2, 8, 2, 40, 8, True)
    part = torch.empty(n_part, dtype=torch.float32, device=dev)
    cnt = _counters(dev, n_cnt)

    def entry(n_floats, n_counters, D, scale_dim):
        try:
            _build.launch("decode_attention", "memforest_decode_attention",
                          dev, q.data_ptr(), kc.data_ptr(), kc.data_ptr(),
                          lens.data_ptr(), out.data_ptr(), part.data_ptr(),
                          cnt.data_ptr(), n_floats, n_counters, 2, 1024, 8, 2,
                          D, scale_dim, 128, 8, 1)
            torch.cuda.synchronize()
            return True
        except RuntimeError:
            return False
    need(entry(n_part, n_cnt, 40, 36), "decode_attention: the C entry "
         "refused a scratch of the size it needs")
    for n_floats, n_counters, D, scale_dim, what in (
            (n_part - 1, n_cnt, 40, 36, "a scratch one float short"),
            (n_part, n_cnt - 1, 40, 36, "counters one short"),
            (n_part, n_cnt, 36, 36, "a head dim of 36 unpadded"),
            (n_part, n_cnt, 40, 32, "a scale dim padded by 8")):
        need(not entry(n_floats, n_counters, D, scale_dim),
             f"decode_attention: the C entry took {what}")
    print("check: decode_attention C entry refuses short scratch and "
          "unpadded head dims", flush=True)

    # one call, one launch: the splits are merged inside the kernel
    for B, Smax, lengths in ((8, 512, main_lens), (1, 32768, [32760])):
        q = torch.randn(B, 32, 128, generator=g, device=dev).to(bf16)
        kc = torch.randn(B, Smax, 8, 128, generator=g, device=dev).to(bf16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        names = device_events(torch, lambda: decode_attention(q, kc, kc, lens))
        print(f"check: decode_attention {B}x{Smax}x32/8x128 launches per call="
              f"{len(names)} ({', '.join(n[:40] for n in names)})", flush=True)
        need(len(names) == 1 and "decode_attention" in names[0],
             f"decode_attention: one call made {len(names)} device launches")

    # -- mamba2_ssd and rwkv6_scan --------------------------------------------
    # f32 rows: 2e-4 beyond 1e-2 relative (tests/test_kernels.py; the sums
    # run in another order). bf16 rows: the kernel and its plain version both
    # compute in f32 from the same bf16 inputs and round the output once, so
    # it may differ by one bf16 ulp of the plain value beyond that 2e-4. The
    # final state is f32 in both and held to the f32 criterion. No single
    # PyTorch call computes either scan: library_ms is none.
    def bf16_ulp(t):
        mag = t.abs().clamp_min(2.0 ** -126)
        return torch.exp2(torch.floor(torch.log2(mag)) - 7)

    def scan_agree(out, want, what):
        o, w = out.float(), want.float()
        slack = bf16_ulp(w) if out.dtype == bf16 else 1e-2 * w.abs()
        excess = ((o - w).abs() - slack).max().item()
        need(excess <= 2e-4, f"{what}: differs from the plain version by "
             f"{excess:.3e} beyond {'one bf16 ulp' if out.dtype == bf16 else 'rtol 1e-2'} "
             "(atol 2e-4)")
        return (o - w).abs().max().item()

    def scan_case(name, kernel, plain, args, chunk, label, nbytes, flops,
                  main, dt):
        out, state = kernel(*args, chunk=chunk)
        torch.cuda.synchronize()
        want, want_state = plain(*args, chunk=chunk)
        err = max(scan_agree(out, want, f"{name} {label}: output"),
                  scan_agree(state, want_state, f"{name} {label}: state"))
        need(bool(torch.isfinite(out.float()).all()
                  and torch.isfinite(state).all()), f"{name} {label}: not finite")
        record(name, label, err, 2e-4, lambda: kernel(*args, chunk=chunk),
               lambda: plain(*args, chunk=chunk), nbytes, flops, main, None,
               ops_of[dt])

    def ssd_case(B, T, H, P, N, chunk, dt, main, what):
        x = torch.randn(B, T, H, P, generator=g, device=dev).to(dt)
        dts = F.softplus(torch.randn(B, T, H, generator=g, device=dev))
        A = -torch.linspace(1.0, 16.0, H, device=dev)   # the model's init
        Bm = torch.randn(B, T, N, generator=g, device=dev).to(dt)
        C = torch.randn(B, T, N, generator=g, device=dev).to(dt)
        s0 = 0.1 * torch.randn(B, H, P, N, generator=g, device=dev)
        c = min(chunk, T)
        elem = x.element_size()
        nbytes = (2 * B * T * H * P + 2 * B * T * N) * elem + B * T * H * 4 \
            + H * 4 + 2 * B * H * P * N * 4
        scan_case("mamba2_ssd", mamba2_ssd, ref.mamba2_ssd_chunked,
                  (x, dts, A, Bm, C, s0), chunk,
                  f"{what} {B}x{T}x{H}x{P}x{N} chunk={c} {ops_of[dt]}", nbytes,
                  ssd_flops(B, T, H, P, N, c), main, dt)

    def rwkv_case(B, T, H, K, V, chunk, dt, main, what):
        r, k = (torch.randn(B, T, H, K, generator=g, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn(B, T, H, V, generator=g, device=dev).to(dt)
        w = -0.5 + 0.5 * torch.randn(B, T, H, K, generator=g, device=dev)
        u = (0.1 * torch.randn(H, K, generator=g, device=dev)).to(dt)
        s0 = 0.1 * torch.randn(B, H, K, V, generator=g, device=dev)
        c = min(chunk, T)
        elem = r.element_size()
        nbytes = (2 * B * T * H * K + 2 * B * T * H * V + H * K) * elem \
            + B * T * H * K * 4 + 2 * B * H * K * V * 4
        scan_case("rwkv6_scan", rwkv6_scan, ref.rwkv6_chunked,
                  (r, k, v, w, u, s0), chunk,
                  f"{what} {B}x{T}x{H}x{K}x{V} chunk={c} {ops_of[dt]}", nbytes,
                  rwkv_flops(B, T, H, K, V, c), main, dt)

    ssd_case(8, 128, 112, 64, 64, 64, bf16, True, "prefill")
    ssd_case(8, 128, 112, 64, 64, 64, f32, False, "parity prefill")
    ssd_case(8, 16, 112, 64, 64, 64, f32, False, "one chunk")
    ssd_case(2, 96, 112, 64, 64, 32, f32, False, "ragged chunks")
    ssd_case(1, 4096, 112, 64, 64, 64, bf16, False, "stress")
    rwkv_case(8, 128, 32, 64, 64, 64, bf16, True, "prefill")
    rwkv_case(8, 128, 32, 64, 64, 64, f32, False, "parity prefill")
    rwkv_case(8, 16, 32, 64, 64, 64, f32, False, "one chunk")
    rwkv_case(2, 96, 32, 64, 64, 32, f32, False, "ragged chunks")
    rwkv_case(1, 4096, 32, 64, 64, 64, bf16, False, "stress")
    return results


def ssd_flops(B, T, H, P, N, C) -> int:
    """Operations the chunked SSD needs: C.B^T once per (batch, chunk) over
    the lower triangle (B and C are shared by the heads); per (batch, head,
    chunk) the masked G, G.x, C.S^T and the state update."""
    nc, tri = T // C, C * (C + 1) // 2
    per_head = (tri * (3 + 2 * P) + C * P * (2 * N + 2) + P * N * (2 * C + 2)
                + 4 * C)
    return B * nc * (tri * 2 * N + H * per_head)


def rwkv_flops(B, T, H, K, V, C) -> int:
    """Operations the chunked WKV6 needs per (batch, head, chunk): the
    log-decay sums, the gated r.k over the strict lower triangle (exp
    counted as one operation), the bonus diagonal, the rescales, A.v, the
    carried state's term and the state update."""
    nc, tri = T // C, C * (C + 1) // 2
    strict = C * (C - 1) // 2
    per_head = (3 * C * K + 5 * strict * K + 3 * C * K + 4 * C * K
                + C * V * 2 * K + tri * 2 * V + K * V * (2 * C + 2))
    return B * H * nc * per_head


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def make_slice_workload(seed: int):
    from repro_torch.data.synthetic import make_workload
    return make_workload(num_entities=16, num_sessions=500,
                         transitions_per_entity=4, distractor_turns=20,
                         num_queries=64, seed=seed)


def run_slice(torch, wl, device, obs=None):
    from repro_torch import MemForestSystem

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    mf = MemForestSystem(device=device, obs=obs)
    t0 = time.perf_counter()
    for i in range(0, len(wl.sessions), 16):
        mf.ingest_batch(wl.sessions[i:i + 16])
    sync()
    ingest_s = time.perf_counter() - t0
    answers, query_s = {}, {}
    for mode in MODES:
        t0 = time.perf_counter()
        res = mf.query_batch(wl.queries, mode=mode)
        sync()
        query_s[mode] = time.perf_counter() - t0
        answers[mode] = [(r.answer, r.evidence) for r in res]
    return mf, answers, ingest_s, query_s


def compare_systems(a, b, answers_a, answers_b) -> str:
    """Exact facts, tree structure, placement, answers and evidence;
    embeddings within 1e-5. Returns a one-line summary."""
    fa, fb = a.forest, b.forest
    need([(f.fact_id, f.text, f.value) for f in fa.facts]
         == [(f.fact_id, f.text, f.value) for f in fb.facts], "facts differ")
    need([c.text for c in fa.cells] == [c.text for c in fb.cells],
         "cells differ")
    need(a.scale_stats() == b.scale_stats(), "scale_stats differ")
    need(list(fa.trees) == list(fb.trees), "tree sets differ")
    emb_err = 0.0
    for key, ta in fa.trees.items():
        tb = fb.trees[key]
        need(ta.children == tb.children and ta.level == tb.level
             and ta.root == tb.root, f"tree {key} differs")
        n = len(ta.level)
        emb_err = max(emb_err, float(np.abs(ta.emb[:n] - tb.emb[:n]).max()))
    need(emb_err <= 1e-5, f"node embeddings differ by {emb_err}")
    nt = len(fa._tree_order)
    root_err = float(np.abs(fa._root_matrix[:nt] - fb._root_matrix[:nt]).max())
    need(root_err <= 1e-5, f"root index differs by {root_err}")
    need(fa.placement == fb.placement, "placement differs")
    need(fa.session_registry == fb.session_registry,
         "session registry differs")
    for mode in MODES:
        need(answers_a[mode] == answers_b[mode],
             f"answers or evidence differ in mode {mode}")
    return (f"node_emb_err={emb_err:.3e} root_err={root_err:.3e} "
            f"trees={len(fa.trees)} modes={len(MODES)}")


def span_totals(sink):
    out = {}
    for rec in sink.spans():
        out[rec["name"]] = out.get(rec["name"], 0.0) + rec["dur_s"]
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: the serve engine on llama3-8b
# ---------------------------------------------------------------------------
PROMPT_TOKENS = 120       # decode prompts: the first turns of a session
DECODE_PROMPTS = 8
NEW_TOKENS = 32


def build_engine(cfg, params, device, obs=None):
    """ServeEngine on ``cfg`` whose memory is a MemForestSystem with a
    ModelEncoder on the same weights (examples/serve_memforest.py)."""
    from repro_torch import MemForestConfig, MemForestSystem
    from repro_torch.core.encoder import ModelEncoder
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    tok = HashTokenizer(cfg.vocab_size)
    memory = MemForestSystem(MemForestConfig(embed_dim=cfg.d_model),
                             ModelEncoder(cfg, params, tok, max_len=128),
                             device=device, obs=obs)
    engine = ServeEngine(get_model(cfg), params, max_batch=8, max_len=512,
                         memory=memory, max_ingest_batch=16, obs=obs)
    return engine, tok


def decode_prompts(wl, tok, n, length=PROMPT_TOKENS):
    out = []
    for s in wl.sessions[:n]:
        ids = [i for t in s.turns for i in tok.encode(t.text)]
        out.append(ids[:length])
    return out


def serve_traffic(torch, engine, prompts, sessions, queries, new_tokens):
    """Round 1: the sessions through the ingest lane beside the prompts'
    decodes. Round 2: the queries through the query lane beside the same
    prompts again (the same padded block and prefix key: a prefix hit).
    Each round runs to drained; returns (round-1 s, round-2 s, results)."""
    def run():
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for s in sessions:
        engine.submit_session(s)
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens, prefix_key="summarize")
    ingest_s = run()
    rids = [engine.submit_query(q) for q in queries]
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens, prefix_key="summarize")
    query_s = run()
    return ingest_s, query_s, [engine.pop_query_result(r) for r in rids]


def to_cpu(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def same_engines(label, ge, ce, gres, cres) -> None:
    """The card's engine ``ge`` and the CPU's ``ce`` after the same traffic:
    equal decoded tokens, facts, trees, placement and answers; a prefix
    hit."""
    tokens = lambda e: sorted((r.req_id, r.out_tokens)    # noqa: E731
                              for r in e.finished)
    need(tokens(ge) == tokens(ce), f"{label}: decoded tokens differ")
    need(len(ge.finished) == 8, f"{label}: a decode request did not finish")
    fa, fb = ge.memory.forest, ce.memory.forest
    need([(f.fact_id, f.text, f.value) for f in fa.facts]
         == [(f.fact_id, f.text, f.value) for f in fb.facts],
         f"{label}: facts differ")
    need(ge.memory.scale_stats() == ce.memory.scale_stats(),
         f"{label}: scale_stats differ")
    need(list(fa.trees) == list(fb.trees), f"{label}: tree sets differ")
    for key, ta in fa.trees.items():
        tb = fb.trees[key]
        need(ta.children == tb.children and ta.level == tb.level
             and ta.root == tb.root, f"{label}: tree {key} differs")
    need(fa.placement == fb.placement, f"{label}: placement differs")
    need([(r.answer, r.evidence) for r in gres]
         == [(r.answer, r.evidence) for r in cres], f"{label}: answers differ")
    need(ge.metrics()["prefills_reused"] >= 1, f"{label}: no prefix hit")


def profiled_repeat(torch, phase, traffic, serve_s, activities) -> None:
    """Device busy time over a profiled repeat of a phase's traffic, and
    the idle share against the unprofiled run's ``serve_s``."""
    from torch.profiler import profile
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        traffic()
    wall = time.perf_counter() - t0
    busy_s, top = device_busy(prof)
    if busy_s > 0:
        # the profiler slows the host, so the share against the unprofiled
        # run's wall time is the one the phase sees
        print(f"{phase}: profiled_wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
              f"unprofiled_wall_s={serve_s:.4f} "
              f"idle_share={1 - busy_s / serve_s:.4f} "
              f"idle_share_profiled={1 - busy_s / wall:.4f}")
        print(f"{phase}: device_ms " + "; ".join(
            f"{k[:48]}={v / 1e3:.3f}" for k, v in top))
    else:
        print(f"{phase}: profiled_wall_s={wall:.4f} device busy time not "
              "measured (the profiler saw no device activity)")


def read_counts(names):
    """{kernel: (launches, plain calls)} from the wrappers' counters."""
    from repro_torch.kernels import COUNTS
    return {k: (COUNTS[k].launches, COUNTS[k].plain_calls) for k in names}


def run_serve(torch, wl, seed):
    """Phase 5 on llama3-8b (bf16, published width and depth)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.obs import MemorySink, Observability, Tracer

    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: model={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"params={cfg.param_count():,} init_s={time.perf_counter() - t0:.2f} "
          f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)

    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))
    engine, tok = build_engine(cfg, params, "cuda", obs)
    prompts = decode_prompts(wl, tok, DECODE_PROMPTS)
    kernels.reset_counts()
    ingest_s, query_s, results = serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS)
    counts = read_counts(SERVE_KERNELS)

    m = engine.metrics()
    totals = span_totals(sink)
    mf = engine.memory
    decode_s = totals.get("engine.decode", 0.0)
    print(f"serve: sessions={len(wl.sessions)} round1_s={ingest_s:.4f} "
          f"sessions_per_s={len(wl.sessions) / ingest_s:.2f} "
          f"encoder_tokens={mf.encoder.stats.tokens} "
          f"encoder_calls={mf.encoder.stats.calls} stats={mf.scale_stats()}")
    print(f"serve: queries_served={m['queries_served']} round2_s={query_s:.4f} "
          f"decoded_tokens={m['decoded_tokens']} decode_span_s={decode_s:.4f} "
          f"decoded_tokens_per_s={m['decoded_tokens'] / decode_s:.1f} "
          f"(decode spans) "
          f"{m['decoded_tokens'] / (ingest_s + query_s):.1f} (wall)")
    print("serve: metrics " + json.dumps(m, sort_keys=True))
    print("serve: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    print("serve: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(n > 0, f"{k} never launched on the serve path")
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")
    need(m["prefills_reused"] >= 1, "the prefix cache was never reused")
    need(len(results) == len(wl.queries)
         and all(r is not None for r in results), "a query went unanswered")
    gold = sum(r.answer.strip().lower() == q.gold.strip().lower()
               for r, q in zip(results, wl.queries))
    print(f"serve: answers={len(results)} non_empty="
          f"{sum(bool(r.answer) for r in results)} equal_to_gold={gold} "
          "(random weights: not a measure of quality)")
    need(m["decoded_tokens"] > 0, "no tokens decoded")
    texts = [t.text for s in wl.sessions[:8] for t in s.turns]
    e1, e2 = mf.encoder.encode(texts), mf.encoder.encode(texts)
    need(e1.shape == (len(texts), cfg.d_model) and bool(np.isfinite(e1).all()),
         "encoder output has the wrong shape or is not finite")
    need(e1.tobytes() == e2.tobytes(), "two encodes of one batch differ")
    print(f"serve: encoder repeatable, {len(texts)} texts bitwise equal")
    del engine, mf

    # device busy time over a profiled repeat of the same traffic
    from torch.profiler import ProfilerActivity
    engine, _ = build_engine(cfg, params, "cuda")
    profiled_repeat(torch, "serve", lambda: serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS),
        ingest_s + query_s, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    del engine, params
    torch.cuda.empty_cache()
    return counts


def run_parity(torch, seed):
    """Phase 6: the engine at llama3-8b's width, depth 2, float32, on the
    card and on the CPU with the same weights and traffic."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import transformer as T

    cfg = get_config("llama3_8b").replace(num_layers=2, dtype="float32",
                                          param_dtype="float32")
    wl = make_workload(num_entities=4, num_sessions=4,
                       transitions_per_entity=3, num_queries=8, seed=seed)
    gpu_params = T.init_params(cfg, seed, device="cuda")
    cpu_params = to_cpu(gpu_params)
    runs = {}
    for device, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        engine, tok = build_engine(cfg, params, device)
        prompts = decode_prompts(wl, tok, 4)
        t0 = time.perf_counter()
        _, _, results = serve_traffic(torch, engine, prompts, wl.sessions,
                                      wl.queries, 8)
        texts = [t.text for s in wl.sessions[:2] for t in s.turns]
        runs[device] = (engine, results, engine.memory.encoder.encode(texts),
                        time.perf_counter() - t0)
    (ge, gres, gemb, gs), (ce, cres, cemb, cs) = runs["cuda"], runs["cpu"]
    emb_err = float(np.abs(gemb - cemb).max())
    # float32 on both sides, TF32 off; the sums run in another order
    need(emb_err <= 1e-4, f"parity: encoder embeddings differ by {emb_err}")
    same_engines("parity", ge, ce, gres, cres)
    fa = ge.memory.forest
    print(f"parity: llama3-8b width, {cfg.num_layers} layers, float32: "
          f"sessions={len(wl.sessions)} queries={len(gres)} "
          f"decoded_tokens={ge.metrics()['decoded_tokens']} tokens equal, "
          f"facts={len(fa.facts)} trees={len(fa.trees)} answers equal, "
          f"embedding max_abs_err={emb_err:.3e} (tol 1e-4) "
          f"card_s={gs:.3f} cpu_s={cs:.3f}", flush=True)
    del runs, ge, ce, gpu_params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7-9: the serve engine on zamba2 and rwkv6
# ---------------------------------------------------------------------------
SSM_PROMPT_TOKENS = 128   # a multiple of the scans' 64-token chunk
SSM_ARCHS = {"zamba2": ("zamba2_7b", "mamba2_ssd"),
             "rwkv6": ("rwkv6_1b6", "rwkv6_scan")}


def build_hashing_engine(cfg, params, device, obs=None):
    """ServeEngine on ``cfg`` whose memory is a MemForestSystem with the
    hashing encoder at the paper's defaults (``launch/serve.py --encoder
    hashing``): neither family has the dense trunk a ModelEncoder needs."""
    from repro_torch import MemForestSystem
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    memory = MemForestSystem(device=device, obs=obs)
    engine = ServeEngine(get_model(cfg), params, max_batch=8, max_len=512,
                         memory=memory, max_ingest_batch=16, obs=obs)
    return engine, HashTokenizer(cfg.vocab_size)


def ssm_prompts(wl, tok, n):
    prompts = decode_prompts(wl, tok, n, SSM_PROMPT_TOKENS)
    need(all(len(p) == SSM_PROMPT_TOKENS for p in prompts),
         f"a session has fewer than {SSM_PROMPT_TOKENS} tokens")
    return prompts


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return tree.numel()


def run_ssm_serve(torch, wl, seed, phase):
    """Phase 7 (zamba2-7b) or 8 (rwkv6-1.6b): bf16, published width and
    depth, the engine traffic of phase 5 with 128-token prompts."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.obs import MemorySink, Observability, Tracer

    arch, scan = SSM_ARCHS[phase]
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_model(cfg).init(seed, device="cuda")
    torch.cuda.synchronize()
    print(f"{phase}: model={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} attn_every={cfg.attn_every} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"params={param_count(params):,} "
          f"init_s={time.perf_counter() - t0:.2f} "
          f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)

    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))
    engine, tok = build_hashing_engine(cfg, params, "cuda", obs)
    prompts = ssm_prompts(wl, tok, DECODE_PROMPTS)
    kernels.reset_counts()
    ingest_s, query_s, results = serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS)
    counts = read_counts(REPLACES)

    m = engine.metrics()
    totals = span_totals(sink)
    decode_s = totals.get("engine.decode", 0.0)
    steps = m["decode_steps"]
    print(f"{phase}: sessions={len(wl.sessions)} round1_s={ingest_s:.4f} "
          f"sessions_per_s={len(wl.sessions) / ingest_s:.2f} "
          f"queries_served={m['queries_served']} round2_s={query_s:.4f} "
          f"stats={engine.memory.scale_stats()}")
    print(f"{phase}: decode_steps={steps} decoded_tokens={m['decoded_tokens']} "
          f"decode_span_s={decode_s:.4f} "
          f"decoded_tokens_per_s={m['decoded_tokens'] / decode_s:.1f} "
          f"(decode spans) "
          f"{m['decoded_tokens'] / (ingest_s + query_s):.1f} (wall) "
          f"peak_device_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    print(f"{phase}: metrics " + json.dumps(m, sort_keys=True))
    print(f"{phase}: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    print(f"{phase}: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")
    for k in SLICE_KERNELS:
        need(counts[k][0] > 0, f"{k} never launched on the {phase} path")
    need(counts[scan][0] >= cfg.num_layers, f"{scan} launched "
         f"{counts[scan][0]} times, fewer than the {cfg.num_layers} layers "
         "of one prefill")
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        need(counts["flash_attention"][0] >= groups, "flash_attention "
             f"launched {counts['flash_attention'][0]} times, fewer than the "
             f"{groups} applications of the shared block")
        need(counts["decode_attention"][0] >= groups * steps,
             f"decode_attention launched {counts['decode_attention'][0]} "
             f"times, fewer than {groups} x {steps} decode steps")
    need(m["prefills_reused"] >= 1, "the prefix cache was never reused")
    need(len(engine.finished) == 2 * DECODE_PROMPTS and m["decoded_tokens"] > 0,
         "a decode request did not finish")
    need(len(results) == len(wl.queries)
         and all(r is not None for r in results), "a query went unanswered")
    need(bool(torch.isfinite(engine._last_logits.float()).all()),
         "the last logits are not finite")
    state = engine.cache["ssd" if cfg.family == "hybrid" else "wkv"]
    need(bool(torch.isfinite(state).all()), "the recurrent state is not "
         "finite")
    del engine

    # device busy time over a profiled repeat of the same traffic; device
    # activity only: the host ops of 64 decode steps of 81 layers make a
    # trace whose summary takes minutes, and the busy time needs none of them
    from torch.profiler import ProfilerActivity
    engine, _ = build_hashing_engine(cfg, params, "cuda")
    profiled_repeat(torch, phase, lambda: serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS),
        ingest_s + query_s, [ProfilerActivity.CUDA])
    del engine, params
    torch.cuda.empty_cache()
    return counts


def run_ssm_parity(torch, seed):
    """Phase 9: zamba2 at full width and 7 layers, rwkv6 at full width and
    2 layers, float32, on the card and on the CPU with the same weights and
    traffic."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import get_model

    wl = make_workload(num_entities=4, num_sessions=4,
                       transitions_per_entity=3, num_queries=8, seed=seed)
    for phase, layers in (("zamba2", 7), ("rwkv6", 2)):
        arch, _ = SSM_ARCHS[phase]
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32",
                                       param_dtype="float32")
        gpu_params = get_model(cfg).init(seed, device="cuda")
        cpu_params = to_cpu(gpu_params)
        runs = {}
        for device, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            engine, tok = build_hashing_engine(cfg, params, device)
            t0 = time.perf_counter()
            _, _, results = serve_traffic(torch, engine,
                                          ssm_prompts(wl, tok, 4),
                                          wl.sessions, wl.queries, 8)
            runs[device] = (engine, results, time.perf_counter() - t0)
        (ge, gres, gs), (ce, cres, cs) = runs["cuda"], runs["cpu"]
        same_engines(f"ssm_parity {phase}", ge, ce, gres, cres)
        fa = ge.memory.forest
        key = "ssd" if cfg.family == "hybrid" else "wkv"
        # float32 on both sides, TF32 off; the sums run in another order
        state_err = float((ge.cache[key].cpu() - ce.cache[key]).abs().max())
        need(state_err <= 1e-4, f"ssm_parity {phase}: final {key} state "
             f"differs by {state_err}")
        print(f"ssm_parity: {cfg.name} width, {cfg.num_layers} layers, "
              f"float32: sessions={len(wl.sessions)} queries={len(gres)} "
              f"decoded_tokens={ge.metrics()['decoded_tokens']} tokens equal, "
              f"facts={len(fa.facts)} trees={len(fa.trees)} answers equal, "
              f"{key} state max_abs_err={state_err:.3e} (tol 1e-4) "
              f"card_s={gs:.3f} cpu_s={cs:.3f}", flush=True)
        del runs, ge, ce, gpu_params, cpu_params
        torch.cuda.empty_cache()


def device_busy(prof):
    """(device busy seconds, the eight largest device items in us)."""
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                    # host ops: their kernels count below
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()) / 1e6, top


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    started = time.perf_counter()

    def stamp(phase):
        print(f"time: {phase} done at {time.perf_counter() - started:.1f} s",
              flush=True)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    peaks = peaks_for(name)
    print(smi_line)
    print(f"device: {name} capability={cap[0]}.{cap[1]} torch={torch.__version__}"
          f" cuda={torch.version.cuda} peaks: {peaks['bytes'] / 1e12:.2f} TB/s, "
          f"{peaks['fp32'] / 1e12:.0f} TFLOP/s fp32, "
          f"{peaks['bf16'] / 1e12:.0f} TFLOP/s bf16 (tensor cores, dense)",
          flush=True)
    need(cap == (9, 0), f"compute capability {cap}, need 9.0 (sm_90a)")

    # 2. build --------------------------------------------------------------
    lib = _build.library()
    regs = [ln.strip() for ln in lib.ptxas.splitlines() if "registers" in ln]
    print(f"build: {' '.join(p.name for p in lib.paths)} "
          f"nvcc_s={lib.build_s:.2f}", flush=True)
    for ln in regs:
        print(f"build: {ln}")

    stamp("build")

    # 3. kernel checks ------------------------------------------------------
    results = check_kernels(torch, peaks, args.seed)
    stamp("check")

    # 4. the main path ------------------------------------------------------
    from repro_torch.obs import MemorySink, Observability, Tracer
    t0 = time.perf_counter()
    wl = make_slice_workload(args.seed)
    gen_s = time.perf_counter() - t0
    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))

    kernels.reset_counts()
    mf, answers, ingest_s, query_s = run_slice(torch, wl, "cuda", obs)
    counts = read_counts(SLICE_KERNELS)

    turns = sum(len(s.turns) for s in wl.sessions)
    print(f"slice: sessions={len(wl.sessions)} turns={turns} "
          f"queries={len(wl.queries)} gen_s={gen_s:.3f} "
          f"stats={mf.scale_stats()} device_bytes={mf.device_bytes()}")
    print(f"slice: ingest_s={ingest_s:.4f} "
          f"sessions_per_s={len(wl.sessions) / ingest_s:.1f}")
    print("slice: queries_per_s " + " ".join(
        f"{m}={len(wl.queries) / s:.1f}" for m, s in query_s.items()))
    totals = span_totals(sink)
    print("slice: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    print("slice: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(n > 0, f"{k} never launched on the main path")
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")

    texts = [t.text for s in wl.sessions[:16] for t in s.turns]
    e1 = mf.encoder.encode(texts)
    e2 = mf.encoder.encode(texts)
    need(e1.tobytes() == e2.tobytes(), "two encodes of one batch differ")
    print(f"slice: encoder repeatable, {len(texts)} texts bitwise equal")

    from torch.profiler import ProfilerActivity
    profiled_repeat(torch, "slice",
                    lambda: (run_slice(torch, wl, "cuda"),
                             torch.cuda.synchronize()),
                    ingest_s + sum(query_s.values()),
                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])

    cpu_mf, cpu_answers, cpu_ingest_s, cpu_query_s = run_slice(torch, wl, "cpu")
    print(f"slice: cpu rerun ingest_s={cpu_ingest_s:.4f} matches: "
          + compare_systems(mf, cpu_mf, answers, cpu_answers), flush=True)
    del mf, cpu_mf
    stamp("slice")

    # 5. the serve engine on llama3-8b ---------------------------------------
    serve_counts = run_serve(torch, wl, args.seed)
    stamp("serve")

    # 6. the same engine on the card and on the CPU --------------------------
    run_parity(torch, args.seed)
    stamp("parity")

    # 7-8. the serve engine on zamba2-7b and rwkv6-1.6b ----------------------
    ssm_counts = {}
    for phase in SSM_ARCHS:
        ssm_counts[phase] = run_ssm_serve(torch, wl, args.seed, phase)
        stamp(phase)

    # 9. both on the card and on the CPU --------------------------------------
    run_ssm_parity(torch, args.seed)
    stamp("ssm_parity")

    # 10. kernels -----------------------------------------------------------
    summary = []
    for k in REPLACES:
        r = results[k]
        by_path = {"slice": counts[k][0] if k in counts else 0,
                   "serve": serve_counts[k][0] if k in serve_counts else 0,
                   **{phase: c[k][0] for phase, c in ssm_counts.items()}}
        print(f"kernels: {k} launches={sum(by_path.values())} ("
              + ", ".join(f"{p} {n}" for p, n in by_path.items())
              + f") check=ok main_shape={r['shape']}")
        summary.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "peak": r["peak"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "other_main_rows": r["other_main_rows"],
        })
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
