#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own line; any failed check exits nonzero:

  1. device   the card's name and power limit (nvidia-smi); compute
              capability 9.0 is required.
  2. build    nvcc builds the kernels from src/repro_torch/kernels/csrc.
  3. check    every kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it and at stress shapes, with the
              kernel's, the plain version's and the bound's time in ms.
  4. slice    the main path through ``repro_torch.MemForestSystem``:
              ``ingest_batch`` of 500 sessions (about 20k turns, 13k tree
              nodes) in batches of 16, then ``query_batch`` of 64 queries in
              each of the six browse modes. Launch counts are reset just before
              and read just after; every kernel must have launched and no plain
              version may have run. The same run on the CPU must give the same
              facts, trees, answers and evidence, and embeddings within 1e-5.
  5. kernels  one line per kernel, and the JSON summary of all of them.

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
# memory rate (bytes/s) and non-tensor fp32 rate (FLOP/s) of the H100 SXM,
# from NVIDIA's data sheet; the bounds are computed for this card only
H100_SXM_PEAKS = (3.35e12, 67e12)
REPLACES = {
    "tree_refresh": "src/repro/kernels/tree_refresh.py:54",
    "topk_sim": "src/repro/kernels/topk_sim.py:149",
    "browse_scores": "src/repro/kernels/browse_scores.py:51",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}


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


def peaks_for(name: str):
    need("H100" in name and not any(v in name for v in ("PCIe", "NVL")),
         f"no peak figures for {name!r}: the bounds hold for the H100 SXM")
    return H100_SXM_PEAKS


def bound_ms(nbytes: float, flops: float, peaks):
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(torch, peaks, seed: int):
    from repro_torch.kernels import ref
    from repro_torch.kernels.browse_scores import browse_scores
    from repro_torch.kernels.topk_sim import topk_sim
    from repro_torch.kernels.tree_refresh import tree_refresh

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    def record(name, label, err, tol, fn, plain, nbytes, flops, main,
               library=None):
        ms = device_ms(torch, fn)
        plain_ms = device_ms(torch, plain)
        lib_ms = device_ms(torch, library) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, peaks)
        lib_txt = f"{lib_ms:.5f}" if lib_ms is not None else "none"
        print(f"check: {name} {label} max_abs_err={err:.3e} (tol {tol:.0e}) "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_txt} "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        if main:
            results[name] = {"shape": label, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms}

    # -- tree_refresh -------------------------------------------------------
    for (P, K, D), main in (((128, 8, 256), True), ((4096, 16, 256), False)):
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
    for (F, K, D), main in (((1024, 8, 256), True), ((4096, 16, 256), False)):
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
    topk_case(64, 256, 256, 16, 5)                       # num_valid < k
    topk_case(8, 1000, 256, 7, 1000, normalize=True)
    big = 262144
    topk_case(64, big, 256, 16, big - 1, plant=True)
    topk_case(1, big, 256, 32, big - 1, plant=True)
    topk_case(200, big, 256, 32, big - 1, plant=True)
    return results


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


def profile_slice(torch, wl):
    """Device busy time over one more slice run, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_slice(torch, wl, "cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                    # host ops: their kernels count below
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    return wall, by_name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
          f" cuda={torch.version.cuda} peaks: {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s fp32", flush=True)
    need(cap == (9, 0), f"compute capability {cap}, need 9.0 (sm_90a)")

    # 2. build --------------------------------------------------------------
    lib = _build.library()
    regs = [ln.strip() for ln in lib.ptxas.splitlines() if "registers" in ln]
    print(f"build: {' '.join(p.name for p in lib.paths)} "
          f"nvcc_s={lib.build_s:.2f}", flush=True)
    for ln in regs:
        print(f"build: {ln}")

    # 3. kernel checks ------------------------------------------------------
    results = check_kernels(torch, peaks, args.seed)

    # 4. the main path ------------------------------------------------------
    from repro_torch.obs import MemorySink, Observability, Tracer
    t0 = time.perf_counter()
    wl = make_slice_workload(args.seed)
    gen_s = time.perf_counter() - t0
    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))

    kernels.reset_counts()
    mf, answers, ingest_s, query_s = run_slice(torch, wl, "cuda", obs)
    counts = {k: (c.launches, c.plain_calls) for k, c in kernels.COUNTS.items()}

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

    wall, dev_us = profile_slice(torch, wl)
    busy_s = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    slice_s = ingest_s + sum(query_s.values())
    if busy_s > 0:
        # the profiler slows the host, so the share against the unprofiled
        # run's wall time is the one the main path sees
        print(f"slice: profiled_wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
              f"unprofiled_wall_s={slice_s:.4f} "
              f"idle_share={1 - busy_s / slice_s:.4f} "
              f"idle_share_profiled={1 - busy_s / wall:.4f}")
        print("slice: device_ms " + "; ".join(
            f"{k[:48]}={v / 1e3:.3f}" for k, v in top))
    else:
        print(f"slice: profiled_wall_s={wall:.4f} device busy time not "
              "measured (the profiler saw no device activity)")

    cpu_mf, cpu_answers, cpu_ingest_s, cpu_query_s = run_slice(torch, wl, "cpu")
    print(f"slice: cpu rerun ingest_s={cpu_ingest_s:.4f} matches: "
          + compare_systems(mf, cpu_mf, answers, cpu_answers), flush=True)

    # 5. kernels ------------------------------------------------------------
    summary = []
    for k in REPLACES:
        r = results[k]
        print(f"kernels: {k} launches={counts[k][0]} check=ok "
              f"main_shape={r['shape']}")
        summary.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": counts[k][0],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
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
