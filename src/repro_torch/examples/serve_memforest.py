"""End to end: serve a small model with batched requests as the backbone
that builds and answers MemForest's memory (the paper's deployment shape).

A real LM from the zoo (reduced llama3 config) handles:
  * chunk-embedding for extraction (batched forward = parallel write path),
  * query/summary embeddings for retrieval,
while the serving engine demonstrates continuous batching on the same model.

    PYTHONPATH=src python -m repro_torch.examples.serve_memforest [--device cpu]

Counterpart of the repository's ``examples/serve_memforest.py``, on the CUDA
card by default.
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.config import MemForestConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.encoder import ModelEncoder
from repro_torch.core.memforest import MemForestSystem
from repro_torch.core.residency import ResidencyConfig, ResidencyManager
from repro_torch.data.synthetic import make_workload
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- backbone: a real (reduced) zoo model -------------------------------
    cfg = get_smoke_config("llama3_8b").replace(d_model=128, num_heads=4,
                                                num_kv_heads=4, head_dim=32,
                                                num_layers=2)
    model = get_model(cfg)
    params = model.init(0, device=dev)
    print(f"backbone: {cfg.name} ({cfg.param_count():,} params)")

    tok = HashTokenizer(cfg.vocab_size)
    encoder = ModelEncoder(cfg, params, tok, max_len=64)

    # --- build memory over a synthetic long-horizon workload ----------------
    wl = make_workload(num_entities=4, num_sessions=6, transitions_per_entity=3,
                       num_queries=12, seed=0)
    mf = MemForestSystem(MemForestConfig(embed_dim=cfg.d_model), encoder,
                         device=dev)

    t0 = time.perf_counter()
    for s in wl.sessions:
        mf.ingest_session(s)
    print(f"write path: {time.perf_counter()-t0:.2f}s for {len(wl.sessions)} sessions "
          f"({encoder.stats.calls} batched model calls)")
    print("memory:", mf.scale_stats())

    # batched read path: one encoder forward + fused index scans + one browse
    # launch per tree level for ALL queries (device-resident normalized indexes)
    t0 = time.perf_counter()
    results = mf.query_batch(wl.queries)
    dt = time.perf_counter() - t0
    correct = sum(int(r.answer.strip().lower() == q.gold.strip().lower())
                  for r, q in zip(results, wl.queries))
    print(f"read path: {dt:.2f}s for {len(wl.queries)} queries (batched) | "
          f"answer accuracy: {correct}/{len(wl.queries)}")

    # --- batched request serving on the same backbone ------------------------
    print("\nserving engine (continuous batching, decode + query lanes):")
    eng = ServeEngine(model, params, max_batch=4, max_len=64, memory=mf)
    for i in range(8):
        eng.submit(tok.encode(f"summarize interval {i} of the bob residence scope"),
                   max_new_tokens=4, prefix_key="summarize")
    rids = [eng.submit_query(q) for q in wl.queries]   # retrieval rides the loop
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    print(f"served {len(done)} decode requests + {m['queries_served']:.0f} queries "
          f"in {dt:.2f}s | occupancy {m['mean_occupancy']:.0%} | "
          f"{m['decoded_tokens']} tokens | query batches {m['query_batches']:.0f}")
    assert all(eng.pop_query_result(r).answer == res.answer
               for r, res in zip(rids, results))

    # --- multi-tenant over-subscription through the residency tier -----------
    # Six tenants on a hot budget of two: the engine routes tenant-tagged
    # sessions/queries through the ResidencyManager — cold tenants rehydrate
    # inside the drains (or answer from their always-resident digest), and
    # traffic-aware LRU demotion runs on the residency lane after each decode
    # step, never on it.
    print("\nresidency tier (6 tenants, hot budget 2, transparent rehydration):")
    mgr = ResidencyManager(tempfile.mkdtemp(prefix="memforest_tenants_"),
                           config=ResidencyConfig(hot_budget=2),
                           mem_config=MemForestConfig(), device=dev)
    teng = ServeEngine(model, params, max_batch=4, max_len=64, residency=mgr)
    tenant_wls = {f"tenant{i}": make_workload(num_entities=2, num_sessions=3,
                                              transitions_per_entity=3,
                                              num_queries=6, seed=100 + i)
                  for i in range(6)}
    for tid, twl in tenant_wls.items():
        for s in twl.sessions:
            teng.submit_session(s, tenant=tid)
    for i in range(4):                              # decode traffic rides along
        teng.submit(tok.encode(f"tenant status {i}"), max_new_tokens=3)
    trids = {tid: [teng.submit_query(q, tenant=tid) for q in twl.queries]
             for tid, twl in tenant_wls.items()}
    t0 = time.perf_counter()
    teng.run_until_drained()
    dt = time.perf_counter() - t0
    served = sum(int(teng.pop_query_result(r) is not None)
                 for rs in trids.values() for r in rs)
    m = teng.metrics()
    print(f"served {served} tenant queries across {m['tenants']} tenants "
          f"in {dt:.2f}s | hot {m['hot_tenants']}/{m['hot_budget']} | "
          f"evictions {m['evictions']} | rehydrations {m['rehydrations']} | "
          f"digest answers {m['digest_answers']} | "
          f"device bytes {m['device_bytes_est']:,} "
          f"(digests {m['digest_bytes']:,})")
    assert m["hot_tenants"] <= 2
    mgr.close()


if __name__ == "__main__":
    main()
