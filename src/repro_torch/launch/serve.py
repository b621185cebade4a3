"""MemForest serving entry point: the paper's serve-and-update lifecycle
against a live model backbone, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --sessions 8 --queries 20 [--device cpu]

Counterpart of the JAX package's ``launch/serve.py``, with the same flags,
the same printed lines, and ``--device`` (default: the CUDA card; ``cpu``
runs the plain versions of the kernels). Runs: (1) session ingestion
through the parallel write path (batched chunk extraction on the backbone
encoder), (2) query serving (forest recall + tree browse + answer), (3)
reports the write/read latency split that paper Tables 2-3 measure.

The backbone's weights come from the port's seeded init, drawn on the CPU
and then moved to ``--device``, so a run on the card and one on the CPU
serve the same weights.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.config import MemForestConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.encoder import HashingEncoder, ModelEncoder
from repro_torch.core.memforest import MemForestSystem
from repro_torch.data.synthetic import make_workload
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.tree import map_tree


def main(argv=None, *, params=None) -> None:
    """``params``: the backbone's weights as a port parameter tree on any
    device (``repro_torch.convert`` carries the JAX package's over); None
    draws them from the seeded init."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--encoder", default="model", choices=["model", "hashing"])
    ap.add_argument("--mode", default="llm+planner")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    wl = make_workload(num_entities=6, num_sessions=args.sessions,
                       transitions_per_entity=3, num_queries=args.queries,
                       seed=args.seed)

    if args.encoder == "model":
        cfg = get_smoke_config(args.arch).replace(d_model=128, num_heads=4,
                                                  num_kv_heads=4, head_dim=32)
        model = get_model(cfg)
        if params is None:
            params = model.init(0, device="cpu")
        params = map_tree(lambda t: t.to(dev), params)
        encoder = ModelEncoder(cfg, params, HashTokenizer(cfg.vocab_size))
        mf_cfg = MemForestConfig(embed_dim=cfg.d_model, browse_mode=args.mode)
        print(f"backbone: {cfg.name} ({cfg.param_count():,} params)")
    else:
        mf_cfg = MemForestConfig(browse_mode=args.mode)
        encoder = HashingEncoder(dim=mf_cfg.embed_dim, device=dev)

    mf = MemForestSystem(mf_cfg, encoder, device=dev)

    t0 = time.perf_counter()
    for s in wl.sessions:
        st = mf.ingest_session(s)
        print(f"ingest {s.session_id}: {st.wall_s*1e3:6.1f}ms "
              f"facts+{st.facts_written} depth={st.llm_dependency_depth}")
    build_s = time.perf_counter() - t0
    print(f"\nwrite path: {build_s:.2f}s total, "
          f"{mf.write_stats.encoder_tokens:,} tokens, "
          f"{mf.write_stats.encoder_calls} model calls")
    print("memory scale:", mf.scale_stats())

    correct = 0
    ret_s = ans_s = 0.0
    for q in wl.queries:
        r = mf.query(q)
        ok = r.answer.strip().lower() == q.gold.strip().lower()
        correct += int(ok)
        ret_s += r.retrieval_s
        ans_s += r.answer_s
        mark = "+" if ok else "-"
        print(f" [{mark}] {q.text}  ->  {r.answer!r} (gold {q.gold!r})")
    n = len(wl.queries)
    print(f"\naccuracy {correct}/{n} = {correct/n:.1%}  "
          f"retrieval {ret_s/n*1e3:.1f}ms/q  answer {ans_s/n*1e3:.1f}ms/q")


if __name__ == "__main__":
    main()
