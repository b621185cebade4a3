"""Lifecycle maintenance demo: migration merge vs sequential write, plus
targeted deletion (paper §5.6, Figure 5).

    PYTHONPATH=src python -m repro_torch.examples.migration_merge [--device cpu]

Counterpart of the repository's ``examples/migration_merge.py``, on the CUDA
card by default.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.config import MemForestConfig
from repro_torch.core.memforest import MemForestSystem
from repro_torch.data.synthetic import make_workload


def build(sessions, device):
    mf = MemForestSystem(MemForestConfig(), device=device)
    for s in sessions:
        mf.ingest_session(s)
    return mf


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    # two independently-built memory instances (e.g. two assistants' stores)
    wa = make_workload(num_entities=3, num_sessions=5, num_queries=1, seed=11)
    wb = make_workload(num_entities=3, num_sessions=5, num_queries=1, seed=22)

    print("building instance A and B independently ...")
    a = build(wa.sessions, dev)
    b = build(wb.sessions, dev)
    print("A:", a.scale_stats())
    print("B:", b.scale_stats())

    # migration merge: NO raw-session replay
    t0 = time.perf_counter()
    stats = a.merge_from(b)
    t_merge = time.perf_counter() - t0
    print(f"\nmigration merge in {t_merge*1e3:.0f}ms: {stats}")
    print("merged:", a.scale_stats())

    # sequential-write reference
    t0 = time.perf_counter()
    seq = build(wa.sessions + wb.sessions, dev)
    t_seq = time.perf_counter() - t0
    print(f"sequential rebuild in {t_seq*1e3:.0f}ms "
          f"-> migration speedup {t_seq/t_merge:.1f}x")
    print("sequential:", seq.scale_stats())

    # targeted deletion: only affected paths refresh
    sid = wa.sessions[0].session_id
    before = a.forest.summary_refreshes
    d = a.delete_session(sid)
    print(f"\ndeleted session {sid}: {d} "
          f"({a.forest.summary_refreshes - before} summary refreshes)")
    print("after delete:", a.scale_stats())


if __name__ == "__main__":
    main()
