"""Quickstart: build agent memory from a conversation stream, then query it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of the repository's ``examples/quickstart.py``, on the CUDA card
by default.
"""
from __future__ import annotations

import argparse

from repro_torch.config import MemForestConfig
from repro_torch.core.memforest import MemForestSystem
from repro_torch.core.types import Query, Session, Turn

# --- the paper's running example (§2.3.3) -----------------------------------
SESSIONS = [
    Session("s1", [
        Turn("user", "Bob lives in Boston as of January 2023.", 36.0, 0),
        Turn("assistant", "Noted, thanks for sharing.", 36.0, 1),
        Turn("user", "Bob moved from Boston to Davis in May 2023.", 40.0, 2),
        Turn("assistant", "Got it.", 40.0, 3),
    ]),
    Session("s2", [
        Turn("user", "The weather has been quite nice lately.", 50.0, 0),
        Turn("assistant", "Indeed it has.", 50.0, 1),
        Turn("user", "Bob moved from Davis to Miami in July 2024.", 54.0, 2),
        Turn("assistant", "Understood.", 54.0, 3),
    ]),
    Session("s3", [
        Turn("user", "Bob's favorite thing is green tea as of August 2024.", 56.0, 0),
        Turn("assistant", "Noted.", 56.0, 1),
    ]),
]

QUERIES = [
    Query("Where does Bob live now?", "current", "Bob", "residence"),
    Query("Where did Bob live before moving to Miami?", "historical",
          "Bob", "residence", anchor_value="Miami"),
    Query("When did Bob move to Miami?", "transition_time",
          "Bob", "residence", anchor_value="Miami"),
    Query("What was the first place Bob lived in?", "multi_session",
          "Bob", "residence"),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    mf = MemForestSystem(MemForestConfig(), device=args.device)
    for s in SESSIONS:
        stats = mf.ingest_session(s)
        print(f"ingested {s.session_id}: +{stats.facts_written} facts, "
              f"dependency depth {stats.llm_dependency_depth}")

    print("\nmemory state:", mf.scale_stats())
    print()
    for q in QUERIES:
        r = mf.query(q)
        print(f"Q: {q.text}\nA: {r.answer}   (evidence: {r.evidence[0][:60]}...)\n")


if __name__ == "__main__":
    main()
