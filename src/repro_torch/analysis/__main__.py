"""memlint CLI of the port: ``python -m repro_torch.analysis src/repro_torch
[--strict]``.

Exit status: 0 when every finding is inline-suppressed or baselined;
1 under ``--strict`` when actionable findings (or a syntax error) remain.
Without ``--strict`` the sweep is report-only (exit 0), which is the
local-iteration mode; CI runs ``--strict`` with the committed (empty)
baseline, so any new unsuppressed finding fails the build. The baseline is
the port's own, ``memlint_torch_baseline.json`` at the repo root; the JAX
package's ``memlint_baseline.json`` is never read.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis import core
from repro_torch.analysis import rules as _rules  # noqa: F401  (registers rules)

DEFAULT_BASELINE = "memlint_torch_baseline.json"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="memlint: the port's serve-stack invariant checker")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to sweep (default: "
                         "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on unsuppressed, un-baselined findings")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON path (default: <repo root>/"
                         f"{DEFAULT_BASELINE} when it exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in sorted(core.RULES.values(), key=lambda r: r.id):
            print(f"{r.id:20s} {r.doc}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    repo_root = core.find_repo_root(paths[0])
    baseline_path = args.baseline
    if baseline_path is None:
        cand = os.path.join(repo_root, DEFAULT_BASELINE)
        baseline_path = cand if os.path.exists(cand) else None

    rule_ids = [s.strip() for s in args.rules.split(",")] if args.rules else None
    res = core.run_paths(paths, rules=rule_ids, repo_root=repo_root,
                         baseline=core.load_baseline(baseline_path))

    if args.write_baseline:
        out = baseline_path or os.path.join(repo_root, DEFAULT_BASELINE)
        core.write_baseline(out, res.findings)
        print(f"memlint: wrote {len(res.findings)} finding(s) to {out}")
        return 0

    if args.json:
        print(json.dumps({
            "findings": [f.__dict__ for f in res.findings],
            "suppressed": len(res.suppressed),
            "baselined": len(res.baselined),
            "stale_baseline": res.stale_baseline,
            "files_swept": res.files_swept,
        }, indent=2))
    else:
        for f in res.findings:
            print(f.render())
        for key in res.stale_baseline:
            print(f"stale baseline entry (no longer fires): {key}")
        print(f"memlint: {res.files_swept} files, "
              f"{len(res.findings)} finding(s), "
              f"{len(res.suppressed)} suppressed, "
              f"{len(res.baselined)} baselined")

    if args.strict and res.findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
