"""The port's dry run over every (arch x shape) cell of a production mesh,
one process a cell, several at once, then ``report``'s table.

    python3 tools/dryrun_sweep.py --mesh single --jobs 8 --out chiprun_out/dryrun_single

Each cell is ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M`` on fake cuda positions (the card's host: a CPU-only build cannot
index a fake cuda tensor); the lockstep of one cell runs in one process,
so cells run side by side, the longest first. A
cell still running at ``--budget`` seconds is stopped and listed as left.
Prints each cell's line as it ends, the sweep's wall seconds and the table.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import (SHAPE_ORDER, SHAPES,  # noqa: E402
                                        shape_applicable)
from repro_torch.launch import report  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", required=True)
    ap.add_argument("--budget", type=float, default=3000.0)
    ap.add_argument("--arch", nargs="*", default=ARCHS)
    args = ap.parse_args()
    args.out = os.path.abspath(args.out)     # the cells run from ROOT

    # the longest first: train cells, then long_500k (zamba2's runs whole),
    # then the rest; the skipped cells last, each writing its JSON with the
    # reference's reason
    order = ["train_4k", "long_500k"] + [s for s in SHAPE_ORDER
                                         if s not in ("train_4k", "long_500k")]
    cells = sorted(((a, s) for s in order for a in args.arch),
                   key=lambda c: not shape_applicable(get_config(c[0]),
                                                      SHAPES[c[1]])[0])
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    todo, running, left = list(cells), {}, []
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape = todo.pop(0)
            log = open(Path(args.out) / f"{arch}__{shape}.log", "w")
            running[(arch, shape)] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", args.mesh, "--out",
                 args.out], stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT), log)
        time.sleep(1.0)
        over = time.perf_counter() - t0 > args.budget
        for cell, (proc, log) in list(running.items()):
            if proc.poll() is None and not over:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                left.append(cell)
            log.close()
            del running[cell]
            text = (Path(args.out) / f"{cell[0]}__{cell[1]}.log").read_text()
            lines = [ln for ln in text.splitlines() if ln.startswith("[")]
            print(f"{time.perf_counter() - t0:8.1f} s  "
                  + (lines[-1] if lines else f"{cell} rc={proc.returncode}"),
                  flush=True)
        if over:
            left += todo
            todo = []
    print(f"sweep: {len(cells)} cells on the {args.mesh} mesh in "
          f"{time.perf_counter() - t0:.1f} s with {args.jobs} processes; "
          f"left: {left or 'none'}", flush=True)
    rows = report.load(args.out)
    print(report.summary(rows))
    print(report.table(rows, args.mesh))


if __name__ == "__main__":
    main()
