"""memlint for the port: static analysis + dynamic lock-order checking.

The port's serve-stack invariants (deterministic top-k tie-break,
fsync-after-rename, journaled persistent-state mutation, replay determinism,
span discipline, kernel/plain-version parity, no host sync on the engine's
phases and the decode path) as enforced rules over ``repro_torch/``:

  * ``python -m repro_torch.analysis src/repro_torch --strict`` — the AST
    sweep (``rules.py``; engine in ``core.py``), against the port's own
    empty baseline ``memlint_torch_baseline.json``.
  * ``repro_torch.analysis.lockcheck`` — an instrumented Lock wrapper that
    records the cross-thread lock-acquisition graph, flags cycles (the
    deadlock precondition) and lock-held blocking calls.
"""
from repro_torch.analysis.core import (Finding, RULES, Rule, SweepResult,
                                       find_repo_root, load_baseline, rule,
                                       run_paths, write_baseline)
from repro_torch.analysis import rules as _rules  # noqa: F401  (registers rules)

__all__ = ["Finding", "RULES", "Rule", "SweepResult", "find_repo_root",
           "load_baseline", "rule", "run_paths", "write_baseline"]
