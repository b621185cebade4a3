"""memlint engine of the port: AST rule registry, suppressions, baseline,
file walker.

A copy of the JAX package's ``analysis/core.py`` with a registry of its own
(``RULES``), so that the port's rules (``repro_torch/analysis/rules.py``:
the same seven invariants, scoped to ``repro_torch/`` paths and to torch's
calls) never mix with the reference's.

Pieces:

  * **rule registry** — ``@rule("id", "one-line doc")`` registers a
    callback ``fn(ctx)`` that walks ``ctx.tree`` and calls
    ``ctx.report(node, message)``. Rules self-scope on ``ctx.rel`` (the
    file's path relative to the repo root), so fixtures in tests can
    reproduce any layout under a tmp dir.
  * **suppressions** — ``# memlint: ignore[rule-id]`` on the finding's
    line (or alone on the line above, for long statements) silences that
    rule there. ``ignore[*]`` silences every rule. Suppressions are meant
    to carry a justification comment — the sweep report counts them.
  * **baseline** — a committed JSON file of finding keys
    (``rule:path:line``) that are tolerated; ``--strict`` fails only on
    findings outside it. The port's is ``memlint_torch_baseline.json``, and
    it is empty.
  * **repo root discovery** — walks up from the scanned path to the first
    directory holding ``tests/`` or ``.git`` (falls back to the scan
    path), so cross-file rules (kernel/ref parity, the host-sync call
    graph) can find their counterparts in fixtures and in the real tree
    alike.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

_SUPPRESS_RE = re.compile(r"#\s*memlint:\s*ignore\[([^\]]+)\]")


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix path relative to the repo root
    line: int
    message: str

    @property
    def key(self) -> str:
        """Baseline identity: stable across message rewording is NOT a goal
        (the baseline should be empty); stable across unrelated-file edits
        is, hence no content hash."""
        return f"{self.rule}:{self.path}:{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Rule:
    id: str
    doc: str
    fn: Callable[["ModuleCtx"], None]


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, doc: str):
    """Register a rule. The decorated function receives a :class:`ModuleCtx`
    per swept file and reports findings via ``ctx.report``."""
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, doc, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# project-level context (cross-file rules)
# ---------------------------------------------------------------------------
class Project:
    """Lazy cross-file lookups shared by every ModuleCtx of one sweep."""

    def __init__(self, repo_root: str):
        self.repo_root = repo_root
        self._ref_functions: Dict[str, Set[str]] = {}
        self._tests_text: Optional[str] = None
        # what a cross-file rule computes once per sweep (the host-sync
        # rule's call graph), by the rule's own key
        self.cache: Dict[str, Any] = {}

    def ref_functions(self, kernels_dir: str) -> Set[str]:
        """Top-level function names defined in ``<kernels_dir>/ref.py``."""
        if kernels_dir not in self._ref_functions:
            names: Set[str] = set()
            path = os.path.join(kernels_dir, "ref.py")
            if os.path.exists(path):
                with open(path) as f:
                    src = f.read()
                try:
                    tree = ast.parse(src)
                except SyntaxError:
                    tree = ast.Module(body=[], type_ignores=[])
                names = {n.name for n in tree.body
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))}
            self._ref_functions[kernels_dir] = names
        return self._ref_functions[kernels_dir]

    def tests_text(self) -> str:
        """Concatenated source of every ``tests/**/*.py`` under the repo
        root (empty string when no tests dir exists)."""
        if self._tests_text is None:
            chunks: List[str] = []
            tdir = os.path.join(self.repo_root, "tests")
            if os.path.isdir(tdir):
                for base, _dirs, files in sorted(os.walk(tdir)):
                    for f in sorted(files):
                        if f.endswith(".py"):
                            with open(os.path.join(base, f)) as fh:
                                chunks.append(fh.read())
            self._tests_text = "\n".join(chunks)
        return self._tests_text


def find_repo_root(start: str) -> str:
    """Nearest ancestor of ``start`` containing ``tests/`` or ``.git``;
    ``start`` itself (its directory, for files) when none is found."""
    p = os.path.abspath(start)
    if os.path.isfile(p):
        p = os.path.dirname(p)
    cur = p
    while True:
        if os.path.isdir(os.path.join(cur, "tests")) \
                or os.path.isdir(os.path.join(cur, ".git")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return p
        cur = parent


# ---------------------------------------------------------------------------
# per-module context
# ---------------------------------------------------------------------------
class ModuleCtx:
    def __init__(self, path: str, rel: str, src: str, tree: ast.AST,
                 project: Project):
        self.path = path
        self.rel = rel                    # posix, relative to repo root
        self.src = src
        self.lines = src.splitlines()
        self.tree = tree
        self.project = project
        self._rule_id: Optional[str] = None
        self.findings: List[Finding] = []

    def report(self, where, message: str) -> None:
        """``where``: an AST node (uses .lineno) or an int line number."""
        line = where if isinstance(where, int) else getattr(where, "lineno", 1)
        self.findings.append(Finding(self._rule_id, self.rel, line, message))

    # -- suppression map ---------------------------------------------------
    def suppressions(self) -> Dict[int, Set[str]]:
        """line number -> rule ids suppressed there. A comment that is the
        whole line also suppresses the line below it (for statements too
        long to carry a trailing comment)."""
        out: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            out.setdefault(i, set()).update(ids)
            if text.lstrip().startswith("#"):       # standalone comment line
                out.setdefault(i + 1, set()).update(ids)
        return out


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------
@dataclass
class SweepResult:
    findings: List[Finding] = field(default_factory=list)      # actionable
    suppressed: List[Finding] = field(default_factory=list)    # ignored inline
    baselined: List[Finding] = field(default_factory=list)     # tolerated
    stale_baseline: List[str] = field(default_factory=list)    # keys unmatched
    files_swept: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for base, dirs, files in sorted(os.walk(p)):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(base, f)


def load_baseline(path: Optional[str]) -> Set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        doc = json.load(f)
    return set(doc.get("findings", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    doc = {"version": 1, "findings": sorted(f.key for f in findings)}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def run_paths(paths: Sequence[str], *, rules: Optional[Sequence[str]] = None,
              repo_root: Optional[str] = None,
              baseline: Optional[Set[str]] = None) -> SweepResult:
    """Sweep ``paths`` with the registered rules (all by default).

    Returns a :class:`SweepResult` with inline-suppressed and baselined
    findings separated out; ``result.findings`` is what --strict gates on.
    """
    # rules register on import; tolerate being called before rules.py loaded
    from repro_torch.analysis import rules as _rules  # noqa: F401

    active = [RULES[r] for r in rules] if rules else list(RULES.values())
    root = repo_root or find_repo_root(paths[0] if paths else ".")
    project = Project(root)
    base = baseline or set()
    res = SweepResult()
    matched_base: Set[str] = set()

    for path in iter_py_files(paths):
        res.files_swept += 1
        with open(path) as f:
            src = f.read()
        rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            res.findings.append(Finding(
                "parse-error", rel, e.lineno or 1, f"syntax error: {e.msg}"))
            continue
        ctx = ModuleCtx(path, rel, src, tree, project)
        for r in active:
            ctx._rule_id = r.id
            r.fn(ctx)
        sup = ctx.suppressions()
        for f in ctx.findings:
            ids = sup.get(f.line, set())
            if f.rule in ids or "*" in ids:
                res.suppressed.append(f)
            elif f.key in base:
                res.baselined.append(f)
                matched_base.add(f.key)
            else:
                res.findings.append(f)
    res.stale_baseline = sorted(base - matched_base)
    res.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return res
