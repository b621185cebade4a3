"""The port's memlint rule set: the JAX package's seven serve-stack
invariants, scoped to ``repro_torch/`` paths and to torch's calls.

Each rule is deliberately narrow — it matches the concrete syntactic shapes
the port uses, not every conceivable violation, so a finding is
near-certainly real and a clean pass is cheap to keep. Every rule has a
triggering fixture and a clean-pass fixture in tests/test_torch_analysis.py.
Where a rule means what the reference's means, it keeps the reference's
form (``rename-fsync``, ``span-context``); ``kernel-parity`` and
``host-sync`` take the port's own form: the kernels are CUDA sources listed
in ``kernels/_build.py``, and the decode path runs through functions outside
the engine.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import ModuleCtx, rule


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------
def qualname(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def calls_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def _has_kw(call: ast.Call, name: str, value) -> bool:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and kw.value.value == value:
            return True
    return False


def _in_scope(ctx: ModuleCtx, *suffixes: str) -> bool:
    return any(s in ctx.rel if s.endswith("/") else ctx.rel.endswith(s)
               for s in suffixes)


def _method(call: ast.Call) -> str:
    """The attribute name of a method call (``x.name(...)``), else ''."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


# ---------------------------------------------------------------------------
# 1. deterministic top-k tie-break
# ---------------------------------------------------------------------------
_TOPK_SCOPE = ("repro_torch/kernels/", "repro_torch/core/retrieval.py",
               "repro_torch/core/residency.py", "repro_torch/core/baselines/",
               "repro_torch/models/layers.py")


@rule("topk-tiebreak",
      "top-k over similarity scores (and the MoE's top-K) must use the "
      "deterministic (score desc, row id asc) tie-break — no torch.topk, no "
      "unstable sort or argsort — or the port loses exact parity with the "
      "reference")
def topk_tiebreak(ctx: ModuleCtx) -> None:
    if not _in_scope(ctx, *_TOPK_SCOPE):
        return
    for call in calls_in(ctx.tree):
        q = qualname(call.func)
        name = _method(call) or q
        if name == "topk" or (q.endswith("top_k")
                              and ("lax" in q or q == "top_k")):
            ctx.report(call, f"{q or name}() has implementation-defined tie "
                             "order; use a stable two-key sort (score desc, "
                             "index asc)")
        elif name in ("sort", "argsort"):
            if "key" in {kw.arg for kw in call.keywords}:
                continue            # list.sort(key=...): Python's is stable
            if not (_has_kw(call, "stable", True)
                    or _has_kw(call, "kind", "stable")):
                ctx.report(call, f"unstable {name} on scores breaks the "
                                 "(score desc, row id asc) tie-break "
                                 "contract; pass stable=True (torch) or "
                                 "kind='stable' (numpy)")


# ---------------------------------------------------------------------------
# 2. commit-protocol renames are followed by a directory fsync
# ---------------------------------------------------------------------------
@rule("rename-fsync",
      "every os.rename/os.replace on a durability path must be followed by "
      "fsync_dir in the same function, or the committed directory entry can "
      "vanish on power loss and recovery drops acked writes")
def rename_fsync(ctx: ModuleCtx) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        renames = []
        has_fsync_dir = False
        for call in calls_in(fn):
            q = qualname(call.func)
            if q in ("os.rename", "os.replace"):
                renames.append(call)
            elif q.endswith("fsync_dir"):
                has_fsync_dir = True
        # fsync_dir itself is the primitive; it contains no rename
        if renames and not has_fsync_dir and fn.name != "fsync_dir":
            for call in renames:
                ctx.report(call, f"os.{call.func.attr} in {fn.name}() has no "
                                 "fsync_dir in the same function — the "
                                 "renamed entry is not durable")


# ---------------------------------------------------------------------------
# 3. persistent-state mutations ride the journal
# ---------------------------------------------------------------------------
_MUTATORS = {"delete_session", "migrate_merge", "compact_tree"}
# journal.py IS the journaled path (ops + replay); maintenance.py defines the
# mutators (and may compose them internally).
_JOURNAL_MODULES = ("repro_torch/core/journal.py",
                    "repro_torch/core/maintenance.py")


@rule("journaled-mutation",
      "persistent-state mutators (delete_session / migrate_merge / "
      "compact_tree) outside core/journal.py replay must route through a "
      "journaled DurableMemForest op, or a crash after the mutation "
      "recovers to a different state digest")
def journaled_mutation(ctx: ModuleCtx) -> None:
    if "repro_torch/" not in ctx.rel or _in_scope(ctx, *_JOURNAL_MODULES):
        return
    # bare names count only when imported from the maintenance module
    bare: Set[str] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.ImportFrom) and n.module \
                and n.module.endswith("maintenance"):
            bare.update(a.asname or a.name for a in n.names
                        if a.name in _MUTATORS)
    for call in calls_in(ctx.tree):
        q = qualname(call.func)
        name = q.rsplit(".", 1)[-1]
        if name not in _MUTATORS:
            continue
        if q.startswith("maintenance.") or q in bare:
            ctx.report(call, f"direct {name}() mutates persistent state "
                             "without a journal record; route through the "
                             "journaled DurableMemForest op")


# ---------------------------------------------------------------------------
# 4. replay / digest / snapshot determinism
# ---------------------------------------------------------------------------
_SET_ATTRS = {"applied_ops", "dirty_trees", "dirty"}
_DETERMINISM_SCOPE = ("repro_torch/core/journal.py",
                      "repro_torch/core/persistence.py",
                      "repro_torch/core/codec.py")
_CLOCKS = ("time.time", "time.time_ns", "time.perf_counter", "time.monotonic")
_RANDOM = ("random.", "np.random.", "numpy.random.", "torch.rand",
           "torch.random.")


def _iter_nodes(tree: ast.AST):
    """(iterable expression, anchor node) pairs of every for-loop and
    comprehension generator."""
    for n in ast.walk(tree):
        if isinstance(n, (ast.For, ast.AsyncFor)):
            yield n.iter, n
        elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                            ast.GeneratorExp)):
            for gen in n.generators:
                yield gen.iter, n


@rule("replay-determinism",
      "journal replay, digest computation, snapshot serialization and the "
      "codec must be deterministic: no wall clocks, no random (numpy's or "
      "torch's), no unordered-set iteration — or recovered state digests "
      "diverge run-to-run")
def replay_determinism(ctx: ModuleCtx) -> None:
    if not _in_scope(ctx, *_DETERMINISM_SCOPE):
        return
    for call in calls_in(ctx.tree):
        q = qualname(call.func)
        if q in _CLOCKS:
            ctx.report(call, f"{q}() in a replay/serialization module makes "
                             "recovered state timing-dependent")
        elif q.startswith(_RANDOM):
            ctx.report(call, f"{q}() in a replay/serialization module makes "
                             "recovered state nondeterministic")
    for it, anchor in _iter_nodes(ctx.tree):
        if isinstance(it, ast.Set) \
                or (isinstance(it, ast.Call) and qualname(it.func) == "set"):
            ctx.report(anchor, "iterating a set directly: order is "
                               "arbitrary — wrap in sorted()")
        elif isinstance(it, ast.Attribute) and it.attr in _SET_ATTRS:
            ctx.report(anchor, f"iterating .{it.attr} (a set) directly: "
                               "order is arbitrary — wrap in sorted()")


# ---------------------------------------------------------------------------
# 5. spans only via context manager
# ---------------------------------------------------------------------------
@rule("span-context",
      "spans are opened only as `with obs.span(...)` — a manual __enter__ "
      "leaks the span onto the thread-local stack on any exception and "
      "corrupts every later span's parentage")
def span_context(ctx: ModuleCtx) -> None:
    if _in_scope(ctx, "repro_torch/obs/"):
        return                      # the implementation layer itself
    with_items: Set[int] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                with_items.add(id(item.context_expr))
    for call in calls_in(ctx.tree):
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "span":
            if id(call) not in with_items:
                ctx.report(call, "span() result used outside a with "
                                 "statement — open spans only via the "
                                 "context manager")
        if isinstance(func, ast.Attribute) and func.attr == "__enter__":
            ctx.report(call, "manual __enter__ call — use a with statement")


# ---------------------------------------------------------------------------
# 6. every CUDA kernel has a plain version that a test references
# ---------------------------------------------------------------------------
# kernel source stem -> the stem of its plain version in ref.py
_KERNEL_ALIASES: Dict[str, str] = {"flash_attention": "attention",
                                   "flash_attention_bwd": "attention_bwd"}


@rule("kernel-parity",
      "every CUDA source in kernels/_build.SOURCES needs a plain version "
      "<kernel>_ref in kernels/ref.py that a test under tests/ names — a "
      "kernel without one drifts silently")
def kernel_parity(ctx: ModuleCtx) -> None:
    parts = ctx.rel.split("/")
    if "repro_torch" not in parts or parts[-2:] != ["kernels", "_build.py"]:
        return
    sources = next(
        (n for n in ctx.tree.body if isinstance(n, ast.Assign)
         and any(isinstance(t, ast.Name) and t.id == "SOURCES"
                 for t in n.targets)), None)
    if sources is None or not isinstance(sources.value, (ast.Tuple, ast.List)):
        ctx.report(1, "kernels/_build.py has no SOURCES tuple of CUDA "
                      "sources")
        return
    refs = ctx.project.ref_functions(os.path.dirname(ctx.path))
    tests = ctx.project.tests_text()
    for elt in sources.value.elts:
        if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
            continue
        stem = os.path.splitext(elt.value)[0]
        ref_name = f"{_KERNEL_ALIASES.get(stem, stem)}_ref"
        if ref_name not in refs:
            ctx.report(elt, f"CUDA kernel {elt.value} has no {ref_name}() "
                            "plain version in kernels/ref.py")
        elif ref_name not in tests:
            ctx.report(elt, f"plain version {ref_name}() of {elt.value} is "
                            "not named by any test under tests/ — parity is "
                            "unchecked")


# ---------------------------------------------------------------------------
# 7. no host sync on the engine's phases and what they call
# ---------------------------------------------------------------------------
_ENGINE_PHASES = ("step", "_admit")          # and every _drain_* method
_FOLLOWED = ("serving", "models", "kernels")  # subpackages the calls reach
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
# calls on a tensor that leave a host number: float()/int()/bool() of such
# an expression waits for the device; shapes, sizes and lengths do not
_TENSOR_REDUCTIONS = {"sum", "max", "min", "mean", "any", "all", "argmax",
                      "argmin", "norm", "abs", "prod", "count_nonzero",
                      "amax", "amin", "std", "var"}
_HOST_SHAPE_ATTRS = {"shape", "size", "dim", "ndim", "numel", "dtype",
                     "device"}

FuncKey = Tuple[str, int, int]               # (rel path, line, column)


def _is_phase(name: str) -> bool:
    return name in _ENGINE_PHASES or name.startswith("_drain_")


def _tensor_expr(node: ast.AST) -> bool:
    """Whether ``node`` computes a value on a tensor: it calls a ``torch.``
    function or a reduction method, outside any shape, size, dtype or
    ``len()``."""
    if isinstance(node, ast.Attribute) and node.attr in _HOST_SHAPE_ATTRS:
        return False
    if isinstance(node, ast.Call):
        q = qualname(node.func)
        if q == "len" or _method(node) in _HOST_SHAPE_ATTRS:
            return False
        if q.startswith("torch.") or _method(node) in _TENSOR_REDUCTIONS:
            return True
    return any(_tensor_expr(c) for c in ast.iter_child_nodes(node))


def _mask_index(node: ast.Subscript) -> bool:
    """``t[t > 0]`` or ``t[(a > 0) & m]``: boolean-mask indexing."""
    sl = node.slice
    if isinstance(sl, ast.Compare):
        return True
    return isinstance(sl, ast.BinOp) and isinstance(
        sl.op, (ast.BitAnd, ast.BitOr)) and any(
            isinstance(n, ast.Compare) for n in ast.walk(sl))


def _sync_of(node: ast.AST) -> Optional[str]:
    """What host sync ``node`` forces, or None."""
    if isinstance(node, ast.Subscript):
        return "boolean-mask indexing" if _mask_index(node) else None
    if not isinstance(node, ast.Call):
        return None
    q = qualname(node.func)
    if q in ("torch.cuda.synchronize", "torch.nonzero"):
        return f"{q}()"
    if q in ("np.asarray", "np.array", "numpy.asarray", "numpy.array") \
            and node.args and not isinstance(
                node.args[0], (ast.List, ast.Tuple, ast.ListComp,
                               ast.Constant)):
        return f"{q}() of a tensor"
    if _method(node) in _SYNC_METHODS:
        return f".{_method(node)}()"
    if q in ("float", "int", "bool") and node.args \
            and _tensor_expr(node.args[0]):
        return f"{q}() of a tensor expression"
    return None


class _CallGraph:
    """The functions of ``serving/``, ``models/`` and ``kernels/`` that the
    engine's phase methods reach, transitively and by name: a call ``f(...)``
    or ``x.f(...)`` reaches every function or method named ``f`` there, and
    a name bound to a lambda (``decode=lambda ...``) or to
    ``functools.partial(g, ...)`` reaches the lambda's calls or ``g``.
    ``reached`` maps each reached function (and lambda) to the first phase
    method, in the engine's order, that reaches it."""

    def __init__(self, pkg_dir: str, repo_root: str):
        self.defs: Dict[str, List[Tuple[FuncKey, ast.AST]]] = {}
        self.aliases: Dict[str, Set[str]] = {}
        phases: List[Tuple[FuncKey, ast.AST, str]] = []
        for sub in _FOLLOWED:
            base = os.path.join(pkg_dir, sub)
            if not os.path.isdir(base):
                continue
            for root, dirs, files in sorted(os.walk(base)):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for f in sorted(files):
                    if f.endswith(".py"):
                        path = os.path.join(root, f)
                        phases += self._index(path, os.path.relpath(
                            path, repo_root).replace(os.sep, "/"))
        self.reached: Dict[FuncKey, str] = {}
        for key, node, phase in phases:
            self._walk(key, node, phase)

    def _index(self, path: str, rel: str):
        with open(path) as fh:
            try:
                tree = ast.parse(fh.read())
            except SyntaxError:
                return []
        phases = []
        for n in ast.walk(tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(n.name, []).append(
                    ((rel, n.lineno, n.col_offset), n))
            elif isinstance(n, ast.ClassDef) and n.name == "ServeEngine":
                phases += [((rel, f.lineno, f.col_offset), f, f.name)
                           for f in n.body
                           if isinstance(f, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and _is_phase(f.name)]
            binds: List[Tuple[str, ast.AST]] = []
            if isinstance(n, ast.Call):
                binds = [(kw.arg, kw.value) for kw in n.keywords if kw.arg]
            elif isinstance(n, ast.Assign):
                binds = [(t.id, n.value) for t in n.targets
                         if isinstance(t, ast.Name)]
            for name, value in binds:
                if isinstance(value, ast.Lambda):
                    self.defs.setdefault(name, []).append(
                        ((rel, value.lineno, value.col_offset), value))
                elif isinstance(value, ast.Call) and qualname(
                        value.func) in ("functools.partial", "partial") \
                        and value.args:
                    target = qualname(value.args[0]).rsplit(".", 1)[-1]
                    if target:
                        self.aliases.setdefault(name, set()).add(target)
        return phases

    def _resolve(self, name: str, seen: Set[str]):
        if name in seen:
            return
        seen.add(name)
        yield from self.defs.get(name, ())
        for target in sorted(self.aliases.get(name, ())):
            yield from self._resolve(target, seen)

    def _walk(self, key: FuncKey, node: ast.AST, phase: str) -> None:
        if key in self.reached:
            return
        self.reached[key] = phase
        todo = [node]
        while todo:
            fn = todo.pop()
            for call in calls_in(fn):
                name = qualname(call.func).rsplit(".", 1)[-1] \
                    or _method(call)
                for k, n in self._resolve(name, set()):
                    if k not in self.reached:
                        self.reached[k] = phase
                        todo.append(n)


def _package_dir(ctx: ModuleCtx) -> Optional[str]:
    """The ``repro_torch`` directory that ``ctx``'s file lies in."""
    path = os.path.abspath(ctx.path)
    marker = os.sep + "repro_torch" + os.sep
    if marker not in path:
        return None
    return path[: path.index(marker) + len(marker) - 1]


@rule("host-sync",
      "no host-synchronizing calls (.item / .tolist / .cpu / .numpy / "
      "nonzero / np.asarray of a tensor / torch.cuda.synchronize / "
      "float(), int() or bool() of a tensor / boolean-mask indexing) on "
      "ServeEngine's phase methods or in the serving, models and kernels "
      "functions they reach — a hidden sync serializes the decode cadence "
      "and breaks a CUDA-graph capture of the decode step")
def host_sync(ctx: ModuleCtx) -> None:
    parts = ctx.rel.split("/")
    if "repro_torch" not in parts[:-2] \
            or parts[parts.index("repro_torch") + 1] not in _FOLLOWED:
        return
    pkg = _package_dir(ctx)
    if pkg is None:
        return
    cache_key = f"host-sync:{pkg}"
    graph = ctx.project.cache.get(cache_key)
    if graph is None:
        graph = ctx.project.cache[cache_key] = _CallGraph(
            pkg, ctx.project.repo_root)
    seen: Set[Tuple[int, int]] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        phase = graph.reached.get((ctx.rel, node.lineno, node.col_offset))
        if phase is None:
            continue
        body = node.body if isinstance(node.body, list) else [node.body]
        for stmt in body:
            for n in ast.walk(stmt):
                what = _sync_of(n)
                if what is None or (n.lineno, n.col_offset) in seen:
                    continue
                seen.add((n.lineno, n.col_offset))
                where = getattr(node, "name", "a lambda")
                ctx.report(n, f"{what} forces a device->host sync in "
                              f"{where}(), reached from "
                              f"ServeEngine.{phase}()")
