"""memlint and lockcheck of the port (``repro_torch.analysis``): every one of
the seven rules has a triggering fixture and a clean one under
``src/repro_torch/...`` paths; where a rule means what the reference's means
(``rename-fsync``, ``span-context``, suppressions, the baseline, the CLI's
exit codes), both engines give the same findings (rule, line) on mirrored
fixtures; ``host-sync`` follows the engine's phases into helpers and a
family's ``decode_step``; the real port tree sweeps clean with the port's
empty baseline; and lockcheck's cases run on both packages' modules, which
find the same cycles, then on the port's serve stack under the port's own
lockcheck."""
import json
import os
import random
import sys
import textwrap
import threading
import time

import pytest

from repro.analysis import RULES as JAX_RULES
from repro.analysis import lockcheck as jax_lockcheck
from repro.analysis import run_paths as jax_run_paths
from repro.analysis.__main__ import main as jax_main
from repro_torch.analysis import RULES, run_paths
from repro_torch.analysis import lockcheck as torch_lockcheck
from repro_torch.analysis.__main__ import main as memlint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEVEN = {"topk-tiebreak", "rename-fsync", "journaled-mutation",
         "replay-determinism", "span-context", "kernel-parity", "host-sync"}


def _write(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def sweep(tmp_path, files, rules=None, baseline=None, engine=run_paths):
    """Materialize ``{relpath: source}`` under tmp_path and sweep its src/."""
    _write(tmp_path, files)
    return engine([str(tmp_path / "src")], rules=rules,
                  repo_root=str(tmp_path), baseline=baseline)


def found(res):
    return [(f.rule, f.path, f.line) for f in res.findings]


def lines(res):
    return [f.line for f in res.findings]


def test_registry_has_the_seven_rules_apart_from_the_reference():
    assert set(RULES) == SEVEN and SEVEN <= set(JAX_RULES)
    assert RULES is not JAX_RULES
    for rid in SEVEN:
        assert RULES[rid].fn is not JAX_RULES[rid].fn


# ---------------------------------------------------------------------------
# rule 1: deterministic top-k tie-break
# ---------------------------------------------------------------------------
def test_topk_tiebreak_triggers(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/core/retrieval.py": """
        import numpy as np
        import torch
        from jax import lax

        def pick(sims, k):
            a = torch.topk(sims, k)
            b = sims.topk(k, dim=-1)
            c = torch.sort(sims, descending=True)
            d = sims.argsort(descending=True)
            e = np.argsort(-sims.numpy())
            f = lax.top_k(sims, k)
            g = torch.argsort(sims, stable=False)
            return a, b, c, d, e, f, g
    """, "src/repro_torch/models/layers.py": """
        import torch

        def route(logits, k):
            return torch.topk(logits, k, dim=-1)
    """}, rules=["topk-tiebreak"])
    assert found(res) == [
        ("topk-tiebreak", "src/repro_torch/core/retrieval.py", n)
        for n in range(7, 14)] + [
        ("topk-tiebreak", "src/repro_torch/models/layers.py", 5)]


def test_topk_tiebreak_clean_and_scoped(tmp_path):
    res = sweep(tmp_path, {
        "src/repro_torch/core/baselines/base.py": """
            import numpy as np
            import torch

            def pick(sims, k, facts):
                a = torch.sort(-sims, stable=True)
                b = sims.argsort(descending=True, stable=True)
                c = np.argsort(-sims.numpy(), kind="stable")[:k]
                facts.sort(key=lambda f: f.ts)
                return a, b, c, sorted(facts, key=lambda f: -f.ts)
        """,
        # a top-k outside the scoped files is not this rule's business
        "src/repro_torch/data/synthetic.py": """
            import torch

            def shuffle_order(x):
                return torch.topk(x, 2), x.argsort()
        """,
        # nor is the reference's tree: its own rule covers it
        "src/repro/core/retrieval.py": """
            import torch

            def pick(x):
                return torch.topk(x, 2)
        """}, rules=["topk-tiebreak"])
    assert res.clean


# ---------------------------------------------------------------------------
# rule 2: rename followed by fsync_dir (the reference's meaning)
# ---------------------------------------------------------------------------
_RENAME_BAD = """
    import os

    def commit(tmp, final):
        os.replace(tmp, final)

    def move(a, b):
        os.rename(a, b)
"""
_RENAME_GOOD = """
    import os

    def fsync_dir(path):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def commit(tmp, final):
        os.replace(tmp, final)
        fsync_dir(os.path.dirname(final))
"""


@pytest.mark.parametrize("src,n", [(_RENAME_BAD, 2), (_RENAME_GOOD, 0)],
                         ids=["triggers", "clean"])
def test_rename_fsync_matches_the_reference(tmp_path, src, n):
    mine = sweep(tmp_path / "t", {"src/repro_torch/core/store.py": src},
                 rules=["rename-fsync"])
    ref = sweep(tmp_path / "j", {"src/repro/core/store.py": src},
                rules=["rename-fsync"], engine=jax_run_paths)
    assert [(f.rule, f.line) for f in mine.findings] == \
        [(f.rule, f.line) for f in ref.findings]
    assert len(mine.findings) == n
    assert all("fsync_dir" in f.message for f in mine.findings)


# ---------------------------------------------------------------------------
# rule 3: persistent mutations ride the journal
# ---------------------------------------------------------------------------
def test_journaled_mutation_triggers(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/core/plane.py": """
        from repro_torch.core import maintenance
        from repro_torch.core.maintenance import delete_session

        def tick(forest, src, sid, scope):
            maintenance.migrate_merge(forest, src)
            maintenance.compact_tree(forest, scope)
            delete_session(forest, sid)
    """}, rules=["journaled-mutation"])
    assert lines(res) == [6, 7, 8]


def test_journaled_mutation_allows_journal_modules_and_durable_ops(tmp_path):
    res = sweep(tmp_path, {
        "src/repro_torch/core/journal.py": """
            from repro_torch.core import maintenance

            def _apply(forest, src):
                maintenance.migrate_merge(forest, src)
        """,
        "src/repro_torch/core/maintenance.py": """
            def compact_all(forest, scopes):
                for s in scopes:
                    compact_tree(forest, s)
        """,
        "src/repro_torch/core/plane.py": """
            def tick(store, scope):
                store.compact_tree(scope, idempotency_key="k")
        """,
        # outside the port: not this rule's scope
        "src/tools/cleanup.py": """
            import maintenance

            def go(f, s):
                maintenance.delete_session(f, s)
        """}, rules=["journaled-mutation"])
    assert res.clean


# ---------------------------------------------------------------------------
# rule 4: replay / digest / codec determinism
# ---------------------------------------------------------------------------
def test_replay_determinism_triggers(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/core/codec.py": """
        import random
        import time

        import torch

        def pack(forest, recs):
            t0 = time.time()
            random.shuffle(recs)
            noise = torch.randn(4)
            pick = torch.randint(0, 4, (1,))
            torch.random.manual_seed(0)
            for op in forest.applied_ops:
                pass
            keys = [k for k in set(recs)]
            return t0, noise, pick, keys
    """}, rules=["replay-determinism"])
    assert lines(res) == [8, 9, 10, 11, 12, 13, 15]
    msgs = " ".join(f.message for f in res.findings)
    assert "time.time" in msgs and "torch.randn" in msgs and "set" in msgs


def test_replay_determinism_clean_when_sorted_and_out_of_scope(tmp_path):
    res = sweep(tmp_path, {
        "src/repro_torch/core/persistence.py": """
            def replay(forest, recs):
                for op in sorted(forest.applied_ops):
                    pass
        """,
        # wall clocks and random draws are fine outside replay modules
        "src/repro_torch/serving/engine.py": """
            import time

            import torch

            def now():
                return time.time(), torch.rand(2)
        """}, rules=["replay-determinism"])
    assert res.clean


# ---------------------------------------------------------------------------
# rule 5: spans only via context manager (the reference's meaning)
# ---------------------------------------------------------------------------
_SPAN_BAD = """
    def step(obs):
        s = obs.span("engine.step")
        s.__enter__()
"""
_SPAN_GOOD = """
    def step(obs):
        with obs.span("engine.step"):
            pass
"""


@pytest.mark.parametrize("src,n", [(_SPAN_BAD, 2), (_SPAN_GOOD, 0)],
                         ids=["triggers", "clean"])
def test_span_context_matches_the_reference(tmp_path, src, n):
    mine = sweep(tmp_path / "t", {"src/repro_torch/serving/engine.py": src},
                 rules=["span-context"])
    ref = sweep(tmp_path / "j", {"src/repro/serving/engine.py": src},
                rules=["span-context"], engine=jax_run_paths)
    assert [(f.rule, f.line) for f in mine.findings] == \
        [(f.rule, f.line) for f in ref.findings]
    assert len(mine.findings) == n


def test_span_context_exempts_the_obs_layer(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/obs/trace.py": """
        def span(self, name):
            s = self._mk_span(name)
            s.__enter__()
            return s
    """}, rules=["span-context"])
    assert res.clean


# ---------------------------------------------------------------------------
# rule 6: every CUDA kernel has a plain version a test names
# ---------------------------------------------------------------------------
_BUILD = """
    SOURCES = ("mykern.cu", "flash_attention.cu")
    HEADERS = ("tma.cuh",)
"""
_REF = """
    def mykern_ref(x):
        return x

    def attention_ref(q, k, v):
        return q
"""


def test_kernel_parity_missing_plain_version_triggers(tmp_path):
    res = sweep(tmp_path, {
        "src/repro_torch/kernels/_build.py": _BUILD,
        "src/repro_torch/kernels/ref.py": "def attention_ref(q):\n    return q\n",
        "tests/test_k.py": "def test_a():\n    assert attention_ref\n",
    }, rules=["kernel-parity"])
    assert found(res) == [("kernel-parity",
                           "src/repro_torch/kernels/_build.py", 2)]
    assert "mykern_ref" in res.findings[0].message


def test_kernel_parity_unreferenced_plain_version_triggers(tmp_path):
    res = sweep(tmp_path, {
        "src/repro_torch/kernels/_build.py": _BUILD,
        "src/repro_torch/kernels/ref.py": _REF,
        "tests/test_k.py": "def test_a():\n    assert attention_ref\n",
    }, rules=["kernel-parity"])
    assert lines(res) == [2]
    assert "mykern_ref" in res.findings[0].message \
        and "not named" in res.findings[0].message


def test_kernel_parity_clean_when_tests_name_every_plain_version(tmp_path):
    res = sweep(tmp_path, {
        "src/repro_torch/kernels/_build.py": _BUILD,
        "src/repro_torch/kernels/ref.py": _REF,
        "tests/test_k.py": """
            from repro_torch.kernels.ref import attention_ref, mykern_ref

            def test_parity():
                assert mykern_ref(1) == 1 and attention_ref
        """,
        # a module that is not _build.py lists no kernels
        "src/repro_torch/kernels/helpers.py": "SOURCES = ('x.cu',)\n",
    }, rules=["kernel-parity"])
    assert res.clean


def test_kernel_parity_holds_on_the_real_sources():
    from repro_torch.kernels import _build
    res = run_paths([os.path.join(REPO, "src", "repro_torch", "kernels",
                                  "_build.py")], rules=["kernel-parity"],
                    repo_root=REPO)
    assert res.clean and len(_build.SOURCES) == 7


# ---------------------------------------------------------------------------
# rule 7: no host sync on the engine's phases and what they reach
# ---------------------------------------------------------------------------
def test_host_sync_triggers_in_the_phase_bodies(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/serving/engine.py": """
        import numpy as np
        import torch

        class ServeEngine:
            def step(self):
                a = self.logits.argmax(-1).item()
                b = self.logits.tolist()
                c = self.logits.cpu()
                d = np.asarray(self.logits)
                torch.cuda.synchronize()
                return a, b, c, d

            def _drain_queries(self):
                e = torch.nonzero(self.mask)
                f = self.mask.nonzero()
                g = float(self.logits.sum())
                h = int(torch.argmax(self.logits))
                i = bool((self.a == self.b).all())
                j = self.x[self.x > 0]
                k = self.logits.numpy()
                return e, f, g, h, i, j, k
    """}, rules=["host-sync"])
    assert lines(res) == [7, 8, 9, 10, 11, 15, 16, 17, 18, 19, 20, 21]
    assert all("reached from ServeEngine.step()" in f.message
               for f in res.findings[:5])
    assert all("ServeEngine._drain_queries()" in f.message
               for f in res.findings[5:])


def test_host_sync_clean_on_shapes_sizes_and_outside_the_phases(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/serving/engine.py": """
        import numpy as np
        import torch

        class ServeEngine:
            def step(self):
                B = int(self.x.shape[0])
                n = self.x.size(1) + self.x.dim() + len(self.queue)
                t = np.asarray([1, 2, 3])
                bf16 = int(self.x.dtype == torch.bfloat16)
                return B, n, t, bf16

            def pop_query_result(self, rid):
                return self.results[rid].tolist()

        class Harness:
            def step(self):
                return self.x.item()
    """}, rules=["host-sync"])
    assert res.clean


_ENGINE_CALLS = """
    from repro_torch.serving import util

    class ServeEngine:
        def step(self):
            self.last = self.model.decode(self.params, self.batch, self.cache)
            return util.helper(self.last)

        def _admit(self):
            return self.memory.remember(self.x)
"""


def test_host_sync_follows_helpers_and_decode_step(tmp_path):
    """``step`` reaches a helper in ``serving/`` and, through the factory's
    ``decode=lambda`` binding, a family's ``decode_step`` and what it calls
    in ``kernels/``: each planted sync is reported in its own file, naming
    the phase. Functions nothing reaches, and ``core/`` (not followed), are
    not reported."""
    res = sweep(tmp_path, {
        "src/repro_torch/serving/engine.py": _ENGINE_CALLS,
        "src/repro_torch/serving/util.py": """
            def helper(x):
                return x.max().item()

            def unused(x):
                return x.item()
        """,
        "src/repro_torch/models/factory.py": """
            import functools
            from typing import NamedTuple

            from repro_torch.models import fam

            class Model(NamedTuple):
                decode: object
                init: object

            def get_model(cfg):
                return Model(
                    decode=lambda p, b, c: fam.decode_step(p, cfg, b, c),
                    init=functools.partial(fam.init_params, cfg))
        """,
        "src/repro_torch/models/fam.py": """
            from repro_torch.kernels import attn

            def decode_step(params, cfg, batch, cache):
                n = int(cache["lengths"].max())
                return attn.decode_attention(batch, cache, n)

            def init_params(cfg, seed):
                return seed.tolist()
        """,
        "src/repro_torch/kernels/attn.py": """
            def decode_attention(q, cache, n):
                return q[q > n]
        """,
        "src/repro_torch/core/memory.py": """
            class Memory:
                def remember(self, x):
                    return x.item()
        """}, rules=["host-sync"])
    assert found(res) == [
        ("host-sync", "src/repro_torch/kernels/attn.py", 3),
        ("host-sync", "src/repro_torch/models/fam.py", 5),
        ("host-sync", "src/repro_torch/serving/util.py", 3)]
    assert all("reached from ServeEngine.step()" in f.message
               for f in res.findings)
    assert "decode_step()" in res.findings[1].message


def test_host_sync_reaches_every_family_decode_step():
    from repro_torch.analysis.rules import _CallGraph
    graph = _CallGraph(os.path.join(REPO, "src", "repro_torch"), REPO)
    reached = {(rel, line): phase
               for (rel, line, _), phase in graph.reached.items()}
    for fam in ("transformer", "zamba2", "rwkv6", "whisper"):
        path = os.path.join(REPO, "src", "repro_torch", "models", f"{fam}.py")
        with open(path) as fh:
            line = next(i for i, text in enumerate(fh, 1)
                        if text.startswith("def decode_step("))
        assert reached[(f"src/repro_torch/models/{fam}.py", line)] == "step"
    assert any(rel.endswith("kernels/decode_attention.py")
               for rel, _ in reached)


def test_host_sync_finds_a_sync_planted_in_a_real_decode_step(tmp_path):
    """A copy of the port's package with an ``.item()`` planted in
    transformer.decode_step: the sweep of the copy reports it there."""
    import shutil
    pkg = tmp_path / "src" / "repro_torch"
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "tests").mkdir()
    path = pkg / "models" / "transformer.py"
    src = path.read_text()
    start = src.index("def decode_step(")
    body = src.index("\n", src.index("):", start)) + 1
    planted = src[:body] + "    _ = cache['lengths'].max().item()\n" \
        + src[body:]
    path.write_text(planted)
    res = run_paths([str(pkg)], rules=["host-sync"], repo_root=str(tmp_path))
    assert [(f.path, f.line) for f in res.findings] == [
        ("src/repro_torch/models/transformer.py",
         planted[:body].count("\n") + 1)]
    assert "decode_step()" in res.findings[0].message


# ---------------------------------------------------------------------------
# suppression, baseline and CLI: the reference's meaning
# ---------------------------------------------------------------------------
_SUPPRESSED = {
    "named": """
        import os

        def commit(tmp, final):
            os.replace(tmp, final)  # memlint: ignore[rename-fsync]
    """,
    "wrong_rule": """
        import os

        def commit(tmp, final):
            os.replace(tmp, final)  # memlint: ignore[topk-tiebreak]
    """,
    "line_above": """
        import os

        def commit(tmp, final):
            # justified: tmp dir is recreated from scratch on recovery
            # memlint: ignore[rename-fsync]
            os.replace(tmp, final)
    """,
    "wildcard": """
        import os

        def commit(tmp, final):
            os.replace(tmp, final)  # memlint: ignore[*]
    """,
}


@pytest.mark.parametrize("case", sorted(_SUPPRESSED))
def test_suppression_matches_the_reference(tmp_path, case):
    src = _SUPPRESSED[case]
    mine = sweep(tmp_path / "t", {"src/repro_torch/core/store.py": src},
                 rules=["rename-fsync"])
    ref = sweep(tmp_path / "j", {"src/repro/core/store.py": src},
                rules=["rename-fsync"], engine=jax_run_paths)
    for a, b in ((mine.findings, ref.findings),
                 (mine.suppressed, ref.suppressed)):
        assert [(f.rule, f.line) for f in a] == [(f.rule, f.line) for f in b]
    assert len(mine.findings) == (case == "wrong_rule")


def test_baseline_tolerates_and_reports_stale(tmp_path):
    files = {"src/repro_torch/core/store.py": _RENAME_BAD}
    first = sweep(tmp_path, files, rules=["rename-fsync"])
    assert len(first.findings) == 2
    keys = {f.key for f in first.findings}
    res = sweep(tmp_path, files, rules=["rename-fsync"],
                baseline=keys | {"rename-fsync:src/gone.py:1"})
    assert res.clean and len(res.baselined) == 2
    assert res.stale_baseline == ["rename-fsync:src/gone.py:1"]


def test_syntax_error_is_a_finding(tmp_path):
    res = sweep(tmp_path, {"src/repro_torch/core/broken.py": "def f(:\n"})
    assert [f.rule for f in res.findings] == ["parse-error"]


def _write_violation(root):
    p = root / "src" / "repro_torch" / "core" / "store.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("import os\n\ndef commit(a, b):\n    os.replace(a, b)\n")
    (root / "tests").mkdir(exist_ok=True)   # makes root the repo root
    return str(root / "src")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_cli_exit_codes_and_baseline_roundtrip(tmp_path, capsys, pkg):
    main = memlint_main if pkg == "torch" else jax_main
    src = _write_violation(tmp_path)
    assert main([src]) == 0                    # report-only mode
    assert main([src, "--strict"]) == 1        # strict gates
    out = capsys.readouterr().out
    assert "[rename-fsync]" in out and "1 finding(s)" in out
    base = str(tmp_path / "b.json")
    assert main([src, "--write-baseline", "--baseline", base]) == 0
    with open(base) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and len(doc["findings"]) == 1
    assert main([src, "--strict", "--baseline", base]) == 0
    assert main(["--list-rules"]) == 0
    assert "rename-fsync" in capsys.readouterr().out
    assert main([src, "--strict", "--rules", "topk-tiebreak"]) == 0


def test_cli_reads_its_own_baseline_and_never_the_reference_s(tmp_path):
    src = _write_violation(tmp_path)
    key = "rename-fsync:src/repro_torch/core/store.py:4"
    doc = {"findings": [key], "version": 1}
    (tmp_path / "memlint_baseline.json").write_text(json.dumps(doc))
    assert memlint_main([src, "--strict"]) == 1
    (tmp_path / "memlint_torch_baseline.json").write_text(json.dumps(doc))
    assert memlint_main([src, "--strict"]) == 0


# ---------------------------------------------------------------------------
# the real port tree is clean — with the port's EMPTY baseline
# ---------------------------------------------------------------------------
def test_port_sweeps_clean_with_its_empty_baseline(capsys):
    with open(os.path.join(REPO, "memlint_torch_baseline.json")) as fh:
        base = json.load(fh)
    assert base == {"findings": [], "version": 1}
    port = os.path.join(REPO, "src", "repro_torch")
    res = run_paths([port], repo_root=REPO, baseline=set(base["findings"]))
    assert res.clean, "\n".join(f.render() for f in res.findings)
    assert res.files_swept > 70
    assert memlint_main([port, "--strict"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out

    # every inline suppression in the port carries a justification comment
    # (the suppressing line or the two above it say WHY, not just ignore)
    assert res.suppressed
    for f in res.suppressed:
        with open(os.path.join(REPO, f.path)) as fh:
            src = fh.read().splitlines()
        window = " ".join(src[max(0, f.line - 3): f.line])
        stripped = window.replace(f"memlint: ignore[{f.rule}]", "")
        assert len([w for w in stripped.split() if w.isalpha()]) >= 3, \
            f"suppression without justification at {f.path}:{f.line}"


# ---------------------------------------------------------------------------
# lockcheck: the reference's cases on both packages' modules
# ---------------------------------------------------------------------------
LOCKCHECKS = pytest.mark.parametrize(
    "lc", [torch_lockcheck, jax_lockcheck], ids=["torch", "jax"])
_SCHEDULES = {
    "consistent": [(t, op, n) for t in range(4) for op, n in (
        ("acquire", "A"), ("acquire", "B"), ("acquire", "C"),
        ("release", "C"), ("release", "B"), ("release", "A"))],
    "abba": [(1, "acquire", "A"), (1, "acquire", "B"), (1, "release", "B"),
             (1, "release", "A"), (2, "acquire", "B"), (2, "acquire", "A"),
             (2, "release", "A"), (2, "release", "B")],
    "rotation": [(1, "acquire", "A"), (1, "acquire", "B"),
                 (1, "release", "B"), (1, "release", "A"),
                 (2, "acquire", "B"), (2, "acquire", "C"),
                 (2, "release", "C"), (2, "release", "B"),
                 (3, "acquire", "C"), (3, "acquire", "A"),
                 (3, "release", "A"), (3, "release", "C")],
}
_CYCLES = {"consistent": [], "abba": [["A", "B", "A"]],
           "rotation": [["A", "B", "C", "A"]]}


@LOCKCHECKS
@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedule_cycles(lc, name):
    assert lc.check_schedule(_SCHEDULES[name]) == _CYCLES[name]


@LOCKCHECKS
def test_reentrant_reacquire_adds_no_edge(lc):
    g = lc.LockOrderGraph()
    g.on_acquire("A", thread=1)
    g.on_acquire("A", thread=1)
    g.on_acquire("B", thread=1)
    assert ("A", "A") not in g.edges and g.edges[("A", "B")] == 1
    g.on_release("B", thread=1)
    g.on_release("A", thread=1)
    g.on_release("A", thread=1)
    assert g.held_by(1) == ()


@LOCKCHECKS
def test_assert_acyclic_raises_with_cycle_text(lc):
    g = lc.LockOrderGraph()
    g.on_acquire("plane", thread=1)
    g.on_acquire("residency", thread=1)
    g.on_acquire("residency", thread=2)
    g.on_acquire("plane", thread=2)
    with pytest.raises(lc.LockOrderViolation, match="plane -> residency"):
        g.assert_acyclic()


@LOCKCHECKS
def test_checked_lock_real_threads_opposite_order(lc):
    g = lc.LockOrderGraph()
    A, B = lc.CheckedLock("A", g), lc.CheckedLock("B", g)

    def forward():
        with A:
            with B:
                pass

    def backward():
        with B:
            with A:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert ["A", "B", "A"] in g.cycles()
    with pytest.raises(lc.LockOrderViolation):
        g.assert_acyclic()


@LOCKCHECKS
def test_blocking_call_watch_records_lock_held_fsync_and_sleep(lc, tmp_path):
    g = lc.LockOrderGraph()
    L = lc.CheckedLock("L", g)
    fd = os.open(str(tmp_path / "f"), os.O_CREAT | os.O_WRONLY)
    try:
        with lc.BlockingCallWatch(g):
            os.fsync(fd)                  # no lock held: not recorded
            with L:
                os.fsync(fd)
                time.sleep(0)
    finally:
        os.close(fd)
    assert g.blocking_calls == [(("L",), "os.fsync"), (("L",), "time.sleep")]
    with L:
        time.sleep(0)                     # patching is undone on exit
    assert len(g.blocking_calls) == 2


@LOCKCHECKS
def test_instrument_swaps_component_lock(lc):
    class Component:
        def __init__(self):
            self.lock = threading.RLock()

    g = lc.LockOrderGraph()
    c = Component()
    wrapped = lc.instrument(c, g, "component")
    assert c.lock is wrapped
    with c.lock:
        assert g.held_by() == ("component",)
    with pytest.raises(AttributeError):
        lc.instrument(object(), g, "x")


@LOCKCHECKS
def test_inverted_acquisition_fixture_is_detected(lc):
    g = lc.LockOrderGraph()
    plane_lock = lc.CheckedLock("plane", g)
    residency_lock = lc.CheckedLock("residency", g)

    def worker(first, second):
        for _ in range(5):
            with first:
                with second:
                    pass

    for args in ((plane_lock, residency_lock), (residency_lock, plane_lock)):
        t = threading.Thread(target=worker, args=args)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with pytest.raises(lc.LockOrderViolation, match="plane -> residency"):
        g.assert_acyclic()
    assert ["plane", "residency", "plane"] in g.cycles()


def _random_schedule(rng):
    """``tests/test_lockcheck.py``'s property schedule: threads acquiring
    lock subsets in ascending order, with a rogue ABBA pair planted or not."""
    n_threads, n_locks = rng.randint(1, 4), rng.randint(2, 6)
    picks = [rng.randint(0, 23) for _ in range(rng.randint(2, 24))]
    names = [f"L{i}" for i in range(n_locks)]
    sched = []
    for t in range(n_threads):
        subset = sorted({names[p % n_locks] for p in picks[t::n_threads]})
        sched += [(t, "acquire", n) for n in subset]
        sched += [(t, "release", n) for n in reversed(subset)]
    if rng.random() < 0.5:
        a, b = "L0", f"L{n_locks - 1}"
        sched += [("rogue1", "acquire", a), ("rogue1", "acquire", b),
                  ("rogue1", "release", b), ("rogue1", "release", a),
                  ("rogue2", "acquire", b), ("rogue2", "acquire", a),
                  ("rogue2", "release", a), ("rogue2", "release", b)]
    return sched


def test_both_lockchecks_find_the_same_cycles_on_random_schedules():
    rng = random.Random(21)
    planted = 0
    for _ in range(200):
        sched = _random_schedule(rng)
        mine = torch_lockcheck.check_schedule(sched)
        assert mine == jax_lockcheck.check_schedule(sched)
        planted += bool(mine)
    assert 50 < planted < 150


# ---------------------------------------------------------------------------
# the port's serve stack under the port's own lockcheck
# ---------------------------------------------------------------------------
def test_port_serve_stack_lock_graph_is_acyclic(tmp_path):
    """The port's engine traffic with ``tenant=`` on the caller thread, its
    plane's background worker, and evictions from a third thread, on locks
    ``repro_torch.analysis.lockcheck`` instruments: the graph is acyclic
    with no (residency, plane) edge, and the only blocking calls under a
    lock are the sanctioned fsyncs."""
    torch = pytest.importorskip("torch")
    from repro_torch import MemForestConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.maintenance_plane import MaintenancePlane
    from repro_torch.core.residency import ResidencyConfig, ResidencyManager
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    lc = torch_lockcheck
    wl = make_workload(num_entities=4, num_sessions=8,
                       transitions_per_entity=2, num_queries=6, seed=23)
    mgr = ResidencyManager(str(tmp_path / "tenants"),
                           config=ResidencyConfig(hot_budget=2,
                                                  digest_threshold=0.35),
                           mem_config=MemForestConfig(), device="cpu")
    mgr.ingest("t0", wl.sessions[:2], idempotency_key="seed")
    plane = MaintenancePlane(mgr.acquire("t0").forest, flush_trees_per_unit=2,
                             residency=mgr)
    g = lc.LockOrderGraph()
    lc.instrument(plane, g, "plane")
    lc.instrument(mgr, g, "residency")
    cfg = get_smoke_config("llama3_8b").replace(dtype="float32",
                                                param_dtype="float32")
    model = get_model(cfg)
    eng = ServeEngine(model, model.init(0, device="cpu"), max_batch=2,
                      max_len=32, residency=mgr, maintenance=plane,
                      maintenance_budget=2)
    old = sys.getswitchinterval(), torch.get_num_threads()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-5)
    errors = []
    try:
        with lc.BlockingCallWatch(g):
            plane.start_background(interval_s=0.001, budget_per_wake=2)

            def evictor():
                try:
                    for i in range(12):
                        mgr.ingest(f"ev{i % 3}",
                                   [wl.sessions[i % len(wl.sessions)]],
                                   idempotency_key=f"ev:{i}")
                        mgr.enforce_budget(4)
                except Exception as e:      # reported below
                    errors.append(e)

            ev = threading.Thread(target=evictor)
            ev.start()
            try:
                for s in wl.sessions:
                    eng.submit_session(s, tenant="t0")
                rids = [eng.submit_query(q, tenant="t0") for q in wl.queries]
                eng.submit([5, 6, 7], max_new_tokens=2)
                eng.run_until_drained()
                results = [eng.pop_query_result(r) for r in rids]
            finally:
                ev.join(timeout=120)
                plane.stop_background(drain_first=True)
    finally:
        sys.setswitchinterval(old[0])
        torch.set_num_threads(old[1])
    assert not ev.is_alive() and not errors, errors
    assert all(r is not None for r in results)
    mgr.close()
    held = {n for e in g.edges for n in e} | \
        {n for h, _ in g.blocking_calls for n in h}
    assert "residency" in held
    g.assert_acyclic()
    assert ("residency", "plane") not in g.edges
    allowed = {(("residency",), "os.fsync"),
               (("plane", "residency"), "os.fsync")}
    assert set(g.blocking_calls) <= allowed, set(g.blocking_calls) - allowed
