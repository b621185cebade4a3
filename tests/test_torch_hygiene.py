"""Package boundary of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and nothing hides a missing card."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch
from repro_torch.device import resolve_device

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core.memforest, "
            "repro_torch.convert, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.MemForestSystem()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_cpu_is_taken_only_when_asked():
    assert resolve_device("cpu").type == "cpu"
    assert repro_torch.MemForestSystem(device="cpu").forest.device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_sources_ship_with_the_package():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        assert (_build.CSRC / name).is_file()
    assert len(_build.source_hash()) == 16


def test_every_entry_point_is_defined_in_its_source():
    from repro_torch.kernels import _build
    for entry in _build.SIGNATURES:
        src = _build.CSRC / (entry.removeprefix("memforest_") + ".cu")
        assert src.name in _build.SOURCES
        assert f'extern "C" int {entry}(' in src.read_text()


def test_per_node_flush_ablation_is_refused():
    from repro_torch.config import MemForestConfig
    with pytest.raises(NotImplementedError, match="level_parallel"):
        repro_torch.MemForestSystem(MemForestConfig(level_parallel=False),
                                    device="cpu")
