"""Package boundary of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package nor msgpack (the port has its own codec), and
nothing hides a missing card."""
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
    return top in ("jax", "jaxlib", "repro", "msgpack")


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core.memforest, "
            "repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.serving.engine, repro_torch.models, "
            "repro_torch.configs.llama3_8b, repro_torch.data.tokenizer, "
            "repro_torch.models.zamba2, repro_torch.models.rwkv6, "
            "repro_torch.models.mamba2, repro_torch.models.layers, "
            "repro_torch.configs.zamba2_7b, repro_torch.configs.rwkv6_1b6, "
            "repro_torch.core.journal, repro_torch.core.maintenance_plane, "
            "repro_torch.core.persistence, repro_torch.core.codec, "
            "repro_torch.compression, repro_torch.runtime.checkpoint, "
            "repro_torch.runtime.fault_tolerance, "
            "repro_torch.core.residency, repro_torch.core.baselines, "
            "repro_torch.core.baselines.base, repro_torch.models.whisper, "
            "repro_torch.configs.olmoe_1b_7b, repro_torch.configs.pixtral_12b, "
            "repro_torch.configs.whisper_base, "
            "repro_torch.configs.qwen3_moe_235b, repro_torch.configs.shapes, "
            "repro_torch.analysis, repro_torch.analysis.__main__, "
            "repro_torch.analysis.lockcheck, repro_torch.launch.roofline, "
            "repro_torch.launch.train, repro_torch.training, "
            "repro_torch.training.optimizer, "
            "repro_torch.training.grad_compress, "
            "repro_torch.training.train_loop, repro_torch.data.pipeline, "
            "repro_torch.tree, repro_torch.kernels.flash_attention, "
            "repro_torch.launch.mesh, repro_torch.kernels.shard_ops, "
            "repro_torch.launch.sharding, repro_torch.launch.spmd, "
            "repro_torch.launch.dryrun, repro_torch.launch.collectives, "
            "repro_torch.launch.memory, repro_torch.launch.attribution, "
            "repro_torch.launch.report, repro_torch.kernels.costs, "
            "repro_torch.launch.serve, repro_torch.examples, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.serve_memforest, "
            "repro_torch.examples.migration_merge, "
            "repro_torch.examples.train_lm; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')); print(bad); "
            "sys.exit(1 if bad else 0)")
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


def test_dryrun_keeps_its_own_shapes():
    """The port's ``launch/dryrun.py`` imports neither JAX nor the JAX
    package, not even ``repro.configs.shapes`` (the port keeps its own copy,
    ``repro_torch.configs.shapes``), which the reference's dry run reads."""
    path = os.path.join(PORT, "launch", "dryrun.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}:{node.lineno} relative import"
            names.add(node.module or "")
    assert not [n for n in names if _forbidden(n)], sorted(names)
    assert "repro_torch.config" in names
    from repro_torch.configs import shapes
    from repro_torch.launch import dryrun
    code = ("import sys, repro_torch.launch.dryrun as d; "
            "d.build_cell; bad = sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert shapes.SHAPES["decode_32k"].seq_len == 32768
    assert dryrun.ShapeConfig is shapes.ShapeConfig


@pytest.mark.parametrize("module", ["dryrun", "collectives", "memory",
                                    "attribution", "report"])
def test_the_dry_run_modules_import_neither_jax_nor_repro(module):
    """The dry run's modules, run as ``python -m``, load neither JAX nor the
    JAX package, not even the reference's dry run they port."""
    code = (f"import sys, runpy; sys.argv = ['x', '--help']\n"
            f"try:\n    runpy.run_module('repro_torch.launch.{module}', "
            "run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


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

