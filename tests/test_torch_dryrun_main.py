"""The port's dry run through its entry points on the CPU: ``run_cell``,
``main``, ``attribution`` and ``report`` over the smoke cells.

Positions are fake ``cpu`` tensors (``--device cpu``), which take the
kernels' plain versions; the cells are the reference's ``--smoke`` cells.
The rest of the dry run's checks are in ``tests/test_torch_dryrun.py``.
Checked:

- (d) ``run_cell`` and ``main(["--smoke", ...])`` for four families' train
  cell on (2, 4) (zamba2-7b's, the fifth, is in
  ``tests/test_torch_dryrun.py``) and llama3-8b's decode on (2, 2, 2), with
  ``hlo_flops_total`` > 0, as ``tests/test_dryrun_smoke.py`` holds the
  reference's; a skipped cell with the reference's reason; a failure as
  data and ``main``'s exit;
- (e) ``attribution.attribute`` summing to the collectives' total in bytes
  and calls, its ``main`` printing the top sites, and ``report.table`` and
  ``summary`` over the dumped JSON.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import TrainConfig
from repro_torch.launch import attribution, dryrun, report

# zamba2-7b's train cell runs through main in tests/test_torch_dryrun.py,
# which keeps each file under a minute on one process
TRAIN_ARCHS = ("llama3_8b", "olmoe_1b_7b", "rwkv6_1b6", "whisper_base")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The lockstep runs many small ops a position: one intra-op thread
    keeps them off the thread pool, which several test workers on one
    host would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (d)-(e) run_cell, main, attribution, report
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    for arch in TRAIN_ARCHS:
        dryrun.main(["--smoke", "--device", "cpu", "--arch", arch, "--shape",
                     "train_4k", "--mesh", "single", "--out", str(out)])
    dryrun.main(["--smoke", "--device", "cpu", "--arch", "llama3_8b",
                 "--shape", "decode_32k", "--mesh", "multi", "--out",
                 str(out)])
    return out


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_smoke_train_cells_through_main(smoke_dir, arch):
    with open(smoke_dir / f"{arch}__train_4k__single.json") as fh:
        data = json.load(fh)
    assert data["ok"], data.get("traceback")
    assert data["mesh_shape"] == [2, 4] and data["device"] == "cpu"
    assert data["roofline"]["hlo_flops_total"] > 0
    assert data["cost_analysis_raw"]["flops"] > 0
    assert data["memory"]["peak_gb"] >= data["memory"]["argument_gb"] > 0
    assert data["collectives"]["total"] > 0 and data["trace_s"] > 0
    assert data["depth"]["mode"] == "whole"
    kernel = {"rwkv6_1b6": "rwkv6_scan", "zamba2_7b": "mamba2_ssd"}.get(
        arch, "flash_attention")
    assert data["kernels"][kernel]["calls_per_position"] > 0


def test_smoke_decode_cell_on_the_multi_pod_mesh(smoke_dir):
    with open(smoke_dir / "llama3_8b__decode_32k__multi.json") as fh:
        data = json.load(fh)
    assert data["ok"] and data["mesh_shape"] == [2, 2, 2]
    assert data["roofline"]["hlo_flops_total"] > 0
    assert data["kernels"]["decode_attention"]["calls_per_position"] == 2


def test_run_cell_skips_as_the_reference_does(tmp_path):
    cfg, shape, mesh = dryrun.smoke_cell("llama3_8b", "long_500k", "single",
                                         "cpu")
    r = dryrun.run_cell("llama3_8b", "long_500k", "single", out_dir=str(
        tmp_path), cfg_override=cfg, shape_override=shape,
        mesh_override=mesh, device="cpu")
    assert r["ok"] and r["skipped"].startswith("full-attention arch")
    assert os.path.exists(tmp_path / "llama3_8b__long_500k__single.json")


def test_a_failure_is_data(tmp_path):
    cfg, shape, mesh = dryrun.smoke_cell("llama3_8b", "train_4k", "single",
                                         "cpu")
    bad = TrainConfig(microbatch_size=3)     # does not divide the batch of 4
    r = dryrun.run_cell("llama3_8b", "train_4k", "single", tcfg=bad,
                        out_dir=str(tmp_path), cfg_override=cfg,
                        shape_override=shape, mesh_override=mesh,
                        device="cpu")
    assert not r["ok"] and "microbatch_size 3" in r["error"]
    assert "Traceback" in r["traceback"]
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--smoke", "--device", "cpu", "--arch", "llama3_8b",
                     "--shape", "train_4k", "--mesh", "single",
                     "--microbatch", "3", "--out", str(tmp_path)])


def test_attribution_and_report(smoke_dir, capsys):
    rows = report.load(str(smoke_dir))
    for data in rows:
        got = attribution.attribute(data, top=None)
        assert sum(r[0] for r in got) == data["collectives"]["total"]
        assert sum(r[2] for r in got) == data["collectives"][
            "num_collectives"]
        assert got == sorted(got, reverse=True)
        assert len(attribution.attribute(data, top=3)) == min(3, len(got))
    assert report.summary(rows) == ("cells: 5 traced (0 depth-expanded), 0 "
                                    "skipped (documented), 0 failed")
    table = report.table(rows, "single").splitlines()
    assert table[0].startswith("| arch | shape | trace_s | peak GB/dev |")
    assert len(table) == 2 + len(TRAIN_ARCHS)
    assert report.table(rows, "multi").count("| llama3_8b | decode_32k |") \
        == 1
    report.main([str(smoke_dir)])
    assert "cells: 5 traced" in capsys.readouterr().out


def test_attribution_main_prints_the_top_sites(capsys):
    attribution.main(["--arch", "llama3_8b", "--shape", "train_4k",
                      "--mesh-shape", "2x4", "--smoke", "--device", "cpu",
                      "--top", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("position ") and len(lines) == 5
    assert all("GB" in ln for ln in lines[1:])
