"""Aggregate the port's dry-run artifacts into a roofline table.

    PYTHONPATH=src python -m repro_torch.launch.report artifacts/dryrun_torch [--mesh single]

Counterpart of the JAX package's ``launch/report.py``, over the JSON that
``repro_torch.launch.dryrun`` writes. The reference corrects its figures
for XLA:CPU's bf16 legalisation (``BF16_WIRE_CORRECTION``) and states MFU
against a TPU's peak (``mfu_tpu``); the port counts its tensors' own bytes
on the H100 SXM's peaks (``launch.roofline``), so neither is kept: the
columns are the roofline terms as the dry run computed them.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

ARCH_ORDER = [
    "whisper_base", "rwkv6_1b6", "zamba2_7b", "qwen3_moe_235b", "olmoe_1b_7b",
    "starcoder2_7b", "phi3_mini", "llama3_8b", "granite_3_8b", "pixtral_12b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: str) -> List[Dict]:
    rows = []
    for f in sorted(os.listdir(out_dir)):
        if f.endswith(".json"):
            with open(os.path.join(out_dir, f)) as fh:
                rows.append(json.load(fh))
    return rows


def fmt_ms(s: float) -> str:
    return f"{s * 1e3:.2f}"


def table(rows: List[Dict], mesh: str, md: bool = True) -> str:
    """One row a cell of ``mesh`` ("single", "multi", or with a tag), in
    the reference's arch and shape order: the trace's seconds, the peak GB
    of the fullest position, the three roofline terms in ms, the dominant
    one, ``useful_ratio`` (model over counted operations) and
    ``roofline_mfu``."""
    out = ["| arch | shape | trace_s | peak GB/dev | compute ms | memory ms | "
           "collective ms | dominant | useful_ratio | roofline_mfu |",
           "|" + "---|" * 10]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = next((x for x in rows if x["arch"] == arch
                      and x["shape"] == shape and x["mesh"] == mesh), None)
            if r is None:
                continue
            if r.get("skipped"):
                out.append(f"| {arch} | {shape} | — | — | — | — | — | "
                           "SKIP (full-attn) | — | — |")
                continue
            if not r.get("ok"):
                out.append(f"| {arch} | {shape} | FAIL | | | | | | | |")
                continue
            t = r["roofline"]
            out.append(
                f"| {arch} | {shape} | {r['trace_s']:.1f} | "
                f"{r['memory']['peak_gb']:.2f} | {fmt_ms(t['compute_s'])} | "
                f"{fmt_ms(t['memory_s'])} | {fmt_ms(t['collective_s'])} | "
                f"{t['dominant']} | {t['useful_ratio']:.2f} | "
                f"{t['roofline_mfu'] * 100:.1f}% |")
    return "\n".join(out)


def summary(rows: List[Dict]) -> str:
    ok = sum(1 for r in rows if r.get("ok") and not r.get("skipped"))
    skip = sum(1 for r in rows if r.get("skipped"))
    fail = sum(1 for r in rows if not r.get("ok"))
    expanded = sum(1 for r in rows
                   if r.get("depth", {}).get("mode") == "expanded")
    return (f"cells: {ok} traced ({expanded} depth-expanded), {skip} "
            f"skipped (documented), {fail} failed")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rows = load(args.out_dir)
    print(summary(rows))
    print()
    print(table(rows, args.mesh))


if __name__ == "__main__":
    main()
