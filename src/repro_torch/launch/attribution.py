"""Per-site collective attribution of a cell's step.

    PYTHONPATH=src python -m repro_torch.launch.attribution --arch llama3_8b \\
        --shape train_4k [--mesh-shape 64x4] [--microbatch 64] [--kv-replicate]
    PYTHONPATH=src python -m repro_torch.launch.attribution --arch llama3_8b \\
        --shape train_4k --mesh-shape 2x4 --smoke --device cpu

Counterpart of the JAX package's ``launch/attribution.py``, which ranks the
collectives of compiled HLO by their trip-count-expanded bytes with their
shapes and op names. The port has no HLO: each collective records itself
where it runs, with its site (``launch.collectives``), and the dry run
(``dryrun.run_cell``) keeps each site's bytes and calls at the position
whose collectives carry the most, depth-expanded as the cell is. This
prints the top sites, one line a row.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Tuple

Row = Tuple[float, str, int, List[str], str]


def attribute(counts: Dict[str, Any], top: Optional[int] = 15) -> List[Row]:
    """Rows of (bytes, kind, calls, shapes, site) of ``counts``, a
    ``dryrun.run_cell`` result or its JSON (its ``collective_sites``),
    sorted as the reference sorts its own: the tuples in descending order,
    the most bytes first. ``top`` rows, or all with None."""
    rows = [(float(b), kind, int(calls), list(shapes), site)
            for b, kind, calls, shapes, site in counts["collective_sites"]]
    rows.sort(reverse=True)
    return rows if top is None else rows[:top]


def main(argv: Optional[List[str]] = None) -> None:
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh-shape", default=None)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--kv-replicate", action="store_true")
    ap.add_argument("--serving-ep", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config at the smoke sweep's shape")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.smoke:
        cfg, shape, mesh = dryrun.smoke_cell(
            args.arch, args.shape, "multi" if args.multi_pod else "single",
            args.device)
    else:
        cfg, shape = get_config(args.arch), SHAPES[args.shape]
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    devices=dryrun.fake_device(args.device))
    if args.serving_ep:
        cfg = cfg.replace(moe_fsdp_params=False)
    if args.mesh_shape:
        dims = tuple(int(x) for x in args.mesh_shape.split("x"))
        mesh = make_mesh(dims, ("data", "model"),
                         dryrun.fake_device(args.device))
    r = dryrun.run_cell(args.arch, args.shape, "single", cfg_override=cfg,
                        shape_override=shape, mesh_override=mesh,
                        tcfg=TrainConfig(microbatch_size=args.microbatch),
                        kv_replicate=args.kv_replicate, device=args.device)
    if not r["ok"]:
        raise SystemExit(r["error"] + "\n" + r.get("traceback", ""))
    if r.get("skipped"):
        raise SystemExit(f"skipped: {r['skipped']}")
    print(f"position {r['collective_position']} of mesh {r['mesh_shape']}, "
          f"{r['depth']['mode']}; total {r['collectives']['total'] / 1e9:.6f}"
          " GB a step")
    for b, kind, calls, shapes, site in attribute(r, args.top):
        print(f"{b / 1e9:12.6f}GB  {kind:18s} x{calls:<5d} {shapes}  {site}")


if __name__ == "__main__":
    main()
