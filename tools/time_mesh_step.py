#!/usr/bin/env python3
"""Time whisper-base's ZeRO-1 train step and its decode step on a model mesh,
with the ``repro_torch`` package of a given source tree, on one card.

    python3 tools/time_mesh_step.py [--src DIR] [--label NAME] [--seed 0]

``--src`` names a tree whose ``src/`` holds the package (default: this
checkout), so that two versions of the host code compare by running the tool
once for each, in turns (A, B, B, A). Everything goes through the entry
points: ``make_train_step`` and ``Model.prefill``/``.decode`` under
``activate_mesh``. whisper-base at its published width and depth, bf16 with
remat, on (2, 2) and (1, 16) repeating the card, as ``chip_smoke.py``'s
``sharded_whisper`` phase: after one warm-up step, each mesh takes 3 train
steps of 8 x 448 tokens beside 8 x 1500 frames from a state made from the
seed (the median of the last two) and serves a prefill of 8 x 16 tokens and
8 greedy steps (the median of steps 2-8). Prints a line a mesh and the
card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(1, str(ROOT))

    import torch
    if not torch.cuda.is_available():
        print("time_mesh_step: no CUDA device is visible", file=sys.stderr)
        return 2

    import chip_smoke as c
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import param_shardings, place_tree
    from repro_torch.models import get_model, make_batch
    from repro_torch.training.train_loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    print(c.card_line(), flush=True)
    cfg = get_config("whisper_base")
    model = get_model(cfg)
    params = model.init(args.seed, device="cuda")
    batches = [make_batch(cfg, "train", c.TRAIN_BATCH, c.WHISPER_SEQ,
                          args.seed + i, device="cuda") for i in range(3)]
    prompt = make_batch(cfg, "prefill", c.DECODE_PROMPTS, c.WHISPER_PROMPT,
                        args.seed, device="cuda")
    step = make_train_step(model, TrainConfig(learning_rate=3e-4,
                                              warmup_steps=2, total_steps=3))
    mesh = make_mesh((2, 2), ("data", "model"), "cuda:0")
    state = c.sharded_state(torch, model, mesh, args.seed)
    with activate_mesh(mesh):
        step(state, batches[0])          # warm up the autograd and remat paths
    del state
    for shape in ((2, 2), (1, 16)):
        mesh = make_mesh(shape, ("data", "model"), "cuda:0")
        state = c.sharded_state(torch, model, mesh, args.seed)
        ms, losses = [], []
        for b in batches:
            c.sync_all(torch, mesh)
            t0 = time.perf_counter()
            with activate_mesh(mesh):
                state, m = step(state, b)
            c.sync_all(torch, mesh)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        del state
        placed = place_tree(params, mesh, param_shardings(mesh, params))
        _, _, _, prefill_s, step_s = c.serve_tokens(
            torch, model, placed, prompt, c.WHISPER_MAX_LEN, 8, mesh)
        del placed
        torch.cuda.empty_cache()
        print(f"time_mesh_step: {args.label} mesh {shape} train step_ms="
              + ",".join(f"{x:.2f}" for x in ms)
              + f" median_of_last_two={statistics.median(ms[1:]):.2f} "
              "losses=" + ",".join(f"{x:.5f}" for x in losses)
              + f" prefill_s={prefill_s:.4f} decode median_step_ms="
              f"{statistics.median(step_s[1:]) * 1e3:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
