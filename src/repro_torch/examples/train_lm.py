"""Train a reduced LM for a few hundred steps, with checkpointing and
restart (the training substrate end-to-end).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

Counterpart of the repository's ``examples/train_lm.py``, on the CUDA card
by default.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import make_workload
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.training.train_loop import init_train_state, make_train_step


def main(argv=None) -> list:
    """Returns the losses of the steps it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                       warmup_steps=10, microbatch_size=2)
    print(f"training {cfg.name}: {cfg.param_count():,} params, {args.steps} steps")

    # corpus: the synthetic session stream's text (what the memory system stores)
    wl = make_workload(num_entities=8, num_sessions=20, num_queries=1, seed=0)
    corpus = [t.text for s in wl.sessions for t in s.turns]
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                         corpus=corpus)

    state = init_train_state(model, tcfg, 0, device=dev)
    step_fn = make_train_step(model, tcfg)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_train_")

    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            tps = (step + 1) * 8 * 64 / (time.perf_counter() - t0)
            print(f"step {step:4d}  loss {loss:7.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {tps:,.0f} tok/s")
        if (step + 1) % 100 == 0:
            ckpt.save(ckpt_dir, step + 1, state, extra={"step": step + 1})

    # restart check: restore and confirm training state round-trips
    latest = ckpt.latest_step(ckpt_dir)
    if latest:
        restored, extra = ckpt.restore(ckpt_dir, state)
        print(f"checkpoint restart OK at step {extra['step']}")
    print("done.")
    return losses


if __name__ == "__main__":
    main()
