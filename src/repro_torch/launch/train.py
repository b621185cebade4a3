"""End-to-end training driver with checkpoint/restart and straggler
accounting, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --steps 200 --batch 8 --seq 128 [--device cpu]

Counterpart of the JAX package's ``launch/train.py``, with the same flags
and ``--device`` (default: the CUDA card; ``cpu`` runs the plain versions of
the kernels). ``--smoke`` (the default) selects the reduced config,
``--full`` the published one. ``--resume`` restores the newest checkpoint of
``--ckpt-dir`` and carries on from its step; the batches come from
``TokenPipeline.batch_at(step)``, so a resumed run sees the batches an
uninterrupted one would. The dense, MoE, VLM, ``hybrid`` (zamba2) and
``ssm`` (rwkv6) families train on token batches (the scans take ``--seq``
of at most 64 or a multiple of 64); whisper needs frames, which this
entry point does not make, as the reference's does not.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.fault_tolerance import StragglerMitigator
from repro_torch.training.train_loop import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 5),
        microbatch_size=args.microbatch,
        grad_compression=args.grad_compression,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir,
    )
    print(f"arch={cfg.name} params≈{cfg.param_count():,} device={dev}")

    state = init_train_state(model, tcfg, tcfg.seed, device=dev)
    start_step = 0
    if args.resume:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ckpt.restore(args.ckpt_dir, state)
            start_step = extra.get("step", latest)
            print(f"resumed from step {start_step}")

    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=tcfg.seed)
    mitigator = StragglerMitigator()

    t_start = time.perf_counter()
    tokens_done = 0
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dur = time.perf_counter() - t0
        mitigator.check(step, "local", dur)
        tokens_done += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            tps = tokens_done / (time.perf_counter() - t_start)
            print(f"step {step:5d} loss {loss:7.4f} lr "
                  f"{float(metrics['lr']):.2e} gnorm "
                  f"{float(metrics['grad_norm']):6.2f} {dur * 1e3:6.1f}ms "
                  f"{tps:,.0f} tok/s", flush=True)
        if (step + 1) % tcfg.checkpoint_every == 0:
            path = ckpt.save(args.ckpt_dir, step + 1, state,
                             extra={"step": step + 1, "arch": cfg.name})
            print(f"  checkpoint -> {path}")
    if mitigator.events:
        print(f"straggler events: {len(mitigator.events)}")
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
