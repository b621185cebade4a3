#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0]

Phases, each printed on its own line; any failed check exits nonzero:

  1. device   the card's name and power limit (nvidia-smi); compute
              capability 9.0 is required.
  2. build    nvcc builds the kernels from src/repro_torch/kernels/csrc.
  3. check    every kernel against its plain PyTorch version on the card, at
              the shapes the main paths give it and at stress and edge shapes,
              with the kernel's, the plain version's, the library call's and
              the bound's time in ms; two ``decode_attention`` calls must give
              equal bits, and one call must be one device launch, as must one
              bf16 call of ``mamba2_ssd`` and of ``rwkv6_scan``, one call of
              ``tree_refresh`` and of ``topk_sim`` at their main shapes (the
              baselines' one-query shape too), one call of each form of
              ``browse_scores``, ``flash_attention`` at whisper's encoder
              shape and ``decode_attention`` at olmoe's decode shape.
              ``browse_scores``' gather form is checked at the slice's, the
              serve phase's and the moe phase's level shapes from a node
              arena, with padded slots exactly 0 and one node in four slots
              bitwise equal. The bf16 scan outputs are
              held to a float64 run of the plain version
              (``bf16_scan_excess``), the draw of the ``mamba2_ssd`` stress
              row on which the earlier criterion failed a correct kernel
              included. ``flash_attention_bwd`` (``check_attention_bwd``)
              against ``attention_bwd_ref`` at ``BWD_ROWS``: phi3's and
              llama's training shapes, whisper's encoder, the smoke shape,
              S = 100, S = 1, head dims 20 and 72, a group of 128, with o and
              lse from the forward kernel (lse within ``LSE_TOL`` of
              ``attention_lse_ref``); f32 within 1e-4 of the largest |plain|,
              bf16 within one ulp of a float64 run plus ``BWD_TC_EXCESS``;
              two calls bitwise equal, one call two device launches.
              ``mamba2_ssd_bwd`` and ``rwkv6_scan_bwd`` (``check_scan_bwd``)
              against their plain versions run in float64 at
              ``SCAN_BWD_ROWS``: zamba2's and rwkv6's training shapes (bf16),
              train_parity's smoke shapes (f32), one ragged chunk of 40 with
              dims 20 and 72, rwkv6 at K = V = 128 in bf16 and in f32
              (working sets in global scratch; the f32 forward's state in
              global memory there), rwkv6's strong and slow decays; nonzero
              initial states and final-state cotangents,
              the chunk states from the forward kernel's training launch
              (output equal to the inference launch's); each kind of output
              within ``SCAN_BWD_TOL`` (``scan_bwd_errors``); two calls
              bitwise equal, one call one launch of the kernel. ``rwkv6_scan``
              also in f32 at 2x128x4x128x128, where the kernel carries its
              state in global memory.
  4. slice    the memory system's path through ``repro_torch.MemForestSystem``
              with its hashing encoder: ``ingest_batch`` of 500 sessions (about
              20k turns, 13k tree nodes) in batches of 16, then ``query_batch``
              of 64 queries in each of the six browse modes. Launch counts are
              reset just before and read just after; every kernel of the path
              must have launched and no plain version may have run. The
              browse's spans are printed, and one browse level, replayed under
              the profiler, must copy at most F*K*8 + F*4 + 64 bytes to the
              card (no children, no query matrix) and launch one kernel. The
              same run on the CPU must give the same facts, trees, answers and
              evidence, and embeddings within 1e-5.
  4a. sharded the slice's memory served through ``DataMesh``es of shards on
              the card (``MemForestSystem.set_mesh``, ``kernels/shard_ops``):
              S = 2 on the 500 sessions, S = 4 on 64, 128 and 192 sessions,
              queried after each (the sharded fact index grows: no
              re-upload), and S = 2 and S = every card over distinct cards
              where more than one is visible; each held to the
              same sessions without a mesh (``compare_systems``, answers and
              evidence exact in the six modes, node embeddings and the root
              index bit for bit), with S ``topk_sim`` launches a fact recall
              plus 1 for the roots, S ``tree_refresh`` a flush level and S
              ``browse_scores`` a browse depth, and no plain version. One
              sharded browse level uploads one buffer per distinct device.
              ``topk_sim`` sharded at a shape where a shard's own plan would
              take another cluster than the whole index's equals the whole
              index's launch bit for bit. Then ``repro_torch.launch.serve``
              with the JAX package's default flags on the card and on the
              CPU: the same answers. In the serve phase, after its traffic,
              its llama3-8b memory (D = 4096) answers the queries again
              through a mesh of 2 shards, as it did without one. The
              phase's seconds are printed.
  4b. ablations  ``benchmarks/bench_tree_scaling.py``'s sweeps of the paper's
              Figure 6 on the card at D = 256, through the port's ``Forest``:
              (a) lazy flush against eager per-insert refresh at 64, 256 and
              1024 facts in one tree (summary refreshes, ``tree_refresh``
              launches, seconds; equal trees); (c) ``flush(level_parallel=
              True)`` against ``False`` at the same sizes (launches must
              equal ``kernel_calls``, embeddings within 1e-5); (d/e) the
              branching factor K = 3, 4, 8, 16, 32, 64 over 512 facts in 16
              trees, 128 queries through ``topk_sim`` over ``root_index()``
              (root recall, height), the flushes at K = 3, 32 and 64 held
              against the plain version (1e-5). The sweeps (c) and (d/e) on
              the CPU must give the same trees, counters, hits and heights.
              Then ``MemForestSystem(eager=True)`` against the lazy system on
              the slice's first 128 sessions: equal facts, trees, placement
              and answers in the six modes, embeddings within 1e-5; both
              systems' sessions/s, summary refreshes and launches printed.
  5. serve    the serve engine on llama3-8b at its published width and depth
              (bf16, random weights from a seeded generator on the card):
              ``ServeEngine(max_batch=8, max_len=512)`` whose memory is a
              ``MemForestSystem(embed_dim=4096)`` with a ``ModelEncoder`` on the
              same weights. The 500 sessions go through the ingest lane, the 64
              queries through the query lane, and 16 decode requests (two
              rounds of 8 identical prefix-keyed prompts, 32 new tokens each)
              through the decode lane. Launch counts are reset just before and
              read just after: all five kernels must have launched, no plain
              version may have run, the prefix cache must have been reused and
              every query answered. The browse's spans are printed. A profiled
              repeat gives the device's idle share.
  6. parity   the same engine traffic at llama3-8b's full width but depth 2,
              in float32, on a few sessions, on the card and on the CPU: equal
              decoded tokens, facts, trees and answers; embeddings within 1e-4.
  7. zamba2   the serve engine on zamba2-7b at its published width and depth
              (81 Mamba2 layers, the shared attention block after every 6;
              bf16, random weights from a seeded generator on the card):
              ``ServeEngine(max_batch=8, max_len=512)`` whose memory is a
              ``MemForestSystem`` with the hashing encoder at the paper's
              defaults. The same two rounds of traffic as phase 5, with 8
              prefix-keyed prompts of exactly 128 tokens (the scans take T <= 64
              or a multiple of 64). ``mamba2_ssd`` must launch at least 81
              times, the attention kernels once per application of the shared
              block, the forest kernels at all; no plain version may run.
  8. rwkv6    the same on rwkv6-1.6b (24 layers); ``rwkv6_scan`` must launch
              at least 24 times.
  9. ssm_parity  zamba2 at full width and 7 layers (one group and one
              remainder layer) and rwkv6 at full width and 2 layers, float32,
              a few sessions, on the card and on the CPU with the same
              weights: equal decoded tokens, facts, trees and answers; the
              final ssd / wkv state within 1e-4.
  10. durable MemForest's lifecycle on the card, on the slice's workload
              with the hashing encoder: a ``DurableMemForest`` (fsync on) with
              a ``MaintenancePlane`` on its worker thread. 500 sessions in
              journaled batches of 64 (one delivered twice: it applies once),
              the 64 queries in the six browse modes under the plane's lock, a
              checkpoint, 16 deletions, the compaction of every tree at least
              30% dead, and a journaled merge of a second seed's 64 sessions.
              Launch counts are reset before and read after: the three forest
              kernels must have launched, ``tree_refresh`` from the worker too.
              Then: the store reopened (snapshot + journal tail) gives the
              same digest and answers; the same run crashed in the journal
              tail and recovered by the client's retries gives them too; a
              crash sweep at 64 sessions kills the run at every durability
              event and every recovery reaches that size's digest; the run on
              the CPU (the plane drained after each step) gives the same
              facts, trees, placement and answers, embeddings within 1e-5;
              and a snapshot written on the card answers on the CPU as the
              card does, and the reverse.
  11. maintenance_lane  the engine's maintenance lane on rwkv6-1.6b (the rwkv6
              phase's weights): ``ServeEngine(maintenance=plane,
              maintenance_budget=2)`` and the rwkv6 phase's traffic. No ingest
              drain may flush; the lane must run; the decoded tokens, the
              memory's digest and its answers in the six modes must equal the
              rwkv6 phase's, which had no plane.
  12. baselines  MemForest and the paper's five baselines (``repro_torch.core.
              baselines``) at the paper's defaults with the hashing encoder:
              the 500 sessions one at a time through ``ingest_session``
              (``benchmarks/bench_write_path.py``'s loop), then the 64
              queries; per system sessions/s, encoder calls, sequential
              calls, tokens, mean dependency depth, facts written, queries/s,
              answers equal to gold and ``topk_sim`` launches. ``topk_sim``
              must launch for every system and no plain version may run;
              MemForest must answer at least as many as each baseline; the
              same run on the CPU must give the same fact texts and ids,
              write counts, answers and evidence. Then MemForest and EverMem
              on a ModelEncoder over the serve phase's llama3-8b weights, on
              16 sessions: ``flash_attention`` and ``topk_sim`` must launch,
              no plain version may run; the construction ratio is printed.
              (The serve phase's weights, drawn again from the same seed.)
  13. residency  32 tenants at a hot budget of 4, each a 50-session history
              ingested in journaled deliveries (fsync on), then a Zipf (s =
              1.5) schedule of 256 queries in events of 4, digest threshold
              0.45, through a ``ResidencyManager`` on the card and the same
              calls on the CPU (given the card encoder's outputs): every tier
              decision, answer, evidence and state digest equal. An explicit
              demotion must lower ``torch.cuda.memory_allocated`` by the
              tenant's ``device_bytes`` (within 512 bytes a tensor); a
              rehydration and one query must upload that tenant's rows only;
              a restarted manager holds every tenant cold with no device
              bytes. Then the engine's residency lane on the rwkv6 phase's
              weights, ``ServeEngine(residency=, residency_budget=1)``, with
              the tenants' sessions and queries beside the rwkv6 phase's
              decode traffic: at most 4 tenants hot after the drain, the lane
              run, the decoded tokens equal to the rwkv6 phase's,
              ``rwkv6_scan`` and the three forest kernels launched and no
              plain version run.
  14. moe     the serve engine on olmoe-1b-7b at its published width and
              depth (64 experts, top 8; bf16, random weights from a seeded
              generator on the card, 13.8 GB): ``ServeEngine(max_batch=8,
              max_len=512)`` whose memory is a ``MemForestSystem(embed_dim=
              2048)`` with a ``ModelEncoder`` on the same weights; the
              slice's first 128 sessions through the ingest lane, its 64
              queries through the query lane, and phase 5's two rounds of 8
              prefix-keyed prompts. All five kernels must launch and no plain
              version run; the prefix cache reused, every query answered, two
              encodes bitwise equal. Printed: sessions/s, decoded tokens/s,
              the ``ingest.extract`` span, the memory's index sizes, the
              (token, choice) pairs dropped past capacity in the encoder,
              the prefill and the decode step (counted in an untimed repeat
              of the traffic, so the timed run is the engine's own code),
              and the device's idle share from a profiled repeat.
  15. vlm     pixtral-12b at its published width and depth (bf16, 24.5 GB):
              ``prefill`` of 8 prompts of 128 tokens with 64 patch
              embeddings each (``models.make_batch``), then 32 greedy
              ``decode`` steps. ``flash_attention`` and ``decode_attention``
              must launch, no plain version run, and the cache's lengths be
              192 + 32. Printed: tokens/s.
  16. whisper whisper-base at its published width and depth (bf16): the
              encoder over 8 x 1500 frames (full attention), a 16-token
              prompt, 32 decode steps; the same checks.
  17. family_parity  card against CPU in float32 with the same weights:
              olmoe at full width and depth 2 through the engine's traffic
              on a few sessions (equal decoded tokens, facts, trees and
              answers, embeddings within 1e-4), each CPU MoE layer taking
              the card layer's input, its expert choices equal to the card's
              but for flips between probabilities within 1e-5 (float noise
              between the devices: printed, and held on the card's choice);
              pixtral at full width and depth 2 and whisper at full width and
              depth: equal greedy tokens, logits within 1e-4.
  18. train   training on phi3-mini-3.8b at its published width and depth
              (bf16, remat on, random weights from a seeded generator on the
              card): ``TokenPipeline(seq_len=512, global_batch=8)`` over the
              slice workload's turn texts, ``TrainConfig(learning_rate=3e-4,
              warmup_steps=2, total_steps=8)``, 8 steps through
              ``make_train_step``. Every loss and ``grad_norm`` finite; on the
              first step every parameter's gradient (the attention
              projections included) present, finite and nonzero somewhere;
              ``flash_attention`` launched 2 x 32 times a step (remat runs the
              forward twice), ``flash_attention_bwd`` 32 times, no plain
              attention. Printed: the losses, the median step ms, tokens/s,
              the peak device memory against the 45.85 GB of states, the
              phase's seconds, and over one profiled step the device's idle
              share and the attention kernels' share of its device time.
  19. train_zamba2  the same on zamba2-7b at published width, its depth cut
              from 81 to 36 layers (six groups of six, each followed by the
              shared block; 81 layers need about 81 GB of train states):
              ``mamba2_ssd`` launched 2 x 36 times a step (remat runs each
              Mamba2 layer's forward twice), ``mamba2_ssd_bwd`` 36 times,
              ``flash_attention`` and ``flash_attention_bwd`` 6 times (the
              shared block is not rematerialised, as in the reference);
              every parameter (``A_log``, ``dt_bias``, ``D_skip``,
              ``conv_w``, the projections) a finite nonzero gradient; the
              scans' share of the profiled step.
  20. train_rwkv6  the same on rwkv6-1.6b at its published width and depth:
              ``rwkv6_scan`` 2 x 24 times a step, ``rwkv6_scan_bwd`` 24.
  21. train_parity  float32, 3 steps each, card against CPU from one initial
              state: whisper-base at full width and depth (B = 2, decoder
              S = 32), llama3-8b's smoke config with ``microbatch_size=2``
              and top-k compression, olmoe-1b-7b's, zamba2-7b's and
              rwkv6-1.6b's smoke configs (the last two at S = 128, two
              chunks of their scans): losses and
              ``grad_norm`` within 1e-4 relative, parameters within
              ``TRAIN_PARAM_ATOL``. Then a ``FaultTolerantRunner`` on the
              card, failures injected at steps 2 and 3, restoring from
              ``checkpoint.save``: it ends within 1e-6 of an uninterrupted
              run (not bitwise: the embedding gather's backward adds with
              atomics on the card).
  22. sharded_train  tensor- and expert-parallel training with ZeRO-1 on a
              (data, model) = (2, 2) mesh (``launch.mesh``,
              ``training.train_loop.shard_train_state``, the step under
              ``activate_mesh``), bf16 with remat at B x S = 8 x 512:
              llama3-8b and olmoe-1b-7b at published width. With four
              cards visible or more the mesh is over the first four and
              both models run whole for 8 steps; on one card the mesh
              repeats it, llama3-8b cut to 2 layers and olmoe-1b-7b to 4,
              3 steps. Every loss finite, every parameter a finite nonzero
              gradient; per position and step ``flash_attention`` launches 2
              x layers times and ``flash_attention_bwd`` layers times; each
              card's peak memory, the step's ms and idle share. Then
              float32 at the smoke configs: the card's (2, 2) run equals the
              CPU's after 2 steps.
  23. sharded_serve  prefill and decode on a (data, model) mesh through
              the entry points (``get_model(cfg).prefill`` and ``.decode``
              under ``activate_mesh``; parameters placed by
              ``param_shardings``, the cache by ``launch.sharding.
              cache_shardings``): llama3-8b at published width cut to 2
              layers, bf16, on a (2, 2) mesh repeating the card (the heads
              form) and on (1, 16), the production model width (the
              sequence form: 256 rows a position, merged by
              ``decode_attention_lse``'s log-sum-exp), then olmoe-1b-7b at 4
              layers on (2, 2) (the MoE's data-shard branch, in bf16 and
              in float32, no choice dropped: see SHARDED_SERVE); prefill of
              8 x 512 tokens into a 4096-row cache, 32 greedy steps. Each
              run is held to the same weights unsharded on the card (the
              logits' largest gap within 5e-2 of their largest magnitude, the
              greedy token equal wherever the unsharded top-two margin
              exceeds the gap; in the bf16 MoE run, over the tokens whose
              experts both runs chose alike); ``flash_attention`` launched layers x positions times a
              prefill, ``decode_attention`` layers x positions x steps. Then
              the smoke configs in float32, card mesh against CPU mesh,
              within 1e-4. With four cards or more instead: llama3-8b whole
              on (2, 2) over the first four, decode_32k at batch 24 (prompts
              of 32704 tokens, 64 steps): step ms, tokens/s, peak GB a card,
              the idle share and the ``roofline:`` line; rows 0-1 held to one
              card's unsharded run.
  24. sharded_ssm  rwkv6 and zamba2 on a (data, model) mesh through the
              entry points (the train step on ``Model.loss``, ``Model.
              prefill`` and ``.decode`` under ``activate_mesh``; parameters
              by ``param_shardings``, the train state by
              ``shard_train_state``, the cache by ``launch.sharding.
              cache_shardings``), at published width in bf16 with remat:
              rwkv6-1.6b at 4 layers and zamba2-7b at 7 (a group of six
              Mamba2 layers, the shared block, one remainder layer), each
              on (2, 2) and (1, 16) repeating the card: 3 ZeRO-1 steps of 8
              x 512 (every loss finite, every parameter a finite nonzero
              gradient, launches a position a step exact: ``rwkv6_scan``
              2 L and ``rwkv6_scan_bwd`` L; ``mamba2_ssd`` 14,
              ``mamba2_ssd_bwd`` 7, ``flash_attention`` and its backward 1;
              step ms, tokens/s, peak GB, idle share), then a prefill of 8
              x 512 into 4096 rows and 32 greedy steps held to the same
              weights unsharded on the card as ``sharded_serve`` holds its
              runs, launches exact (the scan layers x positions a prefill,
              ``flash_attention`` and ``decode_attention`` G x positions a
              prefill and a step); the smoke configs in float32, card
              against CPU on (2, 2), within 1e-4. With four cards or more
              instead: zamba2-7b whole (81 layers) on (2, 2) over the first
              four, 8 steps.
  25. sharded_whisper  whisper-base (the encdec family) at its published
              width and depth, bf16 with remat, on (2, 2) and (1, 16)
              repeating the card, through the same entry points: 3 ZeRO-1
              steps of 8 x 448 decoder tokens beside 8 x 1500 frames, then
              a topk and an int8 step, every loss and grad_norm held to the
              same steps unsharded on the card within 2e-2 (launches a
              position a step: flash_attention 24, its backward 12); one
              gradient tree compressed on the mesh bit for bit as
              unsharded (thresholds, scales, gradients, error states); a
              prefill of 8 x 16 tokens beside 1500 frames into 64 rows and
              32 greedy steps held to the unsharded run (the heads form at
              (2, 2), decode_attention_lse's sequence form at (1, 16),
              the cross cache by heads and whole); a checkpoint of the
              (2, 2) state at 2 + 2 layers after 2 steps, restored onto
              (2, 2), onto (1, 16) from meta specs and unsharded, every
              leaf bit-equal to the saved state (the third step after the
              (2, 2) restore bit-equal to the uninterrupted one); the float32
              parity at 1 + 1 layers, card against CPU on (2, 2).
  26. dryrun  the port's dry run (``repro_torch.launch.dryrun``): (a) in
              two processes started after the build, beside the other
              phases on the host's CPU, ``run_cell`` at full width on the
              production (16, 16) mesh of fake cuda positions, through the
              kernel wrappers' fake branch, for llama3-8b decode_32k and
              train_4k (depth-expanded where the check at a third depth
              holds): peak GB a position, collective bytes, roofline terms;
              (b) sharded_train's llama3-8b cell (2 layers, 8 x 512, (2,
              2)) and a sharded_serve decode cell (2 layers, 8 sequences
              against 4096 rows) traced on fake tensors and run on the card
              under the collective counter and the memory tracker: every
              number equal (collectives by kind and site, each position's
              bytes and peak, operations, kernel calls), and the tracker's
              peak within ``DRYRUN_MARGIN`` of ``max_memory_allocated``;
              one card a position with four cards or more. The phase's
              seconds are printed.
  27. kernels one line per kernel, and the JSON summary of all of them
              (with phase 26 (a)'s fake calls a position a step).

The last line of output is ``{"ok": true, "device": {...}}``. Without a
visible CUDA device, or without the rest of the repository beside it, the
script exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MODES = ("flat", "root-only", "emb", "emb+planner", "llm", "llm+planner")
SLEEP_CYCLES = 2_000_000     # keeps the stream busy while launches queue up
TIMING_REPS = 25
REPLACES = {
    "tree_refresh": "src/repro/kernels/tree_refresh.py:54",
    "topk_sim": "src/repro/kernels/topk_sim.py:149",
    "browse_scores": "src/repro/kernels/browse_scores.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:116",
    # no Pallas counterpart: the reference differentiates its jnp attention
    "flash_attention_bwd": "src/repro/kernels/ref.py:16",
    "decode_attention": "src/repro/kernels/decode_attention.py:103",
    "mamba2_ssd": "src/repro/kernels/mamba2_ssd.py:119",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:125",
    # no Pallas counterparts: the reference differentiates its jnp chunked
    # scans
    "mamba2_ssd_bwd": "src/repro/kernels/ref.py:315",
    "rwkv6_scan_bwd": "src/repro/kernels/ref.py:257",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in REPLACES}
SCAN_C = 512      # the bf16 scans' float32 error, in units of 2^-24 T
# flash_attention_bwd, bf16: excess over one bf16 ulp of a float64 run, of
# max|ref|. The tensor-core design rounds P and dS to bf16 before their
# products, as every flash backward does: 2.9e-4 to 1.48e-3 at the shapes
# tests/test_torch_attention_design.py derives it at, which pins it.
BWD_TC_EXCESS = 4e-3
# the inputs whose signs a scan's terms carry: x, B, C, state; r, k, v, u,
# state (bf16_scan_excess)
SCAN_SIGNED = {"mamba2_ssd": (0, 3, 4, 5), "rwkv6_scan": (0, 1, 2, 4, 5)}
SLICE_KERNELS = ("tree_refresh", "topk_sim", "browse_scores")
# (capacity, valid rows) of the largest baseline fact store at D = 256 (the
# hashing encoder) and at D = 4096 (llama3-8b), seed 0
BASELINE_TOPK = ((16384, 10210), (128, 86))
SERVE_KERNELS = SLICE_KERNELS + ("flash_attention", "decode_attention")
ATTENTION_KERNELS = ("flash_attention", "decode_attention")
# the moe phase's memory at olmoe's D = 2048, seed 0: (capacity, valid rows)
# of its root index and its fact index, and the rows of its node arena
OLMOE_TOPK = ((256, 160), (128, 67))
OLMOE_ARENA = 3484


class CheckFailed(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def device_ms(torch, fn) -> float:
    """Median device time of one call, CUDA events around it. A sleep kernel
    ahead of each call lets the host queue the call before the device reaches
    it, so host launch overhead stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


PROFILE_TRIES = 3


def profiled(torch, fn):
    """A profile of one call of ``fn`` (device activity only), after a
    warm-up call. The profiler has been seen to return no device activity at
    all for a call that launched, after several profiles in one process
    (hence ``device_events`` reads CUDA graphs first): such an empty capture
    is taken again, up to ``PROFILE_TRIES`` times, so a call that launches
    nothing still comes back empty."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if any(str(ev.device_type).endswith("CUDA") for ev in prof.events()):
            break
    return prof


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of ``cuda.h`` (libcuda's graph API)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_events(torch, fn):
    """The device operations of one call of ``fn``, read from a CUDA graph
    it is captured into: each kernel node by its function's name, any other
    node by its type. A capture records every operation the call issues on
    its stream, as the profiler does, and refuses a call that waits for the
    device. Warm-up calls on the capture stream first."""
    cu = ctypes.CDLL("libcuda.so.1")
    stream = torch.cuda.Stream()
    fn()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # its nodes stay readable
    with torch.cuda.graph(graph, stream=stream):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    need(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
         "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        name = ctypes.c_char_p()
        if kind.value == 0:                  # CU_GRAPH_NODE_TYPE_KERNEL
            p = _KernelNodeParams()
            cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                             ctypes.byref(p))
            if p.func:
                cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func))
            elif p.kern:
                cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern))
        names.append(name.value.decode() if name.value
                     else f"graph node of type {kind.value}")
    graph.reset()
    return names


def device_events(torch, fn):
    """Names of the device operations (kernels, copies, fills) of one call
    of ``fn``: the nodes of a CUDA graph it is captured into
    (``graph_events``), or, where the capture fails or a node has no name,
    the profiler's device activities."""
    try:
        names = graph_events(torch, fn)
        if not any(n.startswith("graph node of type") for n in names):
            return names
    except (RuntimeError, OSError, AttributeError, TypeError, CheckFailed):
        pass
    return [ev.name for ev in profiled(torch, fn).events()
            if str(ev.device_type).endswith("CUDA")]


def peaks_for(name: str):
    """The memory rate (bytes/s), the non-tensor fp32 rate and the dense bf16
    tensor-core rate (FLOP/s) of the H100 SXM, from NVIDIA's data sheet, as
    ``repro_torch.launch.roofline`` holds them; the bounds are computed for
    this card only. A bf16 kernel's bound uses the bf16 rate: the least time
    the card could take for its work."""
    from repro_torch.launch import roofline
    need("H100" in name and not any(v in name for v in ("PCIe", "NVL")),
         f"no peak figures for {name!r}: the bounds hold for the H100 SXM")
    return {"bytes": roofline.HBM_BW, "fp32": roofline.PEAK_FLOPS_FP32,
            "bf16": roofline.PEAK_FLOPS}


def bound_ms(nbytes: float, flops: float, peaks, op: str = "fp32"):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and operations over the peak rate of type ``op``."""
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = flops / peaks[op] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def record_row(torch, peaks, results, name, label, err, tol, fn, plain,
               nbytes, flops, main, library=None, op="fp32"):
    """Time the kernel, its plain version and the library call. A main
    row is one the main paths run; the first main row of a kernel is
    its row in the JSON summary, the others ride along in it."""
    ms = device_ms(torch, fn)
    plain_ms = device_ms(torch, plain)
    lib_ms = device_ms(torch, library) if library is not None else None
    b_ms, b_by = bound_ms(nbytes, flops, peaks, op)
    peak = peaks["bytes"] / 1e12 if b_by == "bytes" else peaks[op] / 1e12
    unit = "TB/s" if b_by == "bytes" else f"TFLOP/s {op}"
    lib_txt = f"{lib_ms:.5f}" if lib_ms is not None else "none"
    tol_txt = f"tol {tol:.0e}" if tol is not None else "criteria above"
    print(f"check: {name} {label} max_abs_err={err:.3e} ({tol_txt}) "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_txt} "
          f"bound_ms={b_ms:.5f} ({b_by} at {peak:g} {unit})", flush=True)
    if main:
        row = {"shape": label, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "peak": "bytes" if b_by == "bytes" else op,
               "library_ms": lib_ms}
        if name not in results:
            results[name] = dict(row, other_main_rows=[])
        else:
            results[name]["other_main_rows"].append(row)


def check_kernels(torch, peaks, seed: int):
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.browse_scores import (browse_scores,
                                                   browse_scores_rows)
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                     decode_attention_lse)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.topk_sim import topk_sim
    from repro_torch.kernels.tree_refresh import tree_refresh

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    # rows added later draw from a generator of their own, so that adding a
    # row leaves the inputs of every other row as they were
    g_new = torch.Generator(device=dev).manual_seed(seed)
    # the ablations' rows (K = 3 and 64) draw from a third
    g_abl = torch.Generator(device=dev).manual_seed(seed + 1)
    results = {}

    def record(*args, **kw):
        record_row(torch, peaks, results, *args, **kw)

    # -- tree_refresh -------------------------------------------------------
    # the slice's flush launches 128, 32, 16 (and fewer) parents at D = 256;
    # D = 3072 (phi3-mini's width) is a cluster of 4 over slices of 768, and
    # D = 36004 slices wider than one pass of a block, with D % 8 == 4; the
    # ablations' k sweep gives the first level 176 parents of 3 children
    # (256 with the padding) at K = 3 and 16 parents of 32 at K = 64
    for (P, K, D), main, gen in (
            ((128, 8, 256), True, g), ((128, 8, 4096), True, g),
            ((32, 8, 256), True, g), ((16, 8, 256), True, g),
            ((4096, 16, 256), False, g), ((128, 8, 3072), False, g_new),
            ((8, 4, 36004), False, g_new), ((128, 8, 2048), True, g_new),
            ((256, 3, 256), False, g_abl), ((16, 64, 256), False, g_abl)):
        emb = ref.normalize_rows(torch.randn(
            P * K, D, generator=gen, device=dev)).reshape(P, K, D).contiguous()
        cnt = torch.randint(0, K + 1, (P,), generator=gen, device=dev)
        cnt[: P // 16] = 0                      # parents with no real child
        mask = (torch.arange(K, device=dev)[None, :] < cnt[:, None]).float()
        out = tree_refresh(emb, mask)
        torch.cuda.synchronize()
        want = ref.tree_refresh_ref(emb, mask)
        err = (out - want).abs().max().item()
        need(err <= 1e-5, f"tree_refresh {P}x{K}x{D}: max err {err}")
        need(bool((out[cnt == 0] == 0).all()), "tree_refresh: empty parents "
             "must give zero rows")
        record("tree_refresh", f"{P}x{K}x{D}", err, 1e-5,
               lambda: tree_refresh(emb, mask),
               lambda: ref.tree_refresh_ref(emb, mask),
               (P * K * D + P * K + P * D) * 4, costs.tree_refresh_ops(P, K, D),
               main)

    # -- browse_scores ------------------------------------------------------
    for (F, K, D), main in (((1024, 8, 256), True), ((512, 8, 4096), True),
                            ((4096, 16, 256), False)):
        # unit rows, as the browse gathers them from the forest
        child = ref.normalize_rows(torch.randn(F * K, D, generator=g,
                                               device=dev)).reshape(F, K, D)
        q = ref.normalize_rows(torch.randn(F, D, generator=g, device=dev))
        mask = (torch.rand(F, K, generator=g, device=dev) < 0.7).float()
        out = browse_scores(child, q, mask)
        torch.cuda.synchronize()
        want = ref.browse_scores_ref(child, q, mask)
        err = (out - want).abs().max().item()
        need(err <= 2e-5, f"browse_scores {F}x{K}x{D}: max err {err}")
        need(bool((out[mask == 0] == 0).all()), "browse_scores: padded slots "
             "must score exactly 0")

        # one library call computes the same function; timed for comparison
        def library():
            return torch.einsum("fkd,fd,fk->fk", child, q, mask)
        lib_err = (library() - want).abs().max().item()
        need(lib_err <= 2e-5, f"browse_scores library call: max err {lib_err}")
        record("browse_scores", f"{F}x{K}x{D}", err, 2e-5,
               lambda: browse_scores(child, q, mask),
               lambda: ref.browse_scores_ref(child, q, mask),
               (F * K * D + F * D + 2 * F * K) * 4, costs.browse_ops(F, K, D), main,
               library)
    packed_call = (child, q, mask)

    def rows_case(F, K, D, R, L, what, main=False, fill=None, plant=False,
                  offset=0):
        """The gather form, as the browse calls it: an arena of R unit rows,
        L lane queries, (F, K) row ids with -1 in padded slots (entries of
        ``fill`` children, else all K; the last sixteenth all padded). With
        ``plant``, one arena row in three slots of three entries and a copy
        of it at another row, all against one query: bitwise equal scores.
        ``offset`` floats move the arena off 16-byte alignment."""
        arena = ref.normalize_rows(torch.randn(R, D, generator=g_new,
                                               device=dev))
        if offset:
            buf = torch.empty(R * D + offset, device=dev)
            buf[offset:] = arena.flatten()
            arena = buf[offset:].view(R, D)
        q_rows = ref.normalize_rows(torch.randn(L, D, generator=g_new,
                                                device=dev))
        rows = torch.randint(0, R, (F, K), generator=g_new, device=dev,
                             dtype=torch.int32)
        if fill is not None:
            cnt = torch.randint(fill[0], fill[1] + 1, (F, 1), generator=g_new,
                                device=dev)
            rows[torch.arange(K, device=dev)[None, :] >= cnt] = -1
        rows[F - F // 16:] = -1
        lane_of = torch.randint(0, L, (F,), generator=g_new, device=dev,
                                dtype=torch.int32)
        spots = [(0, 0), (F // 2, K - 1), (F // 3, K // 2), (1, 0)]
        if plant:
            r0 = (int(rows[0, 0]) + 1) % R
            r1 = (r0 + R // 2) % R
            arena[r1] = arena[r0]
            for i, (f, k) in enumerate(spots):
                rows[f, k] = r0 if i < 3 else r1
                lane_of[f] = lane_of[0]
        mask = (rows >= 0).float()
        args = (arena, rows, q_rows, lane_of, mask)
        out = browse_scores_rows(*args)
        torch.cuda.synchronize()
        want = ref.browse_scores_rows_ref(*args)
        err = (out - want).abs().max().item()
        label = f"gather {what} {F}x{K}x{D} arena={R} lanes={L}"
        need(err <= 2e-5, f"browse_scores {label}: max err {err}")
        need(bool((out[rows < 0] == 0).all()), f"browse_scores {label}: "
             "padded slots must score exactly 0")
        if plant:
            got = [out[f, k].item() for f, k in spots]
            need(len(set(got)) == 1, f"browse_scores {label}: one row in "
                 f"four slots scored {got}")
        # bytes: the distinct rows and lane queries this call's data needs,
        # then 4 a slot each for the row id, the mask and the score, and the
        # lane ids
        real = rows >= 0
        used = real.any(1)
        nbytes = (torch.unique(rows[real]).numel() * D
                  + torch.unique(lane_of[used]).numel() * D) * 4 \
            + F * K * 12 + F * 4
        record("browse_scores", label, err, 2e-5,
               lambda: browse_scores_rows(*args),
               lambda: ref.browse_scores_rows_ref(*args), nbytes,
               2 * int(real.sum()) * D, main)
        return args

    # the slice's levels (an arena of its 13,382 nodes at D = 256, 64
    # queries x 8 trees = 512 lanes, about 2.5 children an entry), the
    # serve phase's at D = 4096 with every slot real, then stress rows
    slice_call = rows_case(512, 8, 256, 13382, 512, "slice level", True,
                           fill=(1, 4))
    rows_case(1024, 8, 256, 13382, 512, "slice level", True, fill=(1, 4))
    rows_case(512, 8, 4096, 13382, 512, "serve level", True)
    rows_case(1024, 8, 4096, 13382, 512, "serve level", True, plant=True)
    rows_case(4096, 16, 256, 13382, 512, "stress", plant=True)
    rows_case(1024, 8, 260, 4000, 64, "stress", plant=True)
    rows_case(256, 8, 250, 4000, 64, "single floats", plant=True)
    rows_case(512, 8, 256, 13382, 512, "unaligned arena", fill=(1, 4),
              offset=1)
    # the moe phase's levels at olmoe's D = 2048, from its memory's arena
    rows_case(512, 8, 2048, OLMOE_ARENA, 512, "olmoe level", True)

    # -- topk_sim -----------------------------------------------------------
    def topk_case(Q, N, D, k, nv, *, main=False, plant=False, normalize=False,
                  gen=g, pairs=None):
        keys = ref.normalize_rows(torch.randn(N, D, generator=gen, device=dev))
        q = ref.normalize_rows(torch.randn(Q, D, generator=gen, device=dev))
        ties = []
        if plant:
            # exact ties: two equal key rows equal to a query, the pair in
            # one tile, in two splits, and one copy past num_valid
            spots = pairs or [(0, 5, 6), (1, 17, N // 2 + 3), (2, 100, nv - 1)]
            for qi, a, b in spots[: min(Q, 3)]:
                keys[a] = q[qi]
                keys[b] = q[qi]
                ties.append((qi, sorted((a, b))))
            if nv < N and Q > 3:
                keys[nv] = q[3]                 # masked: must never appear
        qn, kn = (q * 3.0, keys * 0.5) if normalize else (q, keys)
        vals, idx = topk_sim(qn, kn, k, normalize=normalize, num_valid=nv)
        torch.cuda.synchronize()
        kk = min(k + 1, N)
        pv, pi = ref.topk_sim_ref(qn, kn, kk, normalize=normalize,
                                  num_valid=nv)
        pv_k, pi_k = pv[:, :k], pi[:, :k]
        live = pv_k > -1e29
        err = (vals - pv_k).abs()[live].max().item() if live.any() else 0.0
        need(err <= 1e-5, f"topk_sim {Q}x{N} k={k}: value err {err}")
        need(bool((vals[~live] == -1e30).all() and (idx[~live] == -1).all()),
             f"topk_sim {Q}x{N} k={k}: dead slots must be -1e30 / -1")
        # an index may differ only where the plain version's neighbouring
        # scores lie within 1e-5 of each other
        gap_prev = torch.full_like(pv_k, float("inf"))
        gap_prev[:, 1:] = (pv_k[:, 1:] - pv_k[:, :-1]).abs()
        gap_next = torch.full_like(pv_k, float("inf"))
        nxt = pv[:, 1:k + 1]
        gap_next[:, : nxt.shape[1]] = (pv_k[:, : nxt.shape[1]] - nxt).abs()
        firm = (gap_prev > 1e-5) & (gap_next > 1e-5)
        bad = (idx != pi_k) & firm
        need(not bool(bad.any()), f"topk_sim {Q}x{N} k={k}: "
             f"{int(bad.sum())} indices differ where scores are apart")
        for qi, pair in ties:
            got = idx[qi, :2].tolist()
            need(got == pair and vals[qi, 0].item() == vals[qi, 1].item(),
                 f"topk_sim tie for query {qi}: got {got}, want {pair}")
        if nv < N and Q > 3:
            need(not bool((idx == nv).any()), "topk_sim: a key past "
                 "num_valid was returned")
        label = f"{Q}x{N}x{D} k={k} num_valid={nv}" + \
            (" normalize" if normalize else "")
        record("topk_sim", label, err, 1e-5,
               lambda: topk_sim(qn, kn, k, normalize=normalize, num_valid=nv),
               lambda: ref.topk_sim_ref(qn, kn, k, normalize=normalize,
                                        num_valid=nv),
               (nv * D + Q * D) * 4 + Q * k * 8, costs.topk_ops(Q, nv, D), main)
        return qn, kn, k, nv

    topk_case(64, 256, 256, 16, 256)
    topk_case(64, 1024, 256, 24, 1024, main=True)
    topk_case(32, 1024, 4096, 24, 1024, main=True)      # the serve phase's D
    # the slice's own recall rows (roots, facts), with planted ties
    topk_case(64, 1024, 256, 24, 675, main=True, plant=True)
    topk_case(64, 256, 256, 16, 210, main=True, plant=True)
    # D = 4096: the planted pair (17, 515) lies in two splits, so in two
    # clusters, each adding its ranks' partial sums in rank order
    topk_case(32, 1024, 4096, 24, 1000, plant=True)
    topk_case(64, 256, 256, 16, 5)                       # num_valid < k
    # D % 8 == 4 goes in unpadded: a cluster of 8 over slices of 36 floats
    topk_case(16, 2000, 260, 8, 1990, plant=True, gen=g_new)
    topk_case(8, 1000, 256, 7, 1000, normalize=True)
    big = 262144
    topk_case(64, big, 256, 16, big - 1, plant=True)
    topk_case(1, big, 256, 32, big - 1, plant=True)
    topk_case(200, big, 256, 32, big - 1, plant=True)
    # the baselines' fact stores: one query over a capacity-padded store
    # (64 * 2^j rows), k = 10, at the largest (capacity, size) the baselines
    # phase reaches on seed 0 (MemPalace's chunk store; on llama3-8b,
    # EverMem's cell store),
    # a planted pair of equal rows at the first and the last valid row
    baseline_call = topk_case(1, BASELINE_TOPK[0][0], 256, 10,
                              BASELINE_TOPK[0][1], main=True, plant=True,
                              gen=g_new,
                              pairs=[(0, 5, BASELINE_TOPK[0][1] - 1)])
    topk_case(1, BASELINE_TOPK[1][0], 4096, 10, BASELINE_TOPK[1][1],
              main=True, plant=True, gen=g_new,
              pairs=[(0, 5, BASELINE_TOPK[1][1] - 1)])
    # the moe phase's recall at olmoe's D = 2048: its memory's root index
    # (k = 24) and fact index (k = 16), with planted ties
    for (cap, nv), k in zip(OLMOE_TOPK, (24, 16)):
        topk_case(64, cap, 2048, k, nv, main=True, plant=True, gen=g_new,
                  pairs=[(0, 5, 6), (1, 3, nv - 1)])
    # a shard of the sharded fact index that owns no valid row (the sharded
    # phase's fewer-rows-than-shards case) at the slice's fact shape: every
    # slot -1e30 / -1
    topk_case(64, 256, 256, 16, 0, gen=g_new)

    # -- flash_attention ----------------------------------------------------
    # bf16 rows: tests/test_kernels.py's bf16 criterion, |err| <= 2e-2 +
    # 1e-2 |plain|. The kernel computes on the tensor cores from the same
    # bf16 inputs, keeps the softmax in f32 and rounds P to bf16 before P.V
    # (the plain version keeps P in f32); tests/test_torch_attention_design.py
    # shows on the CPU that this arithmetic stays within the criterion. f32
    # rows (the CUDA-core kernel): 2e-5 (f32 sums in another order).
    # The library call is checked only to show that it computes the same
    # function: its bf16 kernels round P to bf16 before P.V, so it is held
    # to 5e-2 (bf16) or 1e-3 (f32) beyond 5e-2 |plain|.
    F = torch.nn.functional
    tols = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (2e-5, 0.0)}
    lib_tols = {torch.bfloat16: (5e-2, 5e-2), torch.float32: (1e-3, 5e-2)}
    ops_of = {torch.bfloat16: "bf16", torch.float32: "fp32"}

    def agree(out, want, dt, what, tolerances=tols):
        atol, rtol = tolerances[dt]
        o, w = out.float(), want.float()
        excess = ((o - w).abs() - rtol * w.abs()).max().item()
        need(excess <= atol, f"{what}: differs from the plain version by "
             f"{excess:.3e} beyond rtol {rtol} (atol {atol})")
        return (o - w).abs().max().item()

    def row_scaled(out, want, what):
        """Stress rows, besides agree(): each output row (the last dim) within
        2e-2 of its own largest plain value. Over thousands of random keys
        the outputs are small (about 0.01 at 32k keys), where agree()'s 2e-2
        alone would pass a dropped or misweighed group of keys. An all-zero
        plain row (length 0) must come out zero."""
        o, w = out.float().flatten(0, -2), want.float().flatten(0, -2)
        top = w.abs().amax(-1)
        dev_ = (o - w).abs().amax(-1)
        worst = torch.where(top > 0, dev_ / top.clamp_min(1e-30),
                            dev_ * 1e30).max().item()
        print(f"check: {what} worst row max|err| / row max|plain| = "
              f"{worst:.3e} (tol 2e-2)", flush=True)
        need(worst <= 2e-2, f"{what}: a row differs from the plain version "
             f"by {worst:.3e} of its largest value (tol 2e-2)")

    def flash_case(B, S, Hq, Hkv, D, causal, dt, main, what, gen=g):
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        label = (f"{what} {B}x{S}x{Hq}/{Hkv}x{D} "
                 f"{'causal' if causal else 'full'} {ops_of[dt]}")
        plain_out = ref.attention_ref(q, k, v, causal=causal)
        err = agree(out, plain_out, dt, f"flash_attention {label}")
        if what == "stress":
            row_scaled(out, plain_out, f"flash_attention {label}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():     # timed for comparison; the port never calls it
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        agree(library().transpose(1, 2), out, dt,
              f"flash_attention {label}: the library call", lib_tols)
        pairs = S * (S + 1) // 2 if causal else S * S
        elem = out.element_size()
        record("flash_attention", label, err, tols[dt][0],
               lambda: flash_attention(q, k, v, causal=causal),
               lambda: ref.attention_ref(q, k, v, causal=causal),
               (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * elem,
               costs.attention_ops(B, S, Hq, D, causal), main, library,
               ops_of[dt])
        return q, k, v

    bf16, f32 = torch.bfloat16, torch.float32
    flash_case(336, 28, 32, 8, 128, True, bf16, True, "encoder")
    flash_case(8, 128, 32, 8, 128, True, bf16, True, "prefill")
    flash_case(8, 128, 32, 32, 112, True, bf16, True, "zamba2 prefill")
    flash_case(48, 28, 32, 8, 128, True, f32, False, "parity encoder")
    flash_case(64, 12, 32, 8, 128, True, bf16, False, "short encoder batch")
    flash_case(2, 77, 32, 8, 72, True, bf16, False, "head dim padded to 80")
    flash_case(4, 100, 16, 4, 64, False, bf16, False, "head dim 64")
    flash_case(2, 33, 8, 8, 20, True, bf16, False, "head dim padded to 24")
    flash_case(1, 40, 128, 1, 64, True, bf16, False, "group of 128")
    flash_case(1, 4096, 32, 8, 128, True, bf16, False, "stress")
    flash_case(2, 2048, 32, 32, 96, False, bf16, False, "stress")
    # the moe, vlm and whisper phases' shapes: olmoe's encoder and prefill
    # (16/16 x 128, a group of 1), pixtral's prefill (64 patches and 128
    # tokens: three 64-row query and key tiles), whisper's encoder (full, 1500 frames: 24
    # key tiles, the last one 28 rows) and its decoder's prompt
    flash_case(336, 28, 16, 16, 128, True, bf16, True, "olmoe encoder",
               gen=g_new)
    flash_case(8, 128, 16, 16, 128, True, bf16, True, "olmoe prefill",
               gen=g_new)
    flash_case(8, 192, 32, 8, 128, True, bf16, True, "pixtral prefill",
               gen=g_new)
    whisper_call = flash_case(8, 1500, 8, 8, 64, False, bf16, True,
                              "whisper encoder", gen=g_new)
    flash_case(8, 16, 8, 8, 64, True, bf16, True, "whisper prefill",
               gen=g_new)
    # the sharded_train phase's per-shard shapes at model = 2 (B = 8 over
    # data = 2, the heads over model = 2), from a generator of their own so
    # that the rows after them draw what they drew before
    g_shard = torch.Generator(device=dev).manual_seed(seed + 27)
    for B, S, Hq, Hkv, D, what in SHARD_ATTENTION:
        flash_case(B, S, Hq, Hkv, D, True, bf16, True, what, gen=g_shard)
    # the sharded_whisper phase's shards at model = 2 (B = 8 over data = 2,
    # 8 heads over model = 2): the encoder (full) and the decoder's train
    # prompt (causal), from a generator of their own
    g_whisper = torch.Generator(device=dev).manual_seed(seed + 30)
    for B, S, Hq, Hkv, D, causal, what in WHISPER_SHARD_ATTENTION:
        flash_case(B, S, Hq, Hkv, D, causal, bf16, True, what, gen=g_whisper)

    # -- decode_attention ---------------------------------------------------
    def decode_case(B, Smax, Hq, Hkv, D, lengths, dt, main, what, gen=g):
        q = torch.randn(B, Hq, D, generator=gen, device=dev).to(dt)
        kc = torch.randn(B, Smax, Hkv, D, generator=gen, device=dev).to(dt)
        vc = torch.randn(B, Smax, Hkv, D, generator=gen, device=dev).to(dt)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, lens)
        again = decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        label = f"{what} {B}x{Smax}x{Hq}/{Hkv}x{D} {ops_of[dt]}"
        need(torch.equal(out, again), f"decode_attention {label}: two calls "
             "on the same inputs differ")
        plain_out = ref.decode_attention_ref(q, kc, vc, lens)
        err = agree(out, plain_out, dt, f"decode_attention {label}")
        if what.startswith("stress"):
            row_scaled(out, plain_out, f"decode_attention {label}")
        need(bool((out[lens == 0] == 0).all()), "decode_attention: length 0 "
             "must give zeros")
        live = lens > 0                 # the library call has no answer at 0
        mask = (torch.arange(Smax, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

        def library():     # timed for comparison; the port never calls it
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        agree(library()[:, :, 0][live], out[live], dt,
              f"decode_attention {label}: the library call", lib_tols)
        rows = sum(min(max(n, 0), Smax) for n in lengths)
        elem = out.element_size()
        record("decode_attention", label, err, tols[dt][0],
               lambda: decode_attention(q, kc, vc, lens),
               lambda: ref.decode_attention_ref(q, kc, vc, lens),
               2 * rows * Hkv * D * elem + 2 * B * Hq * D * elem + 4 * B,
               costs.decode_ops(rows, Hq, D), main, library, ops_of[dt])
        return q, kc, vc, lens

    rng = np.random.default_rng(seed)
    main_lens = rng.integers(40, 200, size=8).tolist()
    decode_case(8, 512, 32, 8, 128, main_lens, bf16, True, "decode")
    decode_case(8, 512, 32, 32, 112, rng.integers(128, 161, size=8).tolist(),
                bf16, True, "zamba2 decode")
    decode_case(4, 512, 32, 8, 128, rng.integers(20, 80, size=4).tolist(),
                f32, False, "parity decode")
    decode_case(8, 512, 32, 8, 128, [1, 64, 127, 128, 100, 5, 128, 77], bf16,
                False, "one live chunk")
    decode_case(8, 512, 32, 8, 128, [128, 256, 384, 512, 129, 255, 0, 600],
                bf16, False, "chunk boundaries")
    decode_case(3, 300, 8, 2, 36, [300, 37, 1], bf16, False, "head dim 36")
    decode_case(4, 512, 32, 2, 128, [300, 0, 512, 77], bf16, False,
                "group of 16")
    decode_case(2, 512, 64, 2, 64, [400, 129], bf16, False, "group of 32")
    decode_case(1, 32768, 32, 8, 128, [32760], bf16, False, "stress split-KV")
    wide = rng.integers(1, 4097, size=64).tolist()
    wide[0], wide[1] = 0, 5000          # an empty row, a row past Smax
    decode_case(64, 4096, 32, 8, 128, wide, bf16, False, "stress")
    # the moe phase's decode (olmoe, 16/16 x 128) and the whisper phase's
    # (8/8 x 64 in a 64-row cache: its 16-token prompts and 32 steps)
    olmoe_lens = np.random.default_rng(seed + 1).integers(120, 185, size=8)
    olmoe_call = decode_case(8, 512, 16, 16, 128, olmoe_lens.tolist(), bf16,
                             True, "olmoe decode", gen=g_new)
    decode_case(8, 64, 8, 8, 64, np.random.default_rng(seed + 2).integers(
        17, 49, size=8).tolist(), bf16, True, "whisper decode", gen=g_new)
    # the sharded_whisper phase's heads form at model = 2: a position's 4 of
    # 8 rows and 4 of 8 heads in the 64-row cache
    decode_case(4, 64, 4, 4, 64, np.random.default_rng(seed + 3).integers(
        17, 49, size=4).tolist(), bf16, True, "whisper-base model=2 shard",
        gen=g_whisper)

    # the C entry refuses a scratch smaller than its layout and a head dim
    # the tensor maps cannot take (the wrapper pads those)
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import scratch_sizes
    q = torch.zeros(2, 8, 40, dtype=bf16, device=dev)
    kc = torch.zeros(2, 1024, 2, 40, dtype=bf16, device=dev)
    lens = torch.full((2,), 1000, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    n_part, n_cnt = scratch_sizes(2, 8, 2, 40, 8, True)
    part = torch.empty(n_part, dtype=torch.float32, device=dev)
    cnt = _build.counters(dev, n_cnt)

    def entry(n_floats, n_counters, D, scale_dim):
        try:
            _build.launch("decode_attention", "memforest_decode_attention",
                          dev, q.data_ptr(), kc.data_ptr(), kc.data_ptr(),
                          lens.data_ptr(), out.data_ptr(), None,
                          part.data_ptr(), cnt.data_ptr(), n_floats,
                          n_counters, 2, 1024, 8, 2,
                          D, scale_dim, 128, 8, 1)
            torch.cuda.synchronize()
            return True
        except RuntimeError:
            return False
    need(entry(n_part, n_cnt, 40, 36), "decode_attention: the C entry "
         "refused a scratch of the size it needs")
    for n_floats, n_counters, D, scale_dim, what in (
            (n_part - 1, n_cnt, 40, 36, "a scratch one float short"),
            (n_part, n_cnt - 1, 40, 36, "counters one short"),
            (n_part, n_cnt, 36, 36, "a head dim of 36 unpadded"),
            (n_part, n_cnt, 40, 32, "a scale dim padded by 8")):
        need(not entry(n_floats, n_counters, D, scale_dim),
             f"decode_attention: the C entry took {what}")
    print("check: decode_attention C entry refuses short scratch and "
          "unpadded head dims", flush=True)

    # one call, one launch: the splits are merged inside the kernel
    for B, Smax, lengths in ((8, 512, main_lens), (1, 32768, [32760])):
        q = torch.randn(B, 32, 128, generator=g, device=dev).to(bf16)
        kc = torch.randn(B, Smax, 8, 128, generator=g, device=dev).to(bf16)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        names = device_events(torch, lambda: decode_attention(q, kc, kc, lens))
        print(f"check: decode_attention {B}x{Smax}x32/8x128 launches per call="
              f"{len(names)} ({', '.join(n[:40] for n in names)})", flush=True)
        need(len(names) == 1 and "decode_attention" in names[0],
             f"decode_attention: one call made {len(names)} device launches")

    # -- decode_attention with each head's log-sum-exp ------------------------
    # the sharded_serve phase's shards (DECODE_LSE_ROWS), from a generator of
    # their own so that every other row draws what it drew before
    g_lse = torch.Generator(device=dev).manual_seed(seed + 28)
    for B, Smax, Hq, Hkv, D, lo, hi, dname, main, what in DECODE_LSE_ROWS:
        dt = {"bf16": bf16, "f32": f32}[dname]
        q = torch.randn(B, Hq, D, generator=g_lse, device=dev).to(dt)
        kc = torch.randn(B, Smax, Hkv, D, generator=g_lse, device=dev).to(dt)
        vc = torch.randn(B, Smax, Hkv, D, generator=g_lse, device=dev).to(dt)
        lens = torch.randint(lo, hi + 1, (B,), generator=g_lse, device=dev,
                             dtype=torch.int32)
        label = f"lse {what} {B}x{Smax}x{Hq}/{Hkv}x{D} {ops_of[dt]}"
        out, lse = decode_attention_lse(q, kc, vc, lens)
        torch.cuda.synchronize()
        need(torch.equal(out, decode_attention(q, kc, vc, lens)),
             f"decode_attention {label}: the output differs from the launch "
             "without the lse")
        plain_out, plain_lse = ref.decode_attention_lse_ref(q, kc, vc, lens)
        err = agree(out, plain_out, dt, f"decode_attention {label}")
        empty = lens == 0
        need(bool((out[empty] == 0).all()) and bool(
            (lse[empty] == -math.inf).all()), f"decode_attention {label}: a "
             "length of 0 must give zeros and lse -inf")
        live = ~empty
        lse_err = ((lse[live] - plain_lse[live]).abs().max().item()
                   if bool(live.any()) else 0.0)
        print(f"check: decode_attention {label} lse max_abs_err={lse_err:.3e}"
              f" (tol {LSE_TOL[dname]:.0e}, log2 units)", flush=True)
        need(lse_err <= LSE_TOL[dname], f"decode_attention {label}: lse "
             f"differs from the plain version by {lse_err:.3e}")
        mask = (torch.arange(Smax, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

        def library():     # timed for comparison; the port never calls it
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        if bool(live.any()):
            agree(library()[:, :, 0][live], out[live], dt,
                  f"decode_attention {label}: the library call", lib_tols)
        rows = int(torch.clamp(lens, 0, Smax).sum())
        elem = out.element_size()
        null_ms = device_ms(torch, lambda: decode_attention(q, kc, vc, lens))
        record("decode_attention", label, err, tols[dt][0],
               lambda: decode_attention_lse(q, kc, vc, lens),
               lambda: ref.decode_attention_lse_ref(q, kc, vc, lens),
               2 * rows * Hkv * D * elem + 2 * B * Hq * D * elem + 4 * B
               + 4 * B * Hq, costs.decode_ops(rows, Hq, D), main, library,
               ops_of[dt])
        print(f"check: decode_attention {label} without the lse "
              f"ms={null_ms:.5f}", flush=True)
        del q, kc, vc, plain_out, plain_lse

    # -- mamba2_ssd and rwkv6_scan --------------------------------------------
    # f32 rows: 2e-4 beyond 1e-2 relative (tests/test_kernels.py; the sums
    # run in another order). bf16 rows: the kernel computes in f32 from the
    # bf16 inputs and rounds the output once, so it is held to a float64 run
    # of the plain version: one bf16 ulp of that value plus SCAN_C * 2^-24 *
    # T, T the size of the terms summed into the output (bf16_scan_excess;
    # tests/test_torch_scan_design.py pins SCAN_C). The final state is f32
    # and held to the f32 criterion against the f32 plain version. No single
    # PyTorch call computes either scan: library_ms is none.
    def scan_agree(out, want, what):
        o, w = out.float(), want.float()
        excess = ((o - w).abs() - 1e-2 * w.abs()).max().item()
        need(excess <= 2e-4, f"{what}: differs from the plain version by "
             f"{excess:.3e} beyond rtol 1e-2 (atol 2e-4)")
        return (o - w).abs().max().item()

    def scan_bf16_agree(out, want, plain, args, chunk, signed, what):
        """The rule (bf16_scan_excess), and the earlier criterion's reading
        (one bf16 ulp of the f32 plain value beyond 2e-4) beside it."""
        excess = bf16_scan_excess(out, plain, args, signed, chunk)
        w = want.float()
        earlier = ((out.float() - w).abs() - bf16_ulp(w)).max().item()
        print(f"check: {what}: excess over the rule {excess:.3e} (passes at "
              f"<= 0); the earlier criterion's excess {earlier:.3e} (limit "
              "2e-4)", flush=True)
        need(excess <= 0, f"{what}: differs from a float64 run of the plain "
             f"version by {excess:.3e} beyond one bf16 ulp + {SCAN_C} * "
             "2^-24 * T")
        return (out.float() - w).abs().max().item()

    def scan_case(name, kernel, plain, args, chunk, label, nbytes, flops,
                  main, dt, signed):
        out, state = kernel(*args, chunk=chunk)
        torch.cuda.synchronize()
        want, want_state = plain(*args, chunk=chunk)
        what = f"{name} {label}: output"
        err = max(scan_bf16_agree(out, want, plain, args, chunk, signed, what)
                  if out.dtype == bf16 else scan_agree(out, want, what),
                  scan_agree(state, want_state, f"{name} {label}: state"))
        need(bool(torch.isfinite(out.float()).all()
                  and torch.isfinite(state).all()), f"{name} {label}: not finite")
        record(name, label, err, 2e-4, lambda: kernel(*args, chunk=chunk),
               lambda: plain(*args, chunk=chunk), nbytes, flops, main, None,
               ops_of[dt])

    def ssd_case(B, T, H, P, N, chunk, dt, main, what, gen=g):
        x = torch.randn(B, T, H, P, generator=gen, device=dev).to(dt)
        dts = F.softplus(torch.randn(B, T, H, generator=gen, device=dev))
        A = -torch.linspace(1.0, 16.0, H, device=dev)   # the model's init
        Bm = torch.randn(B, T, N, generator=gen, device=dev).to(dt)
        C = torch.randn(B, T, N, generator=gen, device=dev).to(dt)
        s0 = 0.1 * torch.randn(B, H, P, N, generator=gen, device=dev)
        c = min(chunk, T)
        elem = x.element_size()
        nbytes = (2 * B * T * H * P + 2 * B * T * N) * elem + B * T * H * 4 \
            + H * 4 + 2 * B * H * P * N * 4
        scan_case("mamba2_ssd", mamba2_ssd, ref.mamba2_ssd_chunked,
                  (x, dts, A, Bm, C, s0), chunk,
                  f"{what} {B}x{T}x{H}x{P}x{N} chunk={c} {ops_of[dt]}", nbytes,
                  ssd_flops(B, T, H, P, N, c), main, dt,
                  SCAN_SIGNED["mamba2_ssd"])

    def rwkv_case(B, T, H, K, V, chunk, dt, main, what, w_mean=-0.5, gen=g):
        r, k = (torch.randn(B, T, H, K, generator=gen, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn(B, T, H, V, generator=gen, device=dev).to(dt)
        w = w_mean + 0.5 * torch.randn(B, T, H, K, generator=gen, device=dev)
        u = (0.1 * torch.randn(H, K, generator=gen, device=dev)).to(dt)
        s0 = 0.1 * torch.randn(B, H, K, V, generator=gen, device=dev)
        c = min(chunk, T)
        elem = r.element_size()
        nbytes = (2 * B * T * H * K + 2 * B * T * H * V + H * K) * elem \
            + B * T * H * K * 4 + 2 * B * H * K * V * 4
        scan_case("rwkv6_scan", rwkv6_scan, ref.rwkv6_chunked,
                  (r, k, v, w, u, s0), chunk,
                  f"{what} {B}x{T}x{H}x{K}x{V} chunk={c} {ops_of[dt]}", nbytes,
                  rwkv_flops(B, T, H, K, V, c), main, dt,
                  SCAN_SIGNED["rwkv6_scan"])

    ssd_case(8, 128, 112, 64, 64, 64, bf16, True, "prefill")
    ssd_case(8, 128, 112, 64, 64, 64, f32, False, "parity prefill")
    ssd_case(8, 16, 112, 64, 64, 64, f32, False, "one chunk")
    ssd_case(2, 96, 112, 64, 64, 32, f32, False, "ragged chunks")
    # the stress row's draw on which the earlier criterion (one bf16 ulp of
    # the f32 plain value beyond 2e-4) failed this kernel by 2.480e-04: three
    # rows then drew from g ahead of it (they draw from g_new now), moving g
    # on by the Philox offset their draws take
    ahead = torch.Generator(device=dev).manual_seed(seed)
    if hasattr(ahead, "set_offset"):
        start = ahead.get_offset()
        for P_, K_, D_ in ((128, 8, 3072), (8, 4, 36004)):
            torch.randn(P_ * K_, D_, generator=ahead, device=dev)
            torch.randint(0, K_ + 1, (P_,), generator=ahead, device=dev)
        torch.randn(2000, 260, generator=ahead, device=dev)
        torch.randn(16, 260, generator=ahead, device=dev)
        run21 = torch.Generator(device=dev).manual_seed(seed)
        run21.set_offset(g.get_offset() + ahead.get_offset() - start)
        ssd_case(1, 4096, 112, 64, 64, 64, bf16, False,
                 "stress (the earlier criterion's failing draw)", gen=run21)
    else:
        print("check: mamba2_ssd the earlier criterion's failing draw: not "
              "replayed (this torch's generator has no set_offset)",
              flush=True)
    ssd_case(1, 4096, 112, 64, 64, 64, bf16, False, "stress")
    rwkv_case(8, 128, 32, 64, 64, 64, bf16, True, "prefill")
    rwkv_case(8, 128, 32, 64, 64, 64, f32, False, "parity prefill")
    rwkv_case(8, 16, 32, 64, 64, 64, f32, False, "one chunk")
    rwkv_case(2, 96, 32, 64, 64, 32, f32, False, "ragged chunks")
    rwkv_case(1, 4096, 32, 64, 64, 64, bf16, False, "stress")
    # bf16 edge rows, which only the tensor-core kernels reach: one chunk of
    # 16 or of 40 rows in a 64-row tile, ragged chunks of 32, dims padded
    # to 48 (and to a multiple of 8 by the wrapper for P = N = 40), and
    # rwkv6's strong (w ~ N(1.5, 0.5)) and slow (N(-6, 0.5)) decays
    ssd_case(8, 16, 112, 64, 64, 64, bf16, False, "one chunk")
    ssd_case(2, 40, 112, 64, 64, 64, bf16, False, "T=40")
    ssd_case(2, 96, 112, 64, 64, 32, bf16, False, "ragged chunks")
    ssd_case(2, 128, 8, 40, 40, 64, bf16, False, "P=N=40")
    rwkv_case(8, 16, 32, 64, 64, 64, bf16, False, "one chunk")
    rwkv_case(2, 40, 32, 64, 64, 64, bf16, False, "T=40")
    rwkv_case(2, 96, 32, 64, 64, 32, bf16, False, "ragged chunks")
    rwkv_case(2, 128, 8, 40, 40, 64, bf16, False, "K=V=40")
    rwkv_case(8, 128, 32, 64, 64, 64, bf16, False, "strong decay w~N(1.5,0.5)",
              w_mean=1.5)
    rwkv_case(8, 128, 32, 64, 64, 64, bf16, False, "slow decay w~N(-6,0.5)",
              w_mean=-6.0)
    # float32 at K = V = 128: 247 KB of shared memory with the state, past
    # 227 KB, so the kernel carries the state in global memory (the final
    # state's output); drawn from g_new
    rwkv_case(2, 128, 4, 128, 128, 64, f32, False, "state in global memory",
              gen=g_new)
    # the sharded_ssm phase's per-position shapes at (2, 2) and (1, 16),
    # from a generator of their own so that the rows after them draw what
    # they drew before
    g_ssm = torch.Generator(device=dev).manual_seed(seed + 29)
    ssd_case(4, 512, 56, 64, 64, 64, bf16, True, "zamba2-7b model=2 shard",
             gen=g_ssm)
    ssd_case(8, 512, 7, 64, 64, 64, bf16, True, "zamba2-7b model=16 shard",
             gen=g_ssm)
    rwkv_case(4, 512, 16, 64, 64, 64, bf16, True, "rwkv6-1.6b model=2 shard",
              gen=g_ssm)
    rwkv_case(8, 512, 2, 64, 64, 64, bf16, True, "rwkv6-1.6b model=16 shard",
              gen=g_ssm)
    # one call of each bf16 scan at its main shape is one device launch
    x = torch.randn(8, 128, 112, 64, generator=g, device=dev).to(bf16)
    dts = F.softplus(torch.randn(8, 128, 112, generator=g, device=dev))
    A = -torch.linspace(1.0, 16.0, 112, device=dev)
    bc = torch.randn(8, 128, 64, generator=g, device=dev).to(bf16)
    s0 = torch.zeros(8, 112, 64, 64, device=dev)
    r = torch.randn(8, 128, 32, 64, generator=g, device=dev).to(bf16)
    w = -0.5 + 0.5 * torch.randn(8, 128, 32, 64, generator=g, device=dev)
    u = torch.zeros(32, 64, device=dev).to(bf16)
    s1 = torch.zeros(8, 32, 64, 64, device=dev)
    for name, call, kern in (
            ("mamba2_ssd", lambda: mamba2_ssd(x, dts, A, bc, bc, s0), "ssd_bf16"),
            ("rwkv6_scan", lambda: rwkv6_scan(r, r, r, w, u, s1), "wkv_bf16")):
        names = device_events(torch, call)
        print(f"check: {name} bf16 main shape launches per call={len(names)} "
              f"({', '.join(n[:60] for n in names)})", flush=True)
        need(len(names) == 1 and kern in names[0],
             f"{name}: one bf16 call made {len(names)} device launches")

    # one call of each forest kernel at its main shapes is one device launch
    def unit(*shape):
        return ref.normalize_rows(torch.randn(*shape, generator=g, device=dev))
    mask8 = torch.ones(128, 8, device=dev)
    for what, kern, args, kw in (
            ("tree_refresh 128x8x256", "refresh",
             (unit(128 * 8, 256).reshape(128, 8, 256), mask8), {}),
            ("tree_refresh 128x8x4096", "refresh",
             (unit(128 * 8, 4096).reshape(128, 8, 4096), mask8), {}),
            ("topk_sim 64x1024x256 num_valid=675", "topk_sim",
             (unit(64, 256), unit(1024, 256), 24),
             dict(normalize=False, num_valid=675)),
            ("topk_sim 32x1024x4096", "topk_sim",
             (unit(32, 4096), unit(1024, 4096), 24), dict(normalize=False))):
        fn = tree_refresh if kern == "refresh" else topk_sim
        names = device_events(torch, lambda: fn(*args, **kw))
        print(f"check: {what} launches per call={len(names)} "
              f"({', '.join(n[:50] for n in names)})", flush=True)
        need(len(names) == 1 and kern in names[0],
             f"{what}: one call made {len(names)} device launches")
    for what, call in (
            ("browse_scores 1024x8x256 packed",
             lambda: browse_scores(*packed_call)),
            ("browse_scores gather slice level 512x8x256",
             lambda: browse_scores_rows(*slice_call))):
        names = device_events(torch, call)
        print(f"check: {what} launches per call={len(names)} "
              f"({', '.join(n[:50] for n in names)})", flush=True)
        need(len(names) == 1 and "browse" in names[0],
             f"{what}: one call made {len(names)} device launches")
    q, keys, k, nv = baseline_call
    what = f"topk_sim baselines 1x{keys.shape[0]}x256 num_valid={nv}"
    names = device_events(torch, lambda: topk_sim(q, keys, k, normalize=False,
                                                  num_valid=nv))
    print(f"check: {what} launches per call={len(names)} "
          f"({', '.join(n[:50] for n in names)})", flush=True)
    need(len(names) == 1 and "topk_sim" in names[0],
         f"{what}: one call made {len(names)} device launches")
    # whisper's encoder row and olmoe's decode row: one launch a call
    for what, kern, call in (
            ("flash_attention whisper encoder 8x1500x8/8x64 full",
             "flash_attention",
             lambda: flash_attention(*whisper_call, causal=False)),
            ("decode_attention olmoe decode 8x512x16/16x128",
             "decode_attention", lambda: decode_attention(*olmoe_call))):
        names = device_events(torch, call)
        print(f"check: {what} launches per call={len(names)} "
              f"({', '.join(n[:50] for n in names)})", flush=True)
        need(len(names) == 1 and kern in names[0],
             f"{what}: one call made {len(names)} device launches")
    return results


# the gradient of flash_attention: (B, S, Hq, Hkv, D, causal, dtype name,
# main, what). The first row is the train phase's shape; the smoke shape is
# train_parity's (llama3-8b's smoke config in microbatches of 2). The last
# three (last, so the rows before them draw the inputs they drew without
# them): a head dim the tensor maps pad (20 -> 24) and one whose last panel
# is 16 wide (72), a group of 128 (two head chunks of 64); then zamba2's
# shared attention in the train_zamba2 phase (head dim 112: seven k16 steps
# a product).
# decode_attention_lse at the sharded_serve phase's shards: (B, Smax, Hq,
# Hkv, D, lengths from, to, dtype, main, what). The heads form on one card's
# (2, 2) mesh: a position's data shard (8 / 2 rows) and its heads (32 / 2
# query, 8 / 2 KV) over a 4096-row cache, lengths from the 512-token prompt
# through 32 steps. The sequence form on (1, 16): every head over a
# position's 256 rows (two chunks of 128 rows; lengths clamped to the
# shard), a shard of 64 rows (Smax / m below one chunk: one split), and a
# position whose rows hold no valid entry. The four-card
# (2, 2) shard of decode_32k at batch 24. The float32 rows: the smoke
# configs' card-against-CPU run, llama3-8b's smoke shard on (1, 4); then a
# float32 shard of four chunks with at least two live, so that the split
# merge writes the float32 lse (its m in natural units, scaled by log2 e).
DECODE_LSE_ROWS = (
    (4, 4096, 16, 4, 128, 513, 544, "bf16", True, "heads-form shard"),
    (8, 256, 32, 8, 128, 0, 256, "bf16", True, "sequence-form shard"),
    (8, 64, 32, 8, 128, 0, 64, "bf16", False, "shard below one chunk"),
    (8, 256, 32, 8, 128, 0, 0, "bf16", True, "shard with no valid row"),
    (12, 32768, 16, 4, 128, 32705, 32768, "bf16", True, "four-card shard"),
    (4, 16, 4, 2, 16, 0, 16, "f32", False, "smoke sequence-form shard"),
    (4, 512, 4, 2, 16, 129, 512, "f32", False, "f32 split-merge shard"),
    (8, 4, 8, 8, 64, 0, 4, "bf16", True, "whisper-base model=16 shard"),
)
# whisper-base's sequence form at model = 16: every head of all 8 rows over
# a position's 4 of the 64 cache rows (lengths 17-48 clamped to the shard).
# the attention of the sharded_train phase at a model width of 2: (B, S,
# Hq, Hkv, D, what), one position's data shard and heads
SHARD_ATTENTION = ((4, 512, 16, 4, 128, "llama3-8b model=2 shard"),
                   (4, 512, 8, 8, 128, "olmoe-1b-7b model=2 shard"),
                   (4, 512, 16, 16, 112, "zamba2-7b model=2 shard"))
# the sharded_whisper phase at model = 2: (B, S, Hq, Hkv, D, causal, what)
WHISPER_SHARD_ATTENTION = (
    (4, 1500, 4, 4, 64, False, "whisper-base model=2 encoder shard"),
    (4, 448, 4, 4, 64, True, "whisper-base model=2 decoder shard"))
BWD_ROWS = (
    (8, 512, 32, 32, 96, True, "bf16", True, "phi3 train"),
    (8, 512, 32, 8, 128, True, "bf16", False, "llama GQA"),
    (8, 1500, 8, 8, 64, False, "bf16", False, "whisper encoder"),
    (2, 64, 4, 2, 16, True, "f32", True, "smoke"),
    (2, 100, 8, 2, 64, True, "f32", False, "ragged"),
    (2, 100, 8, 2, 64, False, "bf16", False, "ragged"),
    (3, 1, 4, 2, 128, True, "f32", False, "one position"),
    (3, 1, 4, 2, 128, True, "bf16", False, "one position"),
    (2, 33, 8, 8, 20, True, "bf16", False, "head dim padded to 24"),
    (2, 77, 8, 2, 72, True, "bf16", False, "head dim 72"),
    (1, 40, 128, 1, 64, True, "bf16", False, "group of 128"),
    (8, 512, 32, 32, 112, True, "bf16", True, "zamba2 train"),
    (4, 512, 16, 4, 128, True, "bf16", True, "llama3-8b model=2 shard"),
    (4, 512, 8, 8, 128, True, "bf16", True, "olmoe-1b-7b model=2 shard"),
    (4, 512, 16, 16, 112, True, "bf16", True, "zamba2-7b model=2 shard"),
    (4, 1500, 4, 4, 64, False, "bf16", True,
     "whisper-base model=2 encoder shard"),
    (4, 448, 4, 4, 64, True, "bf16", True,
     "whisper-base model=2 decoder shard"),
)
# the forward's log-sum-exp (log2 units) against attention_lse_ref: f32, the
# same CUDA-core sums as the output; bf16, the tensor cores' f32 sums of D
# exact products in another order: at |q.k| <= 4 sqrt(D) for N(0, 1) inputs,
# D adds of at most one f32 ulp each, times log2(e)/sqrt(D), stay under 1e-4
LSE_TOL = {"f32": 1e-5, "bf16": 1e-4}


def check_attention_bwd(torch, peaks, seed: int):
    """``flash_attention_bwd`` against ``attention_bwd_ref`` on the card at
    ``BWD_ROWS``, o and lse from the forward kernel (``flash_attention_lse``;
    its lse held to ``attention_lse_ref`` within ``LSE_TOL``, its o equal to
    the inference launch's) and dO from a seeded generator. f32: max|err| <=
    1e-4 of the largest |plain| of the three gradients; bf16: within one
    bf16 ulp of the plain version run in float64 on the same inputs, plus
    ``BWD_TC_EXCESS`` of that largest value (``bwd_excess``). Two calls
    give equal bits; one call is two device launches (bf16: ``bwd_dq_tc``,
    then ``bwd_dkv_tc``). The library call is SDPA's forward and backward,
    timed for comparison."""
    from repro_torch.kernels import costs, ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_lse)
    F = torch.nn.functional
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    results = {}
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    last = None
    for B, S, Hq, Hkv, D, causal, dt_name, main, what in BWD_ROWS:
        dt = dts[dt_name]
        q = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dt)
        do = torch.randn(B, S, Hq, D, generator=g, device=dev).to(dt)
        with torch.no_grad():
            o, lse = flash_attention_lse(q, k, v, causal=causal)
            o_inf = flash_attention(q, k, v, causal=causal)
        label = (f"{what} {B}x{S}x{Hq}/{Hkv}x{D} "
                 f"{'causal' if causal else 'full'} {dt_name}")
        need(torch.equal(o, o_inf), f"flash_attention {label}: the output "
             "differs when the launch also writes lse")
        lse_err = (lse - ref.attention_lse_ref(q, k, causal=causal)
                   ).abs().max().item()
        print(f"check: flash_attention {label} lse max_abs_err={lse_err:.3e} "
              f"(tol {LSE_TOL[dt_name]:.0e})", flush=True)
        need(lse_err <= LSE_TOL[dt_name], f"flash_attention {label}: lse "
             f"differs from attention_lse_ref by {lse_err:.3e}")
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"flash_attention_bwd {label}: two calls differ")
        need(all(t.dtype == dt and bool(torch.isfinite(t).all())
                 for t in got), f"flash_attention_bwd {label}: not finite "
             "or not in the inputs' type")
        plain = ref.attention_bwd_ref(q, k, v, o, do, causal=causal)
        if dt == torch.float32:
            top = max(w.abs().max().item() for w in plain)
            err = max((a - w).abs().max().item() for a, w in zip(got, plain))
            need(err <= 1e-4 * top, f"flash_attention_bwd {label}: max err "
                 f"{err:.3e} > 1e-4 x {top:.3e}")
            tol = 1e-4
        else:
            want = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o,
                                                                do)),
                                         causal=causal)
            top = max(w.abs().max().item() for w in want)
            excess = max(bwd_excess(a, w, top) for a, w in zip(got, want))
            print(f"check: flash_attention_bwd {label} excess over one bf16 "
                  f"ulp = {excess:.3e} of max|ref| {top:.3e} "
                  f"(tol {BWD_TC_EXCESS:.0e})", flush=True)
            need(excess <= BWD_TC_EXCESS, f"flash_attention_bwd {label}: "
                 f"{excess:.3e} beyond one bf16 ulp (tol {BWD_TC_EXCESS})")
            err = max((a.double() - w).abs().max().item()
                      for a, w in zip(got, want))
            tol = BWD_TC_EXCESS
            del want
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def library():     # timed for comparison; the port never calls it
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
            return torch.autograd.grad(out, (qt, kt, vt), dot)
        lib = [x.transpose(1, 2) for x in library()]
        lib_err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(lib, plain))
        need(lib_err <= 5e-2 * top + 5e-2, f"flash_attention_bwd {label}: "
             f"the library call differs by {lib_err:.3e}")
        pairs = S * (S + 1) // 2 if causal else S * S
        elem = q.element_size()
        # bytes: q, k, v, o, dO and lse read once, dq, dk, dv written once;
        # operations: the five products S, dP, dq, dk and dv
        record_row(torch, peaks, results, "flash_attention_bwd", label, err,
                   tol, lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal=causal),
                   lambda: ref.attention_bwd_ref(q, k, v, o, do,
                                                 causal=causal),
                   (4 * B * S * Hq * D + 4 * B * S * Hkv * D) * elem
                   + 4 * B * Hq * S,
                   costs.attention_bwd_ops(B, S, Hq, D, causal), main,
                   library,
                   "bf16" if dt == torch.bfloat16 else "fp32")
        if what == "phi3 train":
            last = (q, k, v, o, lse, do)
        del plain, lib
    names = device_events(torch, lambda: flash_attention_bwd(*last))
    print(f"check: flash_attention_bwd phi3 train launches per call="
          f"{len(names)} ({', '.join(n[n.rfind('bwd_'):][:40] for n in names)})",
          flush=True)
    need(len(names) == 2 and "bwd_dq_tc" in names[0]
         and "bwd_dkv_tc" in names[1],
         f"flash_attention_bwd: one call made {len(names)} device launches")
    return results


# the scans' backward kernels' check rows: (kernel, B, T, H, P or K, N or
# V, type, main, what, rwkv6's w ~ N(mean, 0.5)). The first row of each
# kernel is its train phase's shape, the smoke rows train_parity's
# (zamba2-smoke: 8 SSD heads of 16, N = 16; rwkv6-smoke: 4 heads of 16),
# the ragged rows one chunk of 40 with dims 20 and 72 (the bf16 forward
# pads 20 to 24 and trims the chunk states back). rwkv6's rows at K = V =
# 128 take the working sets from global scratch (in f32 270 KB do not fit
# in shared memory; in bf16 the log-decay sums and the exchange tiles), and
# the f32 forward carries its state in global memory there (247 KB); then
# the forward's strong and slow decays. The f32 row at K = V = 128 and
# mamba2's bf16 row at P = N = 128 (one stage of copies, S0 from global
# memory, no cluster: the bf16 kernel's form for the widest dims) come
# last, so the rows before them draw the inputs they drew without them.
SCAN_BWD_ROWS = (
    ("mamba2_ssd", 8, 512, 112, 64, 64, "bf16", True, "zamba2 train", None),
    ("mamba2_ssd", 4, 128, 8, 16, 16, "f32", True, "smoke", None),
    ("mamba2_ssd", 2, 40, 4, 20, 72, "f32", False, "ragged", None),
    ("mamba2_ssd", 2, 40, 4, 72, 20, "bf16", False, "ragged", None),
    ("rwkv6_scan", 8, 512, 32, 64, 64, "bf16", True, "rwkv6 train", -0.5),
    ("rwkv6_scan", 4, 128, 4, 16, 16, "f32", True, "smoke", -0.5),
    ("rwkv6_scan", 2, 40, 4, 20, 72, "f32", False, "ragged", -0.5),
    ("rwkv6_scan", 2, 40, 4, 72, 20, "bf16", False, "ragged", -0.5),
    ("rwkv6_scan", 2, 128, 4, 128, 128, "bf16", False, "global working set",
     -0.5),
    ("rwkv6_scan", 2, 128, 32, 64, 64, "bf16", False, "strong decay", 1.5),
    ("rwkv6_scan", 2, 128, 32, 64, 64, "bf16", False, "slow decay", -6.0),
    ("rwkv6_scan", 2, 128, 4, 128, 128, "f32", False, "global working set",
     -0.5),
    ("mamba2_ssd", 2, 128, 4, 128, 128, "bf16", False, "P=N=128", None),
    # the sharded_ssm phase's per-position shapes: (2, 2) and (1, 16)
    ("mamba2_ssd", 4, 512, 56, 64, 64, "bf16", True,
     "zamba2-7b model=2 shard", None),
    ("mamba2_ssd", 8, 512, 7, 64, 64, "bf16", True,
     "zamba2-7b model=16 shard", None),
    ("rwkv6_scan", 4, 512, 16, 64, 64, "bf16", True,
     "rwkv6-1.6b model=2 shard", -0.5),
    ("rwkv6_scan", 8, 512, 2, 64, 64, "bf16", True,
     "rwkv6-1.6b model=16 shard", -0.5),
)


def scan_bwd_inputs(torch, kernel, g, B, T, H, d1, d2, dt, w_mean=-0.5):
    """A scan's inputs (the forward checks' distributions, a nonzero
    initial state), the output's cotangent and a nonzero final-state
    cotangent, from ``g`` on the card."""
    dev = "cuda"

    def n(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    if kernel == "mamba2_ssd":
        args = [n(B, T, H, d1).to(dt), torch.nn.functional.softplus(n(B, T, H)),
                -torch.linspace(1.0, 16.0, H, device=dev), n(B, T, d2).to(dt),
                n(B, T, d2).to(dt), 0.1 * n(B, H, d1, d2)]
        return args, n(B, T, H, d1).to(dt), n(B, H, d1, d2)
    args = [n(B, T, H, d1).to(dt), n(B, T, H, d1).to(dt), n(B, T, H, d2).to(dt),
            w_mean + 0.5 * n(B, T, H, d1), (0.1 * n(H, d1)).to(dt),
            0.1 * n(B, H, d1, d2)]
    return args, n(B, T, H, d2).to(dt), n(B, H, d1, d2)


def scan_chunk_states(plain, args, chunk=64):
    """The state entering each chunk, (B, H, nc, ., .), from the plain
    forward run chunk by chunk on ``args``."""
    import torch
    T = args[0].shape[1]
    c = min(chunk, T)
    out, s = [], args[5]
    for t0 in range(0, T, c):
        out.append(s)
        part = [a[:, t0:t0 + c] if a.dim() >= 3 else a for a in args[:5]]
        _, s = plain(*part, s, chunk=c)
    return torch.stack(out, dim=2)


def scan_bwd_cost(kernel, B, T, H, d1, d2, elem, peaks, op):
    """(bytes, operations, their type) of one backward call: each input
    read once (the chunk states included) and each output written once
    (dB, dC and du after their sums); the products at the inputs' type, the
    gate's exponentials (rwkv6) at float32's, whichever takes longer."""
    from repro_torch.kernels import costs
    C = min(64, T)
    nc = T // C
    if kernel == "mamba2_ssd":
        P, N = d1, d2
        nbytes = (3 * B * T * H * P + 4 * B * T * N) * elem + 2 * B * T * H * 4 \
            + 2 * H * 4 + B * H * nc * P * N * 4 + 2 * B * H * P * N * 4
        return nbytes, costs.ssd_bwd_ops(B, T, H, P, N), op
    K, V = d1, d2
    nbytes = (3 * B * T * H * K + 3 * B * T * H * V + 2 * H * K) * elem \
        + 2 * B * T * H * K * 4 + B * H * nc * K * V * 4 + 2 * B * H * K * V * 4
    prods = costs.rwkv_bwd_ops(B, T, H, K, V)
    exps = costs.rwkv_bwd_exps(B, T, H, K)
    if exps / peaks["fp32"] > prods / peaks[op]:
        return nbytes, exps, "fp32"
    return nbytes, prods, op


def check_scan_bwd(torch, peaks, seed: int):
    """``mamba2_ssd_bwd`` and ``rwkv6_scan_bwd`` against their plain
    versions run in float64 on the card at ``SCAN_BWD_ROWS``, with nonzero
    initial states and final-state cotangents, the chunk states from the
    forward kernel's training launch (its output and final state equal to
    the inference launch's, its chunk states within ``SCAN_BWD_TOL["f32"]``
    of the plain forward's): each kind of output within ``SCAN_BWD_TOL``
    (``scan_bwd_errors``). Two calls give equal bits (the cross-block sums
    are per-block partials summed in one order); one call at the main shape
    launches the kernel once. No single PyTorch call computes either
    gradient: library_ms is none."""
    from repro_torch.kernels import mamba2_ssd as M
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as R
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    mods = {"mamba2_ssd": (M, M.mamba2_ssd, M.mamba2_ssd_bwd,
                           ref.mamba2_ssd_chunked, ref.mamba2_ssd_bwd_ref,
                           "ssd_bwd_bf16_kernel"),
            "rwkv6_scan": (R, R.rwkv6_scan, R.rwkv6_scan_bwd,
                           ref.rwkv6_chunked, ref.rwkv6_scan_bwd_ref,
                           "wkv_bwd_bf16_kernel")}
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    ops = {"bf16": "bf16", "f32": "fp32"}
    results, mains = {}, {}
    for kernel, B, T, H, d1, d2, dt_name, main, what, w_mean in SCAN_BWD_ROWS:
        mod, fwd, bwd, plain, plain_bwd, kern = mods[kernel]
        dt = types[dt_name]
        args, dout, ds = scan_bwd_inputs(torch, kernel, g, B, T, H, d1, d2, dt,
                                         w_mean)
        label = f"{what} {B}x{T}x{H}x{d1}x{d2} {dt_name}" + (
            f" w~N({w_mean},0.5)" if w_mean not in (None, -0.5) else "")
        name = kernel + "_bwd"
        with torch.no_grad():
            y, s, states = mod._forward(*args, ref.scan_chunk(kernel, T),
                                        keep_states=True)
            y_inf, s_inf = fwd(*args)
        need(torch.equal(y, y_inf) and torch.equal(s, s_inf), f"{kernel} "
             f"{label}: the output differs when the launch also writes the "
             "chunk states")
        want_states = scan_chunk_states(plain, [a.double() for a in args])
        st_err = ((states.double() - want_states).abs().max()
                  / want_states.abs().max()).item()
        need(st_err <= SCAN_BWD_TOL["f32"], f"{kernel} {label}: chunk "
             f"states differ from the plain forward's by {st_err:.3e}")
        del want_states

        def call(bwd=bwd, args=args, dout=dout, ds=ds, states=states):
            return bwd(*args, dout, ds, states=states)
        got, again = call(), call()
        torch.cuda.synchronize()
        need(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"{name} {label}: two calls differ")
        need(all(a.dtype == t.dtype and a.shape == t.shape
                 and bool(torch.isfinite(a.float()).all())
                 for a, t in zip(got, args)), f"{name} {label}: not finite, "
             "or not in the inputs' types and shapes")
        want = plain_bwd(*(a.double() for a in args), dout.double(),
                         ds.double())
        worst = scan_bwd_errors(kernel, got, want, args)
        print(f"check: {name} {label} chunk states {st_err:.3e}; " + " ".join(
            f"{k}={e:.3e} (tol {SCAN_BWD_TOL[k]:.0e})"
            for k, e in sorted(worst.items())), flush=True)
        need(all(e <= SCAN_BWD_TOL[k] for k, e in worst.items()),
             f"{name} {label}: beyond its tolerance: {worst}")
        err = max((a.double() - w).abs().max().item()
                  for a, w in zip(got, want))
        del want, again
        nbytes, flops, op = scan_bwd_cost(kernel, B, T, H, d1, d2,
                                          args[0].element_size(), peaks,
                                          ops[dt_name])
        record_row(torch, peaks, results, name, label, err, None, call,
                   lambda: plain_bwd(*args, dout, ds), nbytes, flops, main,
                   None, op)
        if main and name not in mains:
            mains[name] = (call, kern)
        del got
    for name, (call, kern) in mains.items():
        names = device_events(torch, call)
        hits = sum(1 for n in names if kern in n)
        print(f"check: {name} main shape launches per call: {hits} of "
              f"{kern} ({len(names)} device operations with the wrapper's "
              "sums and casts)", flush=True)
        need(hits == 1, f"{name}: one call launched {kern} {hits} times")
    return results


def bf16_ulp(t):
    mag = t.abs().clamp_min(2.0 ** -126)
    return (mag.log2().floor() - 7).exp2()


def bwd_excess(out, want64, top) -> float:
    """How far a bf16 gradient ``out`` lies beyond one bf16 ulp of
    ``want64``, the plain ``attention_bwd_ref`` run in float64 on the same
    bf16 inputs, as a share of ``top``, the largest |want64| of the call's
    three gradients (at S = 1 dq and dk are 0 up to rounding): the kernel
    passes at <= ``BWD_TC_EXCESS`` (bf16 P and dS before their products,
    float32 sums in another order; the ulp covers the output's one
    rounding). tests/test_torch_attention_design.py pins the constant
    against an emulation of the kernel's schedule."""
    w = want64.double()
    return ((out.double() - w).abs() - bf16_ulp(w)).max().item() / top


def bf16_scan_excess(out, plain, args, signed, chunk=64) -> float:
    """How far a bf16 scan output ``out`` of ``plain``'s scan on ``args``
    lies beyond its criterion (it passes at <= 0): |out - w| - (one bf16 ulp
    of w + SCAN_C * 2^-24 * T), w the plain version run in float64 on the
    same inputs, T the same run on the absolute values of the inputs at
    ``signed`` (the decays are positive already): the size of the terms each
    output sums. The ulp covers the output's one rounding, SCAN_C * 2^-24 *
    T the float32 evaluation's error (tests/test_torch_scan_design.py pins
    SCAN_C)."""
    want64, _ = plain(*(a.double() for a in args), chunk=chunk)
    terms, _ = plain(*(a.double().abs() if i in signed else a.double()
                       for i, a in enumerate(args)), chunk=chunk)
    slack = bf16_ulp(want64) + SCAN_C * 2.0 ** -24 * terms
    return ((out.double() - want64).abs() - slack).max().item()


# the scans' backward kernels against a float64 run of their plain versions
# (``scan_bwd_errors``), the worst of each kind of output over a call.
# "f32": a float32 output's error over its largest |value|. The kernels sum
# in float32 in another order than the plain version, and ddt carries A
# revcumsum(dcum), whose row and column sums of the pairs' terms cancel, so
# at A = -16 it loses more than the other outputs: 2e-4. "bf16": a bf16
# output's excess over one bf16 ulp, over its largest |value|: computed in
# float32 and rounded once, only the float32 error shows beyond the ulp:
# 2e-5. "sum": dA's error over the size of the B T terms it sums, which
# cancel to a value far below them: 1e-5. tests/test_torch_scan_design.py
# holds the kernels' emulated schedules within these.
SCAN_BWD_TOL = {"f32": 2e-4, "bf16": 2e-5, "sum": 1e-5}


def scan_bwd_errors(kernel, got, want64, args) -> dict:
    """How far a scan backward's outputs ``got`` lie from ``want64``, its
    plain version run in float64 on the same inputs ``args``: per kind of
    output, the worst share (``SCAN_BWD_TOL`` bounds each). All sums run in
    float32 in another order than the plain version's, and a bf16 output is
    rounded once more; dA (mamba2) sums dt_t revcumsum(dcum)_t over batch
    and time, terms that cancel to a value far below them, so its error is
    taken over their size, sum_{b,t} |dt ddt| / |A| per head."""
    worst = {}
    for i, (g, w) in enumerate(zip(got, want64)):
        w = w.double()
        err = (g.double() - w).abs()
        if kernel == "mamba2_ssd" and i == 2:
            dt, A = args[1].double(), args[2].double()
            terms = (dt * want64[1].double()).abs().sum(dim=(0, 1)) / A.abs()
            kind, e = "sum", (err / terms).max().item()
        elif g.element_size() == 2:                      # bf16
            kind = "bf16"
            e = (err - bf16_ulp(w)).max().item() / w.abs().max().item()
        else:
            kind, e = "f32", err.max().item() / w.abs().max().item()
        worst[kind] = max(worst.get(kind, 0.0), e)
    return worst


def ssd_flops(B, T, H, P, N, C) -> int:
    """Operations the chunked SSD needs (``kernels.costs.ssd_ops``)."""
    from repro_torch.kernels import costs
    return costs.ssd_ops(B, T, H, P, N, C)


def rwkv_flops(B, T, H, K, V, C) -> int:
    """Operations the chunked WKV6 needs (``kernels.costs.rwkv_ops``)."""
    from repro_torch.kernels import costs
    return costs.rwkv_ops(B, T, H, K, V, C)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def make_slice_workload(seed: int):
    from repro_torch.data.synthetic import make_workload
    return make_workload(num_entities=16, num_sessions=500,
                         transitions_per_entity=4, distractor_turns=20,
                         num_queries=64, seed=seed)


def run_slice(torch, wl, device, obs=None):
    from repro_torch import MemForestSystem

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    mf = MemForestSystem(device=device, obs=obs)
    t0 = time.perf_counter()
    for i in range(0, len(wl.sessions), 16):
        mf.ingest_batch(wl.sessions[i:i + 16])
    sync()
    ingest_s = time.perf_counter() - t0
    answers, query_s = {}, {}
    for mode in MODES:
        t0 = time.perf_counter()
        res = mf.query_batch(wl.queries, mode=mode)
        sync()
        query_s[mode] = time.perf_counter() - t0
        answers[mode] = [(r.answer, r.evidence) for r in res]
    return mf, answers, ingest_s, query_s


def compare_systems(a, b, answers_a, answers_b) -> str:
    """Exact facts, tree structure, placement, answers and evidence;
    embeddings within 1e-5. Returns a one-line summary."""
    fa, fb = a.forest, b.forest
    need([(f.fact_id, f.text, f.value) for f in fa.facts]
         == [(f.fact_id, f.text, f.value) for f in fb.facts], "facts differ")
    need([c.text for c in fa.cells] == [c.text for c in fb.cells],
         "cells differ")
    need(a.scale_stats() == b.scale_stats(), "scale_stats differ")
    need(list(fa.trees) == list(fb.trees), "tree sets differ")
    emb_err = 0.0
    for key, ta in fa.trees.items():
        tb = fb.trees[key]
        need(ta.children == tb.children and ta.level == tb.level
             and ta.root == tb.root, f"tree {key} differs")
        n = len(ta.level)
        if n:           # a tree compacted to no nodes has no rows
            emb_err = max(emb_err,
                          float(np.abs(ta.emb[:n] - tb.emb[:n]).max()))
    need(emb_err <= 1e-5, f"node embeddings differ by {emb_err}")
    nt = len(fa._tree_order)
    root_err = float(np.abs(fa._root_matrix[:nt] - fb._root_matrix[:nt]).max())
    need(root_err <= 1e-5, f"root index differs by {root_err}")
    need(fa.placement == fb.placement, "placement differs")
    need(fa.session_registry == fb.session_registry,
         "session registry differs")
    for mode in MODES:
        need(answers_a[mode] == answers_b[mode],
             f"answers or evidence differ in mode {mode}")
    return (f"node_emb_err={emb_err:.3e} root_err={root_err:.3e} "
            f"trees={len(fa.trees)} modes={len(MODES)}")


def browse_spans(phase, sink) -> None:
    """The browse's spans of one phase: ``retrieve.browse`` (a browse,
    arena sync and query upload included), ``forest.node_arena`` (the
    arena's scatters) and ``retrieve.browse_scores`` (a level: its upload,
    launch and read-back) by padded frontier size, with the mean frontier."""
    recs = sink.spans()
    for name in ("retrieve.browse", "forest.node_arena"):
        got = [r["dur_s"] for r in recs if r["name"] == name]
        print(f"{phase}: span {name} n={len(got)} total_s={sum(got):.6f}")
    levels = {}
    for r in recs:
        if r["name"] == "retrieve.browse_scores":
            a = r.get("attrs") or {}
            levels.setdefault(a.get("padded"), []).append(
                (r["dur_s"], a.get("frontier")))
    total = sum(d for v in levels.values() for d, _ in v)
    print(f"{phase}: span retrieve.browse_scores n="
          f"{sum(map(len, levels.values()))} total_s={total:.6f} " + " ".join(
              f"padded={p}: n={len(v)} mean_s={sum(d for d, _ in v) / len(v):.6f} "
              f"mean_frontier={sum(f for _, f in v) / len(v):.1f}"
              for p, v in sorted(levels.items())), flush=True)


def check_level_upload(torch, mf, wl) -> None:
    """One browse level of the slice moves neither children nor a query
    matrix to the card: the largest level of an llm-mode query batch,
    replayed under the profiler, makes host-to-device copies of at most
    F*K*8 + F*4 + 64 bytes (row ids, mask, lane ids; F and K padded) and
    one kernel launch."""
    from repro_torch.core import retrieval
    calls = []
    real = retrieval.Retriever._score_frontier

    def spy(self, frontier, *rest):
        calls.append((self, frontier, rest))
        return real(self, frontier, *rest)

    retrieval.Retriever._score_frontier = spy
    try:
        mf.query_batch(wl.queries, mode="llm")
    finally:
        retrieval.Retriever._score_frontier = real
    need(bool(calls), "the slice's browse scored no level")
    r, frontier, rest = max(calls, key=lambda c: len(c[1]))
    kmax = max(len(lane.tree.children[n]) for lane, n in frontier)
    F, K = 8, 4
    while F < len(frontier):
        F *= 2
    while K < kmax:
        K *= 2
    prof = profiled(torch, lambda: real(r, frontier, *rest))
    path = ROOT / "build" / "chip_smoke_level.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    copies = [(e["name"], (e.get("args") or {}).get("bytes")) for e in events
              if e.get("cat") == "gpu_memcpy"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    h2d = [b for n, b in copies if "HtoD" in n]
    limit = F * K * 8 + F * 4 + 64
    print(f"slice: one browse level F={len(frontier)} padded {F}x{K}: "
          f"host-to-device copies {h2d} bytes (limit {limit}), all copies "
          f"{copies}, kernels {[k[:40] for k in kernels]}", flush=True)
    need(bool(h2d) and all(b is not None and b <= limit for b in h2d),
         f"a browse level copied {h2d} bytes to the card (limit {limit})")
    need(len(kernels) == 1 and "browse" in kernels[0],
         f"a browse level made the device launches {kernels}")


def browse_report(torch, seed) -> None:
    """The slice and the serve phase's traffic (llama3-8b, bf16, full width
    and depth), traced, and their browse spans: ``browse_spans`` of each.
    Runs whichever ``repro_torch`` is first on ``sys.path``, so one call can
    compare two checkouts (README)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.obs import MemorySink, Observability, Tracer

    wl = make_slice_workload(seed)
    sink = MemorySink()
    run_slice(torch, wl, "cuda", Observability(tracer=Tracer(sink=sink,
                                                             enabled=True)))
    browse_spans("slice", sink)
    cfg = get_config("llama3_8b")
    params = T.init_params(cfg, seed, device="cuda")
    sink = MemorySink()
    engine, tok = build_engine(cfg, params, "cuda", Observability(
        tracer=Tracer(sink=sink, enabled=True)))
    serve_traffic(torch, engine, decode_prompts(wl, tok, DECODE_PROMPTS),
                  wl.sessions, wl.queries, NEW_TOKENS)
    browse_spans("serve", sink)
    del engine, params
    torch.cuda.empty_cache()


def span_totals(sink):
    out = {}
    for rec in sink.spans():
        out[rec["name"]] = out.get(rec["name"], 0.0) + rec["dur_s"]
    return out


# ---------------------------------------------------------------------------
# phase 4b: the write-path ablations of the paper's Figure 6
# ---------------------------------------------------------------------------
# -- the sharded phase ---------------------------------------------------
SHARDED_GROWTH = (64, 64, 64)   # S = 4: sessions ingested before each query
                                # round (the fact index grows after the first)
CLUSTER_CHECK = (64, 3000, 256, 16, 4)   # Q, N, D, k, S: the plans differ


def span_count(sink, name) -> int:
    return len(sink.spans(name))


def sharded_calls(sink, before):
    """Flush levels, recalls and browse depths since ``before`` (span
    counts: one ``forest.tree_refresh`` a flush level, one
    ``retrieve.recall`` a recall, one ``retrieve.browse_scores`` a browse
    depth)."""
    names = ("forest.tree_refresh", "retrieve.recall",
             "retrieve.browse_scores")
    return {n: span_count(sink, n) - before.get(n, 0) for n in names}


def check_mesh_launches(label, counts, calls, S) -> None:
    """S ``topk_sim`` launches a fact recall plus 1 for the roots, S
    ``tree_refresh`` a flush level, S ``browse_scores`` a browse depth; no
    plain version."""
    want = {"tree_refresh": S * calls["forest.tree_refresh"],
            "topk_sim": (S + 1) * calls["retrieve.recall"],
            "browse_scores": S * calls["retrieve.browse_scores"]}
    print(f"{label}: launches " + " ".join(
        f"{k}={counts[k][0]} (want {want[k]}) plain={counts[k][1]}"
        for k in SLICE_KERNELS) + f" calls={calls}", flush=True)
    for k in SLICE_KERNELS:
        need(counts[k][0] == want[k] and want[k] > 0,
             f"{label}: {k} launched {counts[k][0]} times, want {want[k]}")
        need(counts[k][1] == 0, f"{label}: {k} ran its plain version")


def same_bits(label, a, b) -> None:
    """Node embeddings and the root index equal bit for bit."""
    for key, ta in a.forest.trees.items():
        tb = b.forest.trees[key]
        n = ta._n
        need(np.array_equal(ta.emb[:n], tb.emb[:n]),
             f"{label}: tree {key}'s node embeddings differ in bits")
    nt = len(a.forest._tree_order)
    need(np.array_equal(a.forest._root_matrix[:nt],
                        b.forest._root_matrix[:nt]),
         f"{label}: the root index differs in bits")


def sharded_memory(torch, sessions, queries, mesh, obs, sink):
    """A ``MemForestSystem`` on the card with ``mesh``: the sessions in
    batches of 16, then the queries in the six modes; launch counts checked
    per call. Returns (system, answers, counts)."""
    from repro_torch import MemForestSystem, kernels

    mf = MemForestSystem(device="cuda", obs=obs)
    mf.set_mesh(mesh)
    before = sharded_calls(sink, {})
    kernels.reset_counts()
    t0 = time.perf_counter()
    for i in range(0, len(sessions), 16):
        mf.ingest_batch(sessions[i:i + 16])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    answers = {m: [(r.answer, r.evidence)
                   for r in mf.query_batch(queries, mode=m)] for m in MODES}
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0 - ingest_s
    counts = read_counts(REPLACES)
    label = (f"sharded: S={mesh.size} on "
             f"{'/'.join(str(d) for d in mesh.distinct())}")
    print(f"{label}: {len(sessions)} sessions ingest_s={ingest_s:.4f} "
          f"sessions_per_s={len(sessions) / ingest_s:.1f} six modes "
          f"query_s={query_s:.4f}", flush=True)
    check_mesh_launches(label, counts, sharded_calls(sink, before),
                        mesh.size)
    return mf, answers, counts


def add_counts(total, counts):
    for k, (n, p) in counts.items():
        n0, p0 = total.get(k, (0, 0))
        total[k] = (n0 + n, p0 + p)
    return total


def check_cluster_plan(torch) -> None:
    """A shard of a sharded index launches ``topk_sim`` with the cluster of
    the whole index's launch: at 64 queries over 3000 keys of 256 the
    index's plan takes a cluster of 2 and a shard's own rows one of 8. The
    sharded result must equal the whole index's launch bit for bit; the
    shards' own plans are run too, and how many scores they change is
    printed."""
    from repro_torch.kernels import _build, ref, shard_ops
    from repro_torch.kernels.topk_sim import plan_cluster, topk_sim
    from repro_torch.launch.mesh import DataMesh

    Q, N, D, k, S = CLUSTER_CHECK
    g = torch.Generator().manual_seed(7)
    host = torch.randn(N, D, generator=g).numpy()
    q = ref.normalize_rows(torch.randn(Q, D, generator=g).cuda())
    mesh = DataMesh(("cuda:0",) * S)
    cap = shard_ops.pad_rows(N, S)
    sk = shard_ops.upload_sharded(host, cap, mesh)
    dense = ref.normalize_rows(torch.from_numpy(
        np.pad(host, ((0, cap - N), (0, 0)))).cuda())
    v0, i0 = topk_sim(q, dense, k, normalize=False, num_valid=N)
    v1, i1 = shard_ops.sharded_topk_sim(q, sk, k, mesh=mesh, num_valid=N)
    sms = _build.sm_count(torch.device("cuda", 0))
    whole, own = plan_cluster(Q, N, D, sms), plan_cluster(Q, -(-N // S), D,
                                                         sms)
    # the shards' own plans, merged the same way
    vals, ids = [], []
    for s, shard in enumerate(sk.shards):
        v, i = topk_sim(q, shard, k, normalize=False,
                        num_valid=max(-(-(N - s) // S), 0))
        ids.append(torch.where(i >= 0, i * S + s, torch.full_like(i, -1)))
        vals.append(v)
    v2, i2 = ref.merge_topk(torch.cat(vals, 1), torch.cat(ids, 1), k)
    torch.cuda.synchronize()
    print(f"sharded: topk_sim cluster check {Q}x{N}x{D} k={k} S={S}: "
          f"clusters whole={whole} shard_own={own}; with the whole index's "
          f"cluster ids_equal={bool(torch.equal(i0, i1))} "
          f"values_equal={bool(torch.equal(v0, v1))}; with the shards' own "
          f"plans values_differing={int((v2 != v0).sum())} "
          f"ids_differing={int((i2 != i0).sum())} of {v0.numel()}",
          flush=True)
    need(whole != own, "the cluster check's plans no longer differ")
    need(torch.equal(i0, i1) and torch.equal(v0, v1),
         "sharded topk_sim differs from the whole index's launch")


def check_sharded_level_upload(torch, mf, wl) -> None:
    """One browse level of a sharded memory: one upload buffer per
    distinct device of the mesh (at most F*K*8 + F*4 + 64 bytes each, F
    padded to a power of two and a shard multiple), a ``browse_scores``
    launch per shard and at most the concatenation of their outputs."""
    from repro_torch.core import retrieval
    calls = []
    real = retrieval.Retriever._score_frontier

    def spy(self, frontier, *rest):
        calls.append((self, frontier, rest))
        return real(self, frontier, *rest)

    retrieval.Retriever._score_frontier = spy
    try:
        mf.query_batch(wl.queries, mode="llm")
    finally:
        retrieval.Retriever._score_frontier = real
    need(bool(calls), "the sharded browse scored no level")
    r, frontier, rest = max(calls, key=lambda c: len(c[1]))
    S, n_dev = mf.forest.mesh.size, len(mf.forest.mesh.distinct())
    kmax = max(len(lane.tree.children[n]) for lane, n in frontier)
    F, K = 8, 4
    while F < len(frontier):
        F *= 2
    while K < kmax:
        K *= 2
    F = -(-F // S) * S
    prof = profiled(torch, lambda: real(r, frontier, *rest))
    path = ROOT / "build" / "chip_smoke_sharded_level.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    copies = [(e["name"], (e.get("args") or {}).get("bytes")) for e in events
              if e.get("cat") == "gpu_memcpy"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    h2d = [b for n, b in copies if "HtoD" in n]
    limit = F * K * 8 + F * 4 + 64
    browse = [k for k in kernels if "browse" in k]
    others = [k for k in kernels if "browse" not in k]
    print(f"sharded: one browse level S={S} F={len(frontier)} padded {F}x{K}:"
          f" host-to-device copies {h2d} bytes (limit {limit} each, "
          f"{n_dev} buffer(s)), all copies {copies}, kernels "
          f"{[k[:40] for k in kernels]}", flush=True)
    need(len(h2d) == n_dev and all(b is not None and b <= limit for b in h2d),
         f"a sharded browse level copied {h2d} bytes to the card")
    need(len(browse) == S and len(others) <= 1
         and all("Cat" in k for k in others),
         f"a sharded browse level made the device launches {kernels}")


def serve_cli_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(" [")]


def check_serve_cli() -> None:
    """``repro_torch.launch.serve.main`` with the JAX package's default
    flags on the card, then on the CPU: the same answers."""
    import contextlib
    import io

    from repro_torch.launch import serve

    out = {}
    for argv in ([], ["--device", "cpu"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        out[tuple(argv)] = (buf.getvalue(), time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = out[()], out[("--device", "cpu")]
    acc = [ln for ln in card.splitlines() if ln.startswith("accuracy")]
    scale = [ln for ln in card.splitlines() + cpu.splitlines()
             if ln.startswith("memory scale")]
    print(f"sharded: serve CLI on the card {card_s:.2f} s, on the CPU "
          f"{cpu_s:.2f} s; {acc}; {scale}", flush=True)
    need(len(serve_cli_lines(card)) == 20,
         "the serve CLI did not answer its 20 queries")
    need(serve_cli_lines(card) == serve_cli_lines(cpu),
         "the serve CLI's answers differ between the card and the CPU")


def run_sharded(torch, wl, base, base_answers):
    """Phase 4a: the slice memory through ``DataMesh``es on the card,
    held to the slice phase's memory (mesh=None): S = 2 on the 500
    sessions; S = 4 on 64, 128 and 192 sessions, queried after each (the
    fact index grows past its first capacity: no re-upload), held to the
    192 sessions without a mesh; S = 2 over distinct cards where more than
    one is visible; then the topk_sim cluster check and the serve CLI."""
    from repro_torch import MemForestSystem
    from repro_torch.launch.mesh import DataMesh, make_data_mesh
    from repro_torch.obs import MemorySink, Observability, Tracer

    t_phase = time.perf_counter()
    total = {}
    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))

    # S = 2 on one card, the whole slice
    t0 = time.perf_counter()
    mesh = DataMesh(("cuda:0",) * 2)
    mf, answers, counts = sharded_memory(torch, wl.sessions, wl.queries,
                                         mesh, obs, sink)
    add_counts(total, counts)
    print(f"sharded: S=2 slice {time.perf_counter() - t0:.2f} s "
          f"device_bytes={mf.device_bytes()} (mesh=None "
          f"{base.device_bytes()}) matches: "
          + compare_systems(base, mf, base_answers, answers), flush=True)
    same_bits("sharded S=2", base, mf)
    check_sharded_level_upload(torch, mf, wl)
    del mf

    # S = 4 on one card: growth under the mesh, no re-upload
    t0 = time.perf_counter()
    stages = np.cumsum((0,) + SHARDED_GROWTH)
    ref4 = MemForestSystem(device="cuda")
    for i in range(0, stages[-1], 16):
        ref4.ingest_batch(wl.sessions[i:i + 16])
    ref_answers = {m: [(r.answer, r.evidence)
                       for r in ref4.query_batch(wl.queries, mode=m)]
                   for m in MODES}
    mesh = DataMesh(("cuda:0",) * 4)
    mf, _, counts = sharded_memory(torch, wl.sessions[:stages[1]], wl.queries,
                                   mesh, obs, sink)
    add_counts(total, counts)
    f = mf.forest
    up0, gr0, cap0 = f.index_uploads, f.index_grows, f.fact_emb.shape[0]
    from repro_torch import kernels
    for lo, hi in zip(stages[1:-1], stages[2:]):
        before = sharded_calls(sink, {})
        kernels.reset_counts()
        for i in range(lo, hi, 16):
            mf.ingest_batch(wl.sessions[i:i + 16])
        answers = {m: [(r.answer, r.evidence)
                       for r in mf.query_batch(wl.queries, mode=m)]
                   for m in MODES}
        torch.cuda.synchronize()
        counts = read_counts(REPLACES)
        check_mesh_launches(f"sharded: S=4 growth to {hi} sessions", counts,
                            sharded_calls(sink, before), 4)
        add_counts(total, counts)
    fact_dev, _ = f.fact_index_device()
    print(f"sharded: S=4 growth {'+'.join(map(str, SHARDED_GROWTH))} sessions "
          f"{time.perf_counter() - t0:.2f} s index_uploads {up0} -> "
          f"{f.index_uploads} index_grows {gr0} -> {f.index_grows} fact "
          f"capacity {cap0} -> {f.fact_emb.shape[0]} (shards "
          f"{[t.shape[0] for t in fact_dev.shards]}) matches: "
          + compare_systems(ref4, mf, ref_answers, answers), flush=True)
    need(f.index_uploads == up0, "growth under the mesh re-uploaded")
    need(f.fact_emb.shape[0] > cap0 and f.index_grows > gr0,
         "the sharded fact index did not grow under the mesh")
    same_bits("sharded S=4", ref4, mf)
    del mf, ref4

    # over distinct cards: S = 2, and make_data_mesh's mesh of every card
    n_cards = torch.cuda.device_count()
    meshes = [DataMesh(("cuda:0", "cuda:1"))] if n_cards > 1 else []
    if n_cards > 2:
        meshes.append(make_data_mesh())
    for mesh in meshes:
        t0 = time.perf_counter()
        mf, answers, counts = sharded_memory(torch, wl.sessions, wl.queries,
                                             mesh, obs, sink)
        add_counts(total, counts)
        print(f"sharded: S={mesh.size} over {n_cards} cards "
              f"{time.perf_counter() - t0:.2f} s matches: "
              + compare_systems(base, mf, base_answers, answers), flush=True)
        same_bits(f"sharded S={mesh.size} over cards", base, mf)
        del mf
    if not meshes:
        print(f"sharded: {n_cards} card visible: no mesh over distinct cards")

    check_cluster_plan(torch)
    check_serve_cli()
    print(f"sharded: phase_s={time.perf_counter() - t_phase:.2f}", flush=True)
    return total


def run_sharded_serve_memory(torch, mf, wl, sink):
    """The serve phase's llama3-8b ``ModelEncoder`` memory (D = 4096): its
    queries in the six modes without a mesh, then through a mesh of 2
    shards on the card: equal answers and evidence, S launches of each
    forest kernel per call. Returns the mesh run's counts."""
    from repro_torch import kernels
    from repro_torch.launch.mesh import DataMesh

    t0 = time.perf_counter()
    base = {m: [(r.answer, r.evidence)
                for r in mf.query_batch(wl.queries, mode=m)] for m in MODES}
    mesh = DataMesh(("cuda:0",) * 2)
    mf.set_mesh(mesh)
    before = sharded_calls(sink, {})
    kernels.reset_counts()
    got = {m: [(r.answer, r.evidence)
               for r in mf.query_batch(wl.queries, mode=m)] for m in MODES}
    torch.cuda.synchronize()
    counts = read_counts(REPLACES)
    calls = sharded_calls(sink, before)
    print(f"sharded: serve memory D={mf.config.embed_dim} facts="
          f"{len(mf.forest.facts)} launches " + " ".join(
              f"{k}={counts[k][0]} plain={counts[k][1]}"
              for k in SLICE_KERNELS) + f" calls={calls}", flush=True)
    need(counts["tree_refresh"][0] == 0 == calls["forest.tree_refresh"],
         "a query under the mesh refreshed a tree")
    need(counts["topk_sim"][0] == 3 * calls["retrieve.recall"]
         and counts["browse_scores"][0] == 2 * calls["retrieve.browse_scores"]
         and calls["retrieve.recall"] > 0,
         "the serve memory's launches under the mesh are off")
    need(all(counts[k][1] == 0 for k in SLICE_KERNELS),
         "the serve memory ran a plain version under the mesh")
    for m in MODES:
        need(got[m] == base[m], f"serve memory under the mesh: answers or "
             f"evidence differ in mode {m}")
    mf.set_mesh(None)
    print(f"sharded: serve memory S=2 matches mesh=None in {len(MODES)} "
          f"modes, {time.perf_counter() - t0:.2f} s", flush=True)
    return counts


ABLATION_DIM = 256                # benchmarks/common.py's EMB_DIM
ABLATION_SIZES = (64, 256, 1024)  # facts in one tree (Fig. 6a and 6c)
K_SWEEP = (3, 4, 8, 16, 32, 64)   # branching factors (Fig. 6d/e)
K_SWEEP_FACTS = 512
K_SWEEP_TREES = 16
K_SWEEP_TRIALS = 128
K_CHECKED = (3, 32, 64)           # K the main path never gives tree_refresh
EAGER_SESSIONS = 128              # the slice's first sessions


def unit_rows(rng, n):
    """``n`` random unit rows of ABLATION_DIM floats, drawn as
    ``bench_tree_scaling._facts`` draws them."""
    embs = rng.normal(size=(n, ABLATION_DIM)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True) + 1e-6
    return embs


def measured(torch, device, fn):
    """(fn's result, seconds, tree_refresh launches, its plain calls) of one
    call of ``fn``, the device's work included."""
    from repro_torch.kernels import COUNTS
    count = COUNTS["tree_refresh"]
    l0, p0 = count.launches, count.plain_calls
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, count.launches - l0,
            count.plain_calls - p0)


def one_tree(device, embs, eager=False):
    """``bench_tree_scaling``'s tree: one entity tree of ``embs``'s facts,
    flushed once at the end (lazy) or refreshed after every insert
    (``eager``, the paper's Fig. 6a baseline)."""
    from repro_torch.config import MemForestConfig
    from repro_torch.core.forest import Forest
    forest = Forest(MemForestConfig(embed_dim=ABLATION_DIM), device)
    for i in range(embs.shape[0]):
        forest.insert_item("entity:a", "entity", "fact", i, float(i), embs[i],
                           f"f{i}")
        if eager:
            forest.eager_refresh_path("entity:a")
    return forest


def lazy_vs_eager(torch, device, sizes=ABLATION_SIZES):
    """``bench_tree_scaling.lazy_vs_eager`` (Fig. 6a): per size, the lazy
    and the eager tree as ``measured`` gives them."""
    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        embs = unit_rows(rng, n)

        def lazy():
            forest = one_tree(device, embs)
            forest.flush()
            return forest
        rows.append((n, measured(torch, device, lazy),
                     measured(torch, device,
                              lambda: one_tree(device, embs, eager=True))))
    return rows


def level_parallel(torch, device, sizes=ABLATION_SIZES):
    """``bench_tree_scaling.level_parallel`` (Fig. 6c): per size, (the
    level-parallel tree, the per-node tree, each flush ``measured``)."""
    rng = np.random.default_rng(2)
    rows = []
    for n in sizes:
        embs = unit_rows(rng, n)
        fa, fb = one_tree(device, embs), one_tree(device, embs)
        rows.append((n, fa, measured(torch, device,
                                     lambda: fa.flush(level_parallel=True)),
                     fb, measured(torch, device,
                                  lambda: fb.flush(level_parallel=False))))
    return rows


class RefreshRecorder:
    """While entered, ``repro_torch.kernels.ops.tree_refresh`` (the forest's
    entry) keeps each call's inputs and output, so that a flush can be held
    against the plain version afterwards."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self._ops = [], ops
        self._orig = ops.tree_refresh

        def recording(emb, mask):
            out = self._orig(emb, mask)
            self.calls.append((emb, mask, out))
            return out
        ops.tree_refresh = recording
        return self

    def __exit__(self, *exc):
        self._ops.tree_refresh = self._orig
        return False

    def max_err(self) -> float:
        """The largest distance of a recorded output from the plain version
        on its inputs; an empty parent must give a zero row."""
        from repro_torch.kernels import ref
        err = 0.0
        for emb, mask, out in self.calls:
            want = ref.tree_refresh_ref(emb, mask)
            err = max(err, float((out - want).abs().max()))
            need(bool((out[mask.sum(1) == 0] == 0).all()),
                 "tree_refresh: empty parents must give zero rows")
        return err


def k_sweep(torch, device, ks=K_SWEEP, n=K_SWEEP_FACTS, checked=()):
    """``bench_tree_scaling.k_sweep`` (Fig. 6d/e): per K, 16 trees of
    ``n / 16`` facts around a random centre each, one flush, then 128
    queries by a random fact's own embedding through ``topk_sim`` over
    ``root_index()``: a hit when the top root is the fact's tree. Returns
    per K (K, hits in trial order, the tallest tree's height, the flush's
    largest error against the plain version when K is in ``checked``)."""
    from repro_torch.config import MemForestConfig
    from repro_torch.core.forest import Forest
    from repro_torch.kernels.topk_sim import topk_sim

    rng = np.random.default_rng(3)
    per_tree = n // K_SWEEP_TREES
    rows = []
    for k in ks:
        forest = Forest(MemForestConfig(embed_dim=ABLATION_DIM,
                                        branching_factor=k), device)
        owner = {}
        fact_embs = np.zeros((n, ABLATION_DIM), np.float32)
        for t in range(K_SWEEP_TREES):
            base = rng.normal(size=ABLATION_DIM).astype(np.float32)
            base /= np.linalg.norm(base)
            for i in range(per_tree):
                e = base + 0.9 * rng.normal(size=ABLATION_DIM).astype(
                    np.float32)
                e /= np.linalg.norm(e) + 1e-6
                fid = t * per_tree + i
                fact_embs[fid] = e
                forest.insert_item(f"entity:e{t}", "entity", "fact", fid,
                                   float(i), e, f"f{fid}")
                owner[fid] = t
        err = None
        if k in checked:
            with RefreshRecorder() as rec:
                forest.flush()
            err = rec.max_err()
        else:
            forest.flush()
        roots, n_valid, order = forest.root_index()
        keys = torch.from_numpy(roots).to(device)
        hits = []
        for _ in range(K_SWEEP_TRIALS):
            fid = int(rng.integers(0, n))
            q = torch.from_numpy(fact_embs[fid][None]).to(device)
            _, idx = topk_sim(q, keys, 1, num_valid=n_valid)
            hits.append(order[int(idx[0, 0])] == f"entity:e{owner[fid]}")
        rows.append((k, hits, max(t.height for t in forest.trees.values()),
                     err))
    return rows


def tree_shape(forest):
    """The integer structure of every tree of a forest."""
    return {key: (t.children, t.level, t.root)
            for key, t in forest.trees.items()}


def eager_system(torch, wl, device, eager):
    """``MemForestSystem(eager=...)`` on the slice's first EAGER_SESSIONS
    sessions in batches of 16 (eager ingests them one by one), then its
    queries in the six modes. Returns (system, answers, ingest seconds,
    {kernel: (launches, plain calls)} of the ingest and the queries)."""
    from repro_torch import MemForestSystem

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    before = read_counts(SLICE_KERNELS)
    mf = MemForestSystem(device=device, eager=eager)
    sessions = wl.sessions[:EAGER_SESSIONS]
    t0 = time.perf_counter()
    for i in range(0, len(sessions), 16):
        mf.ingest_batch(sessions[i:i + 16])
    sync()
    ingest_s = time.perf_counter() - t0
    answers = {m: [(r.answer, r.evidence)
                   for r in mf.query_batch(wl.queries, mode=m)]
               for m in MODES}
    sync()
    after = read_counts(SLICE_KERNELS)
    return mf, answers, ingest_s, {
        k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
        for k in SLICE_KERNELS}


def run_ablations(torch, wl):
    """Phase 4b: ``bench_tree_scaling``'s three sweeps on the card, held
    against the same sweeps on the CPU, then the eager system against the
    lazy one on the slice's first sessions."""
    from repro_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_counts()
    for n, (lazy, lazy_s, lazy_l, lazy_p), (eager, eager_s, eager_l,
                                            eager_p) in lazy_vs_eager(
                                                torch, "cuda"):
        need(lazy_p == 0 and eager_p == 0, "ablations: tree_refresh ran its "
             "plain version on CUDA")
        need(tree_shape(lazy) == tree_shape(eager), f"ablations: N={n}: the "
             "eager tree's shape differs from the lazy tree's")
        err = float(np.abs(lazy.trees["entity:a"].emb
                           - eager.trees["entity:a"].emb).max())
        need(err <= 1e-5, f"ablations: N={n}: eager and lazy embeddings "
             f"differ by {err}")
        print(f"ablations: lazy_vs_eager N={n} summary_refreshes lazy="
              f"{lazy.summary_refreshes} eager={eager.summary_refreshes} "
              f"reduction={eager.summary_refreshes / lazy.summary_refreshes:.2f}x"
              f" tree_refresh_launches lazy={lazy_l} eager={eager_l} "
              f"seconds lazy={lazy_s:.4f} eager={eager_s:.4f} "
              f"emb_err={err:.3e}", flush=True)

    card_par = level_parallel(torch, "cuda")
    for n, fa, (ra, sa, la, pa), fb, (rb, sb, lb, pb) in card_par:
        need(pa == 0 and pb == 0, "ablations: tree_refresh ran its plain "
             "version on CUDA")
        need(la == ra["kernel_calls"] and lb == rb["kernel_calls"],
             f"ablations: N={n}: tree_refresh launched {la} and {lb} times "
             f"for kernel_calls {ra['kernel_calls']} and {rb['kernel_calls']}")
        need(ra["refreshes"] == rb["refreshes"]
             and ra["levels"] == rb["levels"], f"ablations: N={n}: the two "
             "flushes refreshed different nodes")
        err = float(np.abs(fa.trees["entity:a"].emb
                           - fb.trees["entity:a"].emb).max())
        need(err <= 1e-5, f"ablations: N={n}: per-node and level-parallel "
             f"embeddings differ by {err}")
        print(f"ablations: level_parallel N={n} kernel_calls parallel="
              f"{ra['kernel_calls']} per_node={rb['kernel_calls']} "
              f"launches parallel={la} per_node={lb} seconds parallel="
              f"{sa:.4f} per_node={sb:.4f} speedup={sb / sa:.2f}x "
              f"emb_err={err:.3e}", flush=True)

    card_k = k_sweep(torch, "cuda", checked=K_CHECKED)
    for k, hits, height, err in card_k:
        line = (f"ablations: ksweep k={k} root_recall="
                f"{sum(hits) / len(hits):.3f} hits={sum(hits)}/{len(hits)} "
                f"height={height}")
        if err is not None:
            need(err <= 1e-5, f"ablations: tree_refresh at K={k}: max err "
                 f"{err} against the plain version")
            line += f" tree_refresh_max_abs_err={err:.3e} (tol 1e-05)"
        print(line, flush=True)

    lazy_mf, lazy_ans, lazy_s, lazy_c = eager_system(torch, wl, "cuda", False)
    eager_mf, eager_ans, eager_s, eager_c = eager_system(torch, wl, "cuda",
                                                         True)
    counts = read_counts(REPLACES)
    for k, (n, p) in counts.items():
        need(p == 0, f"{k} ran its plain version {p} times on CUDA in the "
             "ablations phase")
    for k in ("tree_refresh", "topk_sim"):
        need(counts[k][0] > 0, f"{k} never launched on the ablations path")
    match = compare_systems(lazy_mf, eager_mf, lazy_ans, eager_ans)
    sessions = min(EAGER_SESSIONS, len(wl.sessions))
    for tag, mf, s, c in (("lazy", lazy_mf, lazy_s, lazy_c),
                          ("eager", eager_mf, eager_s, eager_c)):
        print(f"ablations: system {tag} sessions={sessions} ingest_s={s:.4f} "
              f"sessions_per_s={sessions / s:.2f} summary_refreshes="
              f"{mf.forest.summary_refreshes} launches " + " ".join(
                  f"{k}={n}" for k, (n, _) in c.items()), flush=True)
    print(f"ablations: eager system equals lazy: {match}")
    card_s = time.perf_counter() - t_phase

    # the same sweeps on the CPU
    for (n, fa, ra, fb, rb), (_, ca, cra, cb, crb) in zip(
            card_par, level_parallel(torch, "cpu")):
        need(tree_shape(fa) == tree_shape(ca)
             and tree_shape(fb) == tree_shape(cb), f"ablations: N={n}: the "
             "card's trees differ from the CPU's")
        need(ra[0] == cra[0] and rb[0] == crb[0], f"ablations: N={n}: the "
             "card's flush counters differ from the CPU's")
    cpu_k = k_sweep(torch, "cpu")
    need([(k, h, ht) for k, h, ht, _ in card_k]
         == [(k, h, ht) for k, h, ht, _ in cpu_k],
         "ablations: the k sweep's hits or heights differ from the CPU's")
    print(f"ablations: cpu rerun of level_parallel and ksweep equal; "
          f"card_s={card_s:.2f} phase_s={time.perf_counter() - t_phase:.2f}")
    del lazy_mf, eager_mf
    return counts


# ---------------------------------------------------------------------------
# phases 5 and 6: the serve engine on llama3-8b
# ---------------------------------------------------------------------------
PROMPT_TOKENS = 120       # decode prompts: the first turns of a session
DECODE_PROMPTS = 8
NEW_TOKENS = 32


def build_engine(cfg, params, device, obs=None):
    """ServeEngine on ``cfg`` whose memory is a MemForestSystem with a
    ModelEncoder on the same weights (examples/serve_memforest.py)."""
    from repro_torch import MemForestConfig, MemForestSystem
    from repro_torch.core.encoder import ModelEncoder
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    tok = HashTokenizer(cfg.vocab_size)
    memory = MemForestSystem(MemForestConfig(embed_dim=cfg.d_model),
                             ModelEncoder(cfg, params, tok, max_len=128),
                             device=device, obs=obs)
    engine = ServeEngine(get_model(cfg), params, max_batch=8, max_len=512,
                         memory=memory, max_ingest_batch=16, obs=obs)
    return engine, tok


def decode_prompts(wl, tok, n, length=PROMPT_TOKENS):
    out = []
    for s in wl.sessions[:n]:
        ids = [i for t in s.turns for i in tok.encode(t.text)]
        out.append(ids[:length])
    return out


def serve_traffic(torch, engine, prompts, sessions, queries, new_tokens):
    """Round 1: the sessions through the ingest lane beside the prompts'
    decodes. Round 2: the queries through the query lane beside the same
    prompts again (the same padded block and prefix key: a prefix hit).
    Each round runs to drained; returns (round-1 s, round-2 s, results)."""
    def run():
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for s in sessions:
        engine.submit_session(s)
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens, prefix_key="summarize")
    ingest_s = run()
    rids = [engine.submit_query(q) for q in queries]
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens, prefix_key="summarize")
    query_s = run()
    return ingest_s, query_s, [engine.pop_query_result(r) for r in rids]


def to_cpu(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def engine_tokens(engine):
    """Every finished request's id and decoded tokens, in id order."""
    return sorted((r.req_id, r.out_tokens) for r in engine.finished)


def same_engines(label, ge, ce, gres, cres) -> None:
    """The card's engine ``ge`` and the CPU's ``ce`` after the same traffic:
    equal decoded tokens, facts, trees, placement and answers; a prefix
    hit."""
    need(engine_tokens(ge) == engine_tokens(ce),
         f"{label}: decoded tokens differ")
    need(len(ge.finished) == 8, f"{label}: a decode request did not finish")
    fa, fb = ge.memory.forest, ce.memory.forest
    need([(f.fact_id, f.text, f.value) for f in fa.facts]
         == [(f.fact_id, f.text, f.value) for f in fb.facts],
         f"{label}: facts differ")
    need(ge.memory.scale_stats() == ce.memory.scale_stats(),
         f"{label}: scale_stats differ")
    need(list(fa.trees) == list(fb.trees), f"{label}: tree sets differ")
    for key, ta in fa.trees.items():
        tb = fb.trees[key]
        need(ta.children == tb.children and ta.level == tb.level
             and ta.root == tb.root, f"{label}: tree {key} differs")
    need(fa.placement == fb.placement, f"{label}: placement differs")
    need([(r.answer, r.evidence) for r in gres]
         == [(r.answer, r.evidence) for r in cres], f"{label}: answers differ")
    need(ge.metrics()["prefills_reused"] >= 1, f"{label}: no prefix hit")


def profiled_repeat(torch, phase, traffic, serve_s, activities) -> None:
    """Device busy time over a profiled repeat of a phase's traffic, and
    the idle share against the unprofiled run's ``serve_s``."""
    from torch.profiler import profile
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        traffic()
    wall = time.perf_counter() - t0
    busy_s, top = device_busy(prof)
    if busy_s > 0:
        # the profiler slows the host, so the share against the unprofiled
        # run's wall time is the one the phase sees
        print(f"{phase}: profiled_wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
              f"unprofiled_wall_s={serve_s:.4f} "
              f"idle_share={1 - busy_s / serve_s:.4f} "
              f"idle_share_profiled={1 - busy_s / wall:.4f}")
        print(f"{phase}: device_ms " + "; ".join(
            f"{k[:48]}={v / 1e3:.3f}" for k, v in top))
    else:
        print(f"{phase}: profiled_wall_s={wall:.4f} device busy time not "
              "measured (the profiler saw no device activity)")


def read_counts(names):
    """{kernel: (launches, plain calls)} from the wrappers' counters."""
    from repro_torch.kernels import COUNTS
    return {k: (COUNTS[k].launches, COUNTS[k].plain_calls) for k in names}


def run_serve(torch, wl, seed):
    """Phase 5 on llama3-8b (bf16, published width and depth); then its
    memory's queries through a mesh of 2 shards (``run_sharded_serve_memory``).
    Returns the traffic's launch counts and the mesh run's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.obs import MemorySink, Observability, Tracer

    cfg = get_config("llama3_8b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: model={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"params={cfg.param_count():,} init_s={time.perf_counter() - t0:.2f} "
          f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)

    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))
    engine, tok = build_engine(cfg, params, "cuda", obs)
    prompts = decode_prompts(wl, tok, DECODE_PROMPTS)
    kernels.reset_counts()
    ingest_s, query_s, results = serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS)
    counts = read_counts(REPLACES)

    m = engine.metrics()
    totals = span_totals(sink)
    mf = engine.memory
    decode_s = totals.get("engine.decode", 0.0)
    print(f"serve: sessions={len(wl.sessions)} round1_s={ingest_s:.4f} "
          f"sessions_per_s={len(wl.sessions) / ingest_s:.2f} "
          f"encoder_tokens={mf.encoder.stats.tokens} "
          f"encoder_calls={mf.encoder.stats.calls} stats={mf.scale_stats()}")
    roofline_line("serve", cfg, DECODE_PROMPTS, PROMPT_TOKENS + NEW_TOKENS,
                  decode_s / m["decode_steps"] * 1e3)
    print(f"serve: queries_served={m['queries_served']} round2_s={query_s:.4f} "
          f"decoded_tokens={m['decoded_tokens']} decode_span_s={decode_s:.4f} "
          f"decoded_tokens_per_s={m['decoded_tokens'] / decode_s:.1f} "
          f"(decode spans) "
          f"{m['decoded_tokens'] / (ingest_s + query_s):.1f} (wall)")
    print("serve: metrics " + json.dumps(m, sort_keys=True))
    print("serve: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    browse_spans("serve", sink)
    print("serve: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(n > 0 or k not in SERVE_KERNELS,
             f"{k} never launched on the serve path")
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")
    need(m["prefills_reused"] >= 1, "the prefix cache was never reused")
    need(len(results) == len(wl.queries)
         and all(r is not None for r in results), "a query went unanswered")
    gold = sum(r.answer.strip().lower() == q.gold.strip().lower()
               for r, q in zip(results, wl.queries))
    print(f"serve: answers={len(results)} non_empty="
          f"{sum(bool(r.answer) for r in results)} equal_to_gold={gold} "
          "(random weights: not a measure of quality)")
    need(m["decoded_tokens"] > 0, "no tokens decoded")
    texts = [t.text for s in wl.sessions[:8] for t in s.turns]
    e1, e2 = mf.encoder.encode(texts), mf.encoder.encode(texts)
    need(e1.shape == (len(texts), cfg.d_model) and bool(np.isfinite(e1).all()),
         "encoder output has the wrong shape or is not finite")
    need(e1.tobytes() == e2.tobytes(), "two encodes of one batch differ")
    print(f"serve: encoder repeatable, {len(texts)} texts bitwise equal")
    mesh_counts = run_sharded_serve_memory(torch, mf, wl, sink)
    del engine, mf

    # device busy time over a profiled repeat of the same traffic
    from torch.profiler import ProfilerActivity
    engine, _ = build_engine(cfg, params, "cuda")
    profiled_repeat(torch, "serve", lambda: serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS),
        ingest_s + query_s, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    del engine, params
    torch.cuda.empty_cache()
    return counts, mesh_counts


def run_parity(torch, seed):
    """Phase 6: the engine at llama3-8b's width, depth 2, float32, on the
    card and on the CPU with the same weights and traffic."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import transformer as T

    cfg = get_config("llama3_8b").replace(num_layers=2, dtype="float32",
                                          param_dtype="float32")
    wl = make_workload(num_entities=4, num_sessions=4,
                       transitions_per_entity=3, num_queries=8, seed=seed)
    gpu_params = T.init_params(cfg, seed, device="cuda")
    cpu_params = to_cpu(gpu_params)
    runs = {}
    for device, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        engine, tok = build_engine(cfg, params, device)
        prompts = decode_prompts(wl, tok, 4)
        t0 = time.perf_counter()
        _, _, results = serve_traffic(torch, engine, prompts, wl.sessions,
                                      wl.queries, 8)
        texts = [t.text for s in wl.sessions[:2] for t in s.turns]
        runs[device] = (engine, results, engine.memory.encoder.encode(texts),
                        time.perf_counter() - t0)
    (ge, gres, gemb, gs), (ce, cres, cemb, cs) = runs["cuda"], runs["cpu"]
    emb_err = float(np.abs(gemb - cemb).max())
    # float32 on both sides, TF32 off; the sums run in another order
    need(emb_err <= 1e-4, f"parity: encoder embeddings differ by {emb_err}")
    same_engines("parity", ge, ce, gres, cres)
    fa = ge.memory.forest
    print(f"parity: llama3-8b width, {cfg.num_layers} layers, float32: "
          f"sessions={len(wl.sessions)} queries={len(gres)} "
          f"decoded_tokens={ge.metrics()['decoded_tokens']} tokens equal, "
          f"facts={len(fa.facts)} trees={len(fa.trees)} answers equal, "
          f"embedding max_abs_err={emb_err:.3e} (tol 1e-4) "
          f"card_s={gs:.3f} cpu_s={cs:.3f}", flush=True)
    del runs, ge, ce, gpu_params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7-9: the serve engine on zamba2 and rwkv6
# ---------------------------------------------------------------------------
SSM_PROMPT_TOKENS = 128   # a multiple of the scans' 64-token chunk
SSM_ARCHS = {"zamba2": ("zamba2_7b", "mamba2_ssd"),
             "rwkv6": ("rwkv6_1b6", "rwkv6_scan")}


def build_hashing_engine(cfg, params, device, obs=None, maintenance_budget=0):
    """ServeEngine on ``cfg`` whose memory is a MemForestSystem with the
    hashing encoder at the paper's defaults (``launch/serve.py --encoder
    hashing``): neither family has the dense trunk a ModelEncoder needs.
    ``maintenance_budget`` > 0 attaches a MaintenancePlane to the memory and
    drains that many units of it a step (the maintenance lane)."""
    from repro_torch import MemForestSystem
    from repro_torch.core.maintenance_plane import MaintenancePlane
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    memory = MemForestSystem(device=device, obs=obs)
    plane = MaintenancePlane(memory.forest, obs=obs) \
        if maintenance_budget > 0 else None
    engine = ServeEngine(get_model(cfg), params, max_batch=8, max_len=512,
                         memory=memory, max_ingest_batch=16, obs=obs,
                         maintenance=plane,
                         maintenance_budget=maintenance_budget)
    return engine, HashTokenizer(cfg.vocab_size)


def ssm_prompts(wl, tok, n):
    prompts = decode_prompts(wl, tok, n, SSM_PROMPT_TOKENS)
    need(all(len(p) == SSM_PROMPT_TOKENS for p in prompts),
         f"a session has fewer than {SSM_PROMPT_TOKENS} tokens")
    return prompts


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_count(v) for v in tree)
    return tree.numel()


def run_ssm_serve(torch, wl, seed, phase, keep=False):
    """Phase 7 (zamba2-7b) or 8 (rwkv6-1.6b): bf16, published width and
    depth, the engine traffic of phase 5 with 128-token prompts. Returns the
    launch counts and, with ``keep``, what the maintenance_lane phase holds
    its run against: (counts, (params, decoded tokens, the memory))."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.obs import MemorySink, Observability, Tracer

    arch, scan = SSM_ARCHS[phase]
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_model(cfg).init(seed, device="cuda")
    torch.cuda.synchronize()
    print(f"{phase}: model={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} attn_every={cfg.attn_every} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"params={param_count(params):,} "
          f"init_s={time.perf_counter() - t0:.2f} "
          f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)

    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))
    engine, tok = build_hashing_engine(cfg, params, "cuda", obs)
    prompts = ssm_prompts(wl, tok, DECODE_PROMPTS)
    kernels.reset_counts()
    ingest_s, query_s, results = serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS)
    counts = read_counts(REPLACES)

    m = engine.metrics()
    totals = span_totals(sink)
    decode_s = totals.get("engine.decode", 0.0)
    steps = m["decode_steps"]
    print(f"{phase}: sessions={len(wl.sessions)} round1_s={ingest_s:.4f} "
          f"sessions_per_s={len(wl.sessions) / ingest_s:.2f} "
          f"queries_served={m['queries_served']} round2_s={query_s:.4f} "
          f"stats={engine.memory.scale_stats()}")
    print(f"{phase}: decode_steps={steps} decoded_tokens={m['decoded_tokens']} "
          f"decode_span_s={decode_s:.4f} "
          f"decoded_tokens_per_s={m['decoded_tokens'] / decode_s:.1f} "
          f"(decode spans) "
          f"{m['decoded_tokens'] / (ingest_s + query_s):.1f} (wall) "
          f"peak_device_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    roofline_line(phase, cfg, DECODE_PROMPTS, SSM_PROMPT_TOKENS + NEW_TOKENS,
                  decode_s / steps * 1e3)
    print(f"{phase}: metrics " + json.dumps(m, sort_keys=True))
    print(f"{phase}: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    print(f"{phase}: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")
    for k in SLICE_KERNELS:
        need(counts[k][0] > 0, f"{k} never launched on the {phase} path")
    need(counts[scan][0] >= cfg.num_layers, f"{scan} launched "
         f"{counts[scan][0]} times, fewer than the {cfg.num_layers} layers "
         "of one prefill")
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        need(counts["flash_attention"][0] >= groups, "flash_attention "
             f"launched {counts['flash_attention'][0]} times, fewer than the "
             f"{groups} applications of the shared block")
        need(counts["decode_attention"][0] >= groups * steps,
             f"decode_attention launched {counts['decode_attention'][0]} "
             f"times, fewer than {groups} x {steps} decode steps")
    need(m["prefills_reused"] >= 1, "the prefix cache was never reused")
    need(len(engine.finished) == 2 * DECODE_PROMPTS and m["decoded_tokens"] > 0,
         "a decode request did not finish")
    need(len(results) == len(wl.queries)
         and all(r is not None for r in results), "a query went unanswered")
    need(bool(torch.isfinite(engine._last_logits.float()).all()),
         "the last logits are not finite")
    state = engine.cache["ssd" if cfg.family == "hybrid" else "wkv"]
    need(bool(torch.isfinite(state).all()), "the recurrent state is not "
         "finite")
    kept = (engine_tokens(engine), engine.memory)
    del engine

    # device busy time over a profiled repeat of the same traffic; device
    # activity only: the host ops of 64 decode steps of 81 layers make a
    # trace whose summary takes minutes, and the busy time needs none of them
    from torch.profiler import ProfilerActivity
    engine, _ = build_hashing_engine(cfg, params, "cuda")
    profiled_repeat(torch, phase, lambda: serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS),
        ingest_s + query_s, [ProfilerActivity.CUDA])
    del engine
    if keep:
        return counts, (params, *kept)
    del params, kept
    torch.cuda.empty_cache()
    return counts


def run_ssm_parity(torch, seed):
    """Phase 9: zamba2 at full width and 7 layers, rwkv6 at full width and
    2 layers, float32, on the card and on the CPU with the same weights and
    traffic."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import get_model

    wl = make_workload(num_entities=4, num_sessions=4,
                       transitions_per_entity=3, num_queries=8, seed=seed)
    for phase, layers in (("zamba2", 7), ("rwkv6", 2)):
        arch, _ = SSM_ARCHS[phase]
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32",
                                       param_dtype="float32")
        gpu_params = get_model(cfg).init(seed, device="cuda")
        cpu_params = to_cpu(gpu_params)
        runs = {}
        for device, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            engine, tok = build_hashing_engine(cfg, params, device)
            t0 = time.perf_counter()
            _, _, results = serve_traffic(torch, engine,
                                          ssm_prompts(wl, tok, 4),
                                          wl.sessions, wl.queries, 8)
            runs[device] = (engine, results, time.perf_counter() - t0)
        (ge, gres, gs), (ce, cres, cs) = runs["cuda"], runs["cpu"]
        same_engines(f"ssm_parity {phase}", ge, ce, gres, cres)
        fa = ge.memory.forest
        key = "ssd" if cfg.family == "hybrid" else "wkv"
        # float32 on both sides, TF32 off; the sums run in another order
        state_err = float((ge.cache[key].cpu() - ce.cache[key]).abs().max())
        need(state_err <= 1e-4, f"ssm_parity {phase}: final {key} state "
             f"differs by {state_err}")
        print(f"ssm_parity: {cfg.name} width, {cfg.num_layers} layers, "
              f"float32: sessions={len(wl.sessions)} queries={len(gres)} "
              f"decoded_tokens={ge.metrics()['decoded_tokens']} tokens equal, "
              f"facts={len(fa.facts)} trees={len(fa.trees)} answers equal, "
              f"{key} state max_abs_err={state_err:.3e} (tol 1e-4) "
              f"card_s={gs:.3f} cpu_s={cs:.3f}", flush=True)
        del runs, ge, ce, gpu_params, cpu_params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 10 and 11: durability and maintenance
# ---------------------------------------------------------------------------
DURABLE_BATCH = 64        # sessions a journaled delivery carries
DURABLE_DELETES = 16      # sessions deleted after the checkpoint
SWEEP_SESSIONS = 64       # the crash sweep's size, in batches of 32, with 2
                          # deletions and a 16-session merge (45 events)
DELIVERY_GAP_S = 0.02     # between deliveries the plane's worker takes the lock
IDLE_TIMEOUT_S = 300.0


def merge_source(seed, sessions, device):
    """The system the durable phase merges in: a second seed's workload,
    ingested on ``device``."""
    from repro_torch import MemForestSystem
    from repro_torch.data.synthetic import make_workload
    wl = make_workload(num_entities=16, num_sessions=sessions,
                       transitions_per_entity=4, distractor_turns=20,
                       num_queries=1, seed=seed + 1)
    mf = MemForestSystem(device=device)
    mf.ingest_batch(wl.sessions)
    return mf


def lifecycle_steps(wl, src, batch, deletes, queries=True):
    """The durable phase's client operations in order, each (kind, key,
    argument): journaled deliveries of ``batch`` sessions (the second batch's
    webhook fires twice), the queries, a checkpoint, ``deletes`` deletions,
    the compaction of every tree the deletions left 30% dead, and a merge of
    ``src``. Compaction comes before the merge and waits for its units to
    finish, so a client retry after a crash compacts the trees the
    uninterrupted run compacts."""
    steps = []
    for i in range(0, len(wl.sessions), batch):
        steps.append(("ingest", f"ingest:{i}", wl.sessions[i:i + batch]))
        if i == batch:
            steps.append(("ingest", f"ingest:{i}", wl.sessions[i:i + batch]))
    if queries:
        steps.append(("queries", None, wl.queries))
    steps.append(("checkpoint", None, None))
    stride = len(wl.sessions) // deletes
    steps += [("delete", f"delete:{s.session_id}", s.session_id)
              for s in wl.sessions[stride // 2::stride][:deletes]]
    steps.append(("compact", None, None))
    steps.append(("merge", "merge:second-seed", src))
    return steps


def settle(plane, background) -> None:
    """Until the plane has no work: the worker drains it (background), or
    this thread does (cooperative)."""
    if not background:
        plane.drain()
        return
    t0 = time.perf_counter()
    while plane.pending():
        if not plane._thread.is_alive():
            plane.stop_background()         # raises the worker's error
        need(time.perf_counter() - t0 < IDLE_TIMEOUT_S,
             "the maintenance plane did not go idle")
        time.sleep(0.005)


def memory_answers(mf, queries):
    return {m: [(r.answer, r.evidence)
                for r in mf.query_batch(queries, mode=m)] for m in MODES}


def gap(log) -> None:
    """The pause after a delivery or a query mode in background mode, in
    which the plane's worker takes the lock; its time is kept apart."""
    t0 = time.perf_counter()
    time.sleep(DELIVERY_GAP_S)
    log["gap_s"] += time.perf_counter() - t0


def apply_step(store, plane, step, background, log):
    """One client operation on the store, under the plane's lock where it
    touches the forest."""
    kind, key, arg = step
    if kind == "ingest":
        with plane.lock:
            out = store.ingest_batch(arg, idempotency_key=key,
                                     defer_flush=True)
        log["deliveries"] += 1
        log["duplicates"] += out is None
        if background:
            gap(log)
    elif kind == "queries":
        for mode in MODES:
            with plane.lock:
                res = store.query_batch(arg, mode=mode)
            need(len(res) == len(arg), f"a {mode} query went unanswered")
            if background:
                gap(log)
    elif kind == "checkpoint":
        with plane.lock:
            t0 = time.perf_counter()
            store.checkpoint()
            log["checkpoint_s"] = time.perf_counter() - t0
    elif kind == "delete":
        with plane.lock:
            store.delete_session(arg, idempotency_key=key, flush=False)
    elif kind == "compact":
        log["compactions_scheduled"] = plane.schedule_compaction()
        settle(plane, background)
    else:
        plane.schedule_merge(arg, idempotency_key=key)
        settle(plane, background)


def run_lifecycle(root, steps, device, *, background, crash=None, obs=None,
                  encoder=None):
    """``steps`` on a durable store in ``root`` with a maintenance plane
    (its worker thread when ``background``). On a simulated crash the
    process's state is dropped, the store is reopened from disk and the
    client retries the step. ``encoder``: the stores' encoder (the crash
    sweep shares one across its runs), by default a new HashingEncoder.
    Returns (store, plane, log)."""
    from repro_torch.core.journal import DurableMemForest
    from repro_torch.core.maintenance_plane import MaintenancePlane
    from repro_torch.runtime.fault_tolerance import SimulatedCrash

    def start(store):
        plane = MaintenancePlane(store.forest, durable=store, obs=obs)
        if background:
            plane.start_background()
        return plane

    log = {"deliveries": 0, "duplicates": 0, "recoveries": [], "gap_s": 0.0}
    store = DurableMemForest.open(root, device=device, fsync=True,
                                  crash=crash, obs=obs, encoder=encoder)
    plane = start(store)
    for step in steps:
        while True:
            try:
                apply_step(store, plane, step, background, log)
                break
            except SimulatedCrash:
                plane.stop_background(drain_first=False)   # process death
                store.close()
                t0 = time.perf_counter()
                store = DurableMemForest.open(root, device=device,
                                              fsync=True, obs=obs,
                                              encoder=encoder)
                log["recoveries"].append(
                    (time.perf_counter() - t0, store.ops_replayed))
                plane = start(store)
    plane.stop_background(drain_first=True)
    return store, plane, log


def same_structure(label, a, b) -> None:
    """Two memories on one device hold one state: facts, trees, placement,
    registry and applied keys exactly."""
    fa, fb = a.forest, b.forest
    need([(f.fact_id, f.text, f.sources) for f in fa.facts]
         == [(f.fact_id, f.text, f.sources) for f in fb.facts],
         f"{label}: facts differ")
    need(list(fa.trees) == list(fb.trees) and all(
        (ta.children, ta.level, ta.root, ta.payload)
        == (fb.trees[k].children, fb.trees[k].level, fb.trees[k].root,
            fb.trees[k].payload) for k, ta in fa.trees.items()),
        f"{label}: trees differ")
    need(fa.placement == fb.placement, f"{label}: placement differs")
    need(fa.session_registry == fb.session_registry,
         f"{label}: session registry differs")
    need(fa.applied_ops == fb.applied_ops, f"{label}: applied keys differ")


def run_durable(torch, wl, seed):
    """Phase 10: the durable store and the maintenance plane on the card."""
    import shutil
    import tempfile

    from repro_torch import MemForestSystem, kernels
    from repro_torch.core.encoder import HashingEncoder
    from repro_torch.core.maintenance_plane import WORKER_NAME
    from repro_torch.data.synthetic import make_workload
    from repro_torch.kernels import COUNTS
    from repro_torch.obs import MemorySink, Observability, Tracer
    from repro_torch.runtime.fault_tolerance import CrashInjector

    base = tempfile.mkdtemp(prefix="memforest_durable_")
    try:
        t0 = time.perf_counter()
        src = merge_source(seed, 64, "cuda")
        src_s = time.perf_counter() - t0
        steps = lifecycle_steps(wl, src, DURABLE_BATCH, DURABLE_DELETES)

        # 1-4. the lifecycle on the card, the plane on its worker thread --
        sink = MemorySink()
        obs = Observability(tracer=Tracer(sink=sink, enabled=True))
        probe = CrashInjector(None)
        kernels.reset_counts()
        t0 = time.perf_counter()
        store, plane, log = run_lifecycle(
            os.path.join(base, "main"), steps, "cuda", background=True,
            crash=probe, obs=obs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(REPLACES)
        worker = {k: COUNTS[k].by_thread.get(WORKER_NAME, 0)
                  for k in REPLACES}
        digest = store.state_digest()
        answers = memory_answers(store, wl.queries)
        reg = store.obs.registry
        totals = span_totals(sink)
        m = plane.metrics()
        print(f"durable: card {card_line()} (one run)")
        print(f"durable: sessions={len(wl.sessions)} deliveries="
              f"{log['deliveries']} duplicates_skipped={store.duplicates_skipped}"
              f" deletions={DURABLE_DELETES} compactions_scheduled="
              f"{log['compactions_scheduled']} merge_source_sessions=64 "
              f"(built in {src_s:.3f} s) run_s={run_s:.4f} of which "
              f"delivery_gaps_s={log['gap_s']:.4f} (sleeps that let the "
              f"worker take the lock) run_s_less_gaps="
              f"{run_s - log['gap_s']:.4f} stats={store.scale_stats()}")
        print(f"durable: journal appends={reg.counter('journal/appends').value}"
              f" bytes={reg.counter('journal/appended_bytes').value} "
              f"fsync_s={totals.get('journal.fsync', 0.0):.6f} append_s="
              f"{totals.get('journal.append', 0.0):.6f} checkpoint_s="
              f"{log['checkpoint_s']:.4f} durability_events={probe.events}")
        slices = sum(r["name"] == "maintenance.flush_slice"
                     for r in sink.spans())
        print("durable: plane " + json.dumps(m, sort_keys=True)
              + f" flush_slices={slices}")
        print("durable: span_s " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(totals.items())
            if k.startswith(("maintenance.", "forest.", "retrieve.browse",
                             "journal.", "persistence."))), flush=True)
        print("durable: launches " + " ".join(
            f"{k}={n} plain={p} worker={worker[k]}"
            for k, (n, p) in counts.items()))
        need(log["duplicates"] == 1 and store.duplicates_skipped == 1,
             "the duplicated delivery did not apply exactly once")
        need(m["maintenance_merges"] == 1 and m["maintenance_compactions"]
             == log["compactions_scheduled"] > 0, "the plane's merge or "
             "compactions did not run")
        need(m["maintenance_slots_reclaimed"] > 0, "compaction reclaimed "
             "no slot")
        for k, (n, p) in counts.items():
            need(n > 0 or k not in SLICE_KERNELS,
                 f"{k} never launched on the durable path")
            need(p == 0, f"{k} ran its plain version {p} times on CUDA")
        need(worker["tree_refresh"] > 0, "the plane's worker launched no "
             "tree_refresh")
        for tree in store.forest.trees.values():
            tree.check_invariants()
        f = store.forest
        print(f"durable: live store after the lifecycle: device_bytes="
              f"{store.device_bytes()} estimated={f.estimated_device_bytes()}"
              f" arena_rows_used={f._arena_used} arena_rows_cap="
              f"{f._arena.shape[0]} nodes={sum(t._n for t in f.trees.values())}"
              " (a compacted tree reuses its rows)")
        store.close()

        # 5a. reopen: the snapshot plus the journal tail -------------------
        from repro_torch.core.journal import DurableMemForest
        t0 = time.perf_counter()
        rec = DurableMemForest.open(os.path.join(base, "main"),
                                    device="cuda")
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        need(rec.state_digest() == digest, "the reopened store's digest "
             "differs")
        need(memory_answers(rec, wl.queries) == answers,
             "the reopened store answers otherwise")
        same_structure("reopen", rec, store)
        held, est = rec.device_bytes(), rec.forest.estimated_device_bytes()
        _name, freed = rec.demote()
        after, est_after = rec.device_bytes(), \
            rec.forest.estimated_device_bytes()
        print(f"durable: reopen open_s={open_s:.4f} records_replayed="
              f"{rec.ops_replayed} digest equal, answers equal in "
              f"{len(MODES)} modes; device_bytes={held} estimated={est} "
              f"demote freed={freed} device_bytes_after={after} "
              f"estimated_after={est_after}")
        need(freed == held and after == 0 and est_after == est,
             "demotion did not free the device caches")
        rec.close()

        # 5b. the same run crashed in the journal tail, then retried --------
        tail = [i for i, ev in enumerate(probe.trace, 1)
                if ev == "apply"][-(DURABLE_DELETES // 2) - 2]
        need(probe.trace.index("journal:rotate") < tail,
             "the crash point is not in the journal tail")
        crashed, _, clog = run_lifecycle(
            os.path.join(base, "crash"), steps, "cuda", background=True,
            crash=CrashInjector(tail))
        need(len(clog["recoveries"]) == 1, "the injected crash did not fire")
        need(crashed.state_digest() == digest, "the recovered run's digest "
             "differs")
        need(memory_answers(crashed, wl.queries) == answers,
             "the recovered run answers otherwise")
        same_structure("crash", crashed, store)
        (c_open_s, c_replayed), = clog["recoveries"]
        print(f"durable: crash at durability event {tail} of {probe.events} "
              f"({probe.trace[tail - 1]}): open_s={c_open_s:.4f} "
              f"records_replayed={c_replayed}, then the client's retries: "
              "digest equal, answers equal, structure equal", flush=True)
        crashed.close()

        # 6. the crash sweep at 64 sessions, cooperative -------------------
        swl = make_workload(num_entities=16, num_sessions=SWEEP_SESSIONS,
                            transitions_per_entity=4, distractor_turns=20,
                            num_queries=1, seed=seed)
        ssrc = merge_source(seed, 16, "cuda")
        ssteps = lifecycle_steps(swl, ssrc, 32, 2, queries=False)
        enc = HashingEncoder(device="cuda")     # one table for every run
        sprobe = CrashInjector(None)
        ref, _, _ = run_lifecycle(os.path.join(base, "sweep_ref"), ssteps,
                                  "cuda", background=False, crash=sprobe,
                                  encoder=enc)
        want = ref.state_digest()
        ref.close()
        t0 = time.perf_counter()
        for k in range(1, sprobe.events + 1):
            root = os.path.join(base, f"sweep_{k:03d}")
            got, _, slog = run_lifecycle(root, ssteps, "cuda",
                                         background=False,
                                         crash=CrashInjector(k), encoder=enc)
            need(len(slog["recoveries"]) == 1,
                 f"sweep: kill point {k} never fired")
            need(got.state_digest() == want, f"sweep: state diverged after "
                 f"a crash at event {k} ({sprobe.trace[k - 1]})")
            got.close()
            shutil.rmtree(root)
        print(f"durable: crash sweep at {SWEEP_SESSIONS} sessions: "
              f"{sprobe.events} kill points, every recovery at the "
              f"uninterrupted digest ({time.perf_counter() - t0:.2f} s)",
              flush=True)

        # 7. the same lifecycle on the CPU, cooperatively ------------------
        cpu_steps = lifecycle_steps(wl, merge_source(seed, 64, "cpu"),
                                    DURABLE_BATCH, DURABLE_DELETES)
        t0 = time.perf_counter()
        cpu, _, _ = run_lifecycle(os.path.join(base, "cpu"), cpu_steps,
                                  "cpu", background=False)
        cpu_answers = memory_answers(cpu, wl.queries)
        cpu_s = time.perf_counter() - t0
        need(cpu.forest.applied_ops == store.forest.applied_ops,
             "applied keys differ between the card and the CPU")
        print(f"durable: cpu run {cpu_s:.3f} s matches: "
              + compare_systems(store.system, cpu.system, answers,
                                cpu_answers), flush=True)

        # 8. snapshots across devices --------------------------------------
        card_snap = os.path.join(base, "card.mfz")
        store.system.save(card_snap)
        on_cpu = MemForestSystem.load(card_snap, device="cpu")
        need(on_cpu.state_digest() == digest, "the card's snapshot loads on "
             "the CPU with another digest")
        need(memory_answers(on_cpu, wl.queries) == answers,
             "the card's snapshot answers otherwise on the CPU")
        cpu_snap = os.path.join(base, "cpu.mfz")
        cpu.system.save(cpu_snap)
        on_card = MemForestSystem.load(cpu_snap, device="cuda")
        need(on_card.state_digest() == cpu.state_digest(), "the CPU's "
             "snapshot loads on the card with another digest")
        need(memory_answers(on_card, wl.queries) == cpu_answers,
             "the CPU's snapshot answers otherwise on the card")
        cpu.close()
        print("durable: the card's snapshot on the CPU and the CPU's on the "
              "card: digests equal, answers equal in "
              f"{len(MODES)} modes", flush=True)
        return counts
    finally:
        shutil.rmtree(base, ignore_errors=True)


def flushed_in_ingest_drains(sink) -> int:
    """``forest.flush`` spans inside an ``engine.drain.ingest`` span."""
    recs = {r["span"]: r for r in sink.spans()}
    hits = 0
    for r in recs.values():
        if r["name"] != "forest.flush":
            continue
        p = r["parent"]
        while p is not None and recs[p]["name"] != "engine.drain.ingest":
            p = recs[p]["parent"]
        hits += p is not None
    return hits


def run_maintenance_lane(torch, wl, rwkv6_run):
    """Phase 11: the rwkv6 phase's traffic through an engine whose memory
    has a MaintenancePlane drained two units a step, on the rwkv6 phase's
    weights; its tokens, digest and answers against the rwkv6 phase's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.obs import MemorySink, Observability, Tracer

    params, ref_tokens, ref_memory = rwkv6_run
    cfg = get_config(SSM_ARCHS["rwkv6"][0])
    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))
    engine, tok = build_hashing_engine(cfg, params, "cuda", obs,
                                       maintenance_budget=2)
    prompts = ssm_prompts(wl, tok, DECODE_PROMPTS)
    kernels.reset_counts()
    ingest_s, query_s, results = serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS)
    counts = read_counts(REPLACES)

    m = engine.metrics()
    totals = span_totals(sink)
    decode_s = totals.get("engine.decode", 0.0)
    inline = flushed_in_ingest_drains(sink)
    print(f"maintenance_lane: card {card_line()}")
    print(f"maintenance_lane: model={cfg.name} layers={cfg.num_layers} "
          f"dtype={cfg.dtype} sessions={len(wl.sessions)} round1_s="
          f"{ingest_s:.4f} sessions_per_s={len(wl.sessions) / ingest_s:.2f} "
          f"queries_served={m['queries_served']} round2_s={query_s:.4f} "
          f"decoded_tokens={m['decoded_tokens']} decode_span_s="
          f"{decode_s:.4f} decoded_tokens_per_s="
          f"{m['decoded_tokens'] / decode_s:.1f} (decode spans) "
          f"{m['decoded_tokens'] / (ingest_s + query_s):.1f} (wall) "
          "(one run)")
    print("maintenance_lane: metrics " + json.dumps(m, sort_keys=True))
    print("maintenance_lane: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    print("maintenance_lane: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    need(inline == 0, f"{inline} ingest drains flushed inline")
    need(m["maintenance_turns"] > 0, "the maintenance lane never ran")
    for k, (n, p) in counts.items():
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")
    for k in SLICE_KERNELS:
        need(counts[k][0] > 0, f"{k} never launched on the lane's path")
    need(counts["rwkv6_scan"][0] >= cfg.num_layers, "rwkv6_scan launched "
         f"{counts['rwkv6_scan'][0]} times, fewer than the layers of one "
         "prefill")
    need(len(results) == len(wl.queries)
         and all(r is not None for r in results), "a query went unanswered")
    need(engine_tokens(engine) == ref_tokens,
         "the decoded tokens differ from the rwkv6 phase's")
    engine.maintenance.drain()
    mem = engine.memory
    need(mem.state_digest() == ref_memory.state_digest(),
         "the memory's digest differs from the rwkv6 phase's")
    need(memory_answers(mem, wl.queries)
         == memory_answers(ref_memory, wl.queries),
         "the memory answers otherwise than the rwkv6 phase's")
    same_structure("maintenance_lane", mem, ref_memory)
    print(f"maintenance_lane: no ingest drain flushed; maintenance_turns="
          f"{m['maintenance_turns']}; decoded tokens, digest and answers in "
          f"{len(MODES)} modes equal to the rwkv6 phase's (no plane)")
    del engine, mem

    from torch.profiler import ProfilerActivity
    engine, _ = build_hashing_engine(cfg, params, "cuda",
                                     maintenance_budget=2)
    profiled_repeat(torch, "maintenance_lane", lambda: serve_traffic(
        torch, engine, prompts, wl.sessions, wl.queries, NEW_TOKENS),
        ingest_s + query_s, [ProfilerActivity.CUDA])
    del engine
    return counts


# ---------------------------------------------------------------------------
# phase 12: the paper's baselines beside MemForest
# ---------------------------------------------------------------------------
WRITE_SYSTEMS = ("memforest", "mem0", "memoryos", "evermem", "lightmem",
                 "mempalace")
MODEL_SYSTEMS = ("memforest", "evermem")
MODEL_SESSIONS = 16       # the llama3-8b encoder's share of the sessions
FACT_STORES = ("store", "cell_store", "recent_store")


def write_path_system(name, encoder, device):
    """MemForest at the paper's defaults (its width the encoder's), or one
    of the five baselines, on ``device`` with ``encoder``."""
    from repro_torch import MemForestConfig, MemForestSystem
    from repro_torch.core.baselines import ALL_BASELINES
    if name == "memforest":
        return MemForestSystem(MemForestConfig(embed_dim=encoder.dim),
                               encoder, device=device)
    return ALL_BASELINES[name](encoder, device=device)


def fact_stores(system):
    """{store: [(fact id, text)]} of a system's fact stores, and the largest
    (capacity, valid rows) among the baselines' ones."""
    if hasattr(system, "forest"):
        return {"forest": [(f.fact_id, f.text)
                           for f in system.forest.facts]}, (0, 0)
    stores = {n: getattr(system, n) for n in FACT_STORES
              if hasattr(system, n)}
    return ({n: [(f.fact_id, f.text) for f in st.facts]
             for n, st in stores.items()},
            max((st.emb.shape[0], len(st.facts)) for st in stores.values()))


def run_write_path(torch, system, sessions, queries, device):
    """``bench_write_path.py``'s loop: the sessions one at a time through
    ``ingest_session``, then one ``query`` each. Launch counts are reset
    before and read after; each wall clock ends in a sync."""
    from repro_torch import kernels

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    stats = system.encoder.stats
    calls0, seq0, tok0 = stats.calls, stats.sequential_calls, stats.tokens
    kernels.reset_counts()
    t0 = time.perf_counter()
    writes = [system.ingest_session(s) for s in sessions]
    sync()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = [system.query(q) for q in queries]
    sync()
    query_s = time.perf_counter() - t0
    stores, largest = fact_stores(system)
    return {
        "ingest_s": ingest_s, "query_s": query_s,
        "writes": [(w.encoder_calls, w.encoder_tokens, w.llm_dependency_depth,
                    w.facts_written) for w in writes],
        "calls": stats.calls - calls0, "tokens": stats.tokens - tok0,
        "sequential": stats.sequential_calls - seq0,
        "answers": [(r.answer, r.evidence) for r in results],
        "gold": sum(r.answer.strip().lower() == q.gold.strip().lower()
                    for r, q in zip(results, queries)),
        "counts": read_counts(REPLACES), "stores": stores,
        "largest": largest,
    }


def write_path_line(phase, name, r, sessions, queries) -> str:
    w = r["writes"]
    return (f"{phase}: {name} sessions_per_s={sessions / r['ingest_s']:.2f} "
            f"ingest_s={r['ingest_s']:.4f} encoder_calls={r['calls']} "
            f"sequential_calls={r['sequential']} tokens={r['tokens']} "
            f"mean_depth={sum(x[2] for x in w) / len(w):.3f} "
            f"facts_written={sum(x[3] for x in w)} "
            f"queries_per_s={queries / r['query_s']:.2f} "
            f"equal_to_gold={r['gold']}/{queries} "
            f"topk_sim_launches={r['counts']['topk_sim'][0]} "
            f"largest_store={r['largest']}")


def run_baselines(torch, wl, seed):
    """Phase 12: MemForest and the five baselines on the hashing encoder
    (the slice's 500 sessions and 64 queries), on the card and on the CPU;
    then MemForest and EverMem on llama3-8b's ModelEncoder, over the serve
    phase's weights (drawn again from the same seed: bitwise the same)."""
    from repro_torch.configs import get_config
    from repro_torch.core.encoder import HashingEncoder, ModelEncoder
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import transformer as T

    print(f"baselines: card {card_line()} (one run each)")
    total = {k: 0 for k in REPLACES}
    rows = {}
    for name in WRITE_SYSTEMS:
        system = write_path_system(name, HashingEncoder(dim=256,
                                                        device="cuda"), "cuda")
        rows[name] = r = run_write_path(torch, system, wl.sessions, wl.queries,
                                        "cuda")
        del system
        print(write_path_line("baselines", name, r, len(wl.sessions),
                              len(wl.queries)), flush=True)
        for k, (n, p) in r["counts"].items():
            total[k] += n
            need(p == 0, f"{name}: {k} ran its plain version {p} times on "
                 "CUDA")
        need(r["counts"]["topk_sim"][0] > 0,
             f"{name}: topk_sim never launched")
    for name in WRITE_SYSTEMS[1:]:
        need(rows["memforest"]["gold"] >= rows[name]["gold"],
             f"{name} answers {rows[name]['gold']} queries right, MemForest "
             f"{rows['memforest']['gold']}")
    largest = max(r["largest"] for r in rows.values())
    print(f"baselines: largest fact store (capacity, valid rows)={largest}; "
          f"the check row's {BASELINE_TOPK[0]}")
    if seed == 0:
        need(largest == BASELINE_TOPK[0], "the largest fact store is not the "
             "check row's shape")

    t0 = time.perf_counter()
    for name in WRITE_SYSTEMS:
        cpu = run_write_path(torch, write_path_system(
            name, HashingEncoder(dim=256, device="cpu"), "cpu"),
            wl.sessions, wl.queries, "cpu")
        r = rows[name]
        for key in ("stores", "writes", "calls", "tokens", "sequential",
                    "answers"):
            need(cpu[key] == r[key], f"{name}: the CPU run's {key} differ "
                 "from the card's")
    print(f"baselines: cpu rerun of the six systems "
          f"{time.perf_counter() - t0:.2f} s: fact texts and ids, write "
          "counts per session, answers and evidence equal to the card's",
          flush=True)

    cfg = get_config("llama3_8b")
    params = T.init_params(cfg, seed, device="cuda")
    encoder = ModelEncoder(cfg, params, HashTokenizer(cfg.vocab_size),
                           max_len=128)
    sessions = wl.sessions[:MODEL_SESSIONS]
    model_rows = {}
    for name in MODEL_SYSTEMS:
        system = write_path_system(name, encoder, "cuda")
        model_rows[name] = r = run_write_path(torch, system, sessions,
                                              wl.queries, "cuda")
        del system
        print(write_path_line(f"baselines: {cfg.name}", name, r,
                              len(sessions), len(wl.queries))
              + f" flash_attention_launches={r['counts']['flash_attention'][0]}",
              flush=True)
        for k, (n, p) in r["counts"].items():
            total[k] += n
            need(p == 0, f"{cfg.name} {name}: {k} ran its plain version {p} "
                 "times on CUDA")
        for k in ("flash_attention", "topk_sim"):
            need(r["counts"][k][0] > 0, f"{cfg.name} {name}: {k} never "
                 "launched")
    ratio = model_rows["evermem"]["ingest_s"] / model_rows["memforest"]["ingest_s"]
    print(f"baselines: {cfg.name} construction sessions/s MemForest / "
          f"EverMem = {ratio:.2f} (the paper's comparison; gates nothing); "
          f"largest EverMem store {model_rows['evermem']['largest']}, the "
          f"check row's {BASELINE_TOPK[1]}")
    if seed == 0:
        need(model_rows["evermem"]["largest"] == BASELINE_TOPK[1],
             "EverMem's store on llama3-8b is not the check row's shape")
    del encoder, params
    torch.cuda.empty_cache()
    return {k: (n, 0) for k, n in total.items()}


# ---------------------------------------------------------------------------
# phase 13: tenant residency
# ---------------------------------------------------------------------------
TENANTS = 32
HOT_BUDGET = 4            # bench_residency.py's; 8x as many tenants
TENANT_SESSIONS = 50
TENANT_DELIVERY = 25      # sessions a journaled delivery carries
TENANT_QUERIES = 256
QUERY_EVENT = 4           # queries of one tenant per traffic event
ZIPF_S = 1.5
DIGEST_THRESHOLD = 0.45


def tenant_workloads():
    """32 tenants, each about one LongMemEval-S history."""
    from repro_torch.data.synthetic import make_workload
    return [make_workload(num_entities=4, num_sessions=TENANT_SESSIONS,
                          transitions_per_entity=4, distractor_turns=20,
                          num_queries=16, seed=1000 + i)
            for i in range(TENANTS)]


def zipf_schedule(seed, nq):
    """(tenant, query indices) events: Zipf-ranked tenants, rotating
    queries (bench_residency.py's schedule)."""
    rng = np.random.default_rng(7 + seed)
    p = 1.0 / np.arange(1, TENANTS + 1, dtype=np.float64) ** ZIPF_S
    p /= p.sum()
    ranks = rng.choice(TENANTS, size=TENANT_QUERIES // QUERY_EVENT, p=p)
    return [(int(r), [(e * QUERY_EVENT + j) % nq for j in range(QUERY_EVENT)])
            for e, r in enumerate(ranks)]


class RecordingEncoder:
    """The card's encoder, keeping every call's texts and output so that the
    CPU run can be given the same bits (``ReplayEncoder``)."""

    def __init__(self, inner):
        self.inner = inner
        self.dim, self.device, self.stats = inner.dim, inner.device, inner.stats
        self.calls = []

    def encode(self, texts, *, sequential=False):
        out = self.inner.encode(texts, sequential=sequential)
        self.calls.append((list(texts), out))
        return out

    def encode_one(self, text):
        return self.encode([text])[0]


class ReplayEncoder:
    """Hands the CPU run the card encoder's outputs, call by call; a call
    with other texts than the card's means the runs diverged."""

    def __init__(self, calls, dim):
        from repro_torch.core.encoder import EncoderStats
        self.calls, self.dim, self.stats = iter(calls), dim, EncoderStats()

    def encode(self, texts, *, sequential=False):
        want, out = next(self.calls, (None, None))
        need(list(texts) == want, "the CPU run encoded other texts than the "
             "card's at the same call: the runs diverged")
        self.stats.calls += len(texts) if sequential else 1
        self.stats.texts += len(texts)
        return out

    def encode_one(self, text):
        return self.encode([text])[0]


def residents(mgr):
    return [t for t in mgr.tenant_ids() if mgr.is_resident(t)]


def residency_calls(torch, mgr, wls, sched, device):
    """(a)'s calls: every tenant ingested in journaled deliveries, then the
    schedule's query events. Returns the log (per ingest: tenant and the
    resident set; per event: tenant, the tier's decision, the resident set,
    answers and evidence), the gate's best score of each event on a cold
    tenant (None on a hot one) and the two wall clocks. The scores are kept
    apart: the digest holds root embeddings, which the card's tree_refresh
    and the CPU's plain version round differently."""
    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    log, scores = [], []
    t0 = time.perf_counter()
    for i, w in enumerate(wls):
        tid = f"t{i:03d}"
        for b in range(0, len(w.sessions), TENANT_DELIVERY):
            mgr.ingest(tid, w.sessions[b:b + TENANT_DELIVERY],
                       idempotency_key=f"{tid}:{b}")
        log.append(("ingest", tid, residents(mgr)))
    sync()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rank, qi in sched:
        tid = f"t{rank:03d}"
        qs = [wls[rank].queries[j] for j in qi]
        scores.append(mgr.best_digest_score(tid, qs))
        d0, r0 = mgr.digest_answers, mgr.rehydrations
        res = mgr.query_batch(tid, qs)
        tier = "digest" if mgr.digest_answers > d0 else \
            "rehydrated" if mgr.rehydrations > r0 else "hot"
        log.append(("query", tid, tier, residents(mgr),
                    [(r.answer, r.evidence) for r in res]))
    sync()
    return log, scores, ingest_s, time.perf_counter() - t0


def first_difference(card, cpu) -> str:
    """The first entry where the card's log and the CPU's differ, with the
    gate's best scores of that event on both and their distances to the
    threshold."""
    (card_log, card_scores), (cpu_log, cpu_scores) = card, cpu
    for i, (a, b) in enumerate(zip(card_log, cpu_log)):
        if a != b:
            text = f"entry {i}: card {a[:4]} cpu {b[:4]}"
            e = i - TENANTS              # the query events follow the ingests
            if e >= 0 and None not in (card_scores[e], cpu_scores[e]):
                sa, sb = card_scores[e], cpu_scores[e]
                text += (f"; best digest scores card {sa:.8f} cpu {sb:.8f}, "
                         f"distances to the threshold "
                         f"{sa - DIGEST_THRESHOLD:+.8f} "
                         f"{sb - DIGEST_THRESHOLD:+.8f}")
            return text
    return f"lengths {len(card_log)} and {len(cpu_log)}"


def allocator_blocks(torch, tensors):
    """The caching allocator's block size of each tensor's storage: what
    ``memory_allocated`` counts for it. A block can exceed the bytes asked
    for by more than the 512-byte rounding: the large pool hands out a
    cached block whole when the rest would be 1 MiB or less, so the sizes
    depend on the allocator's history, not on the tensor alone."""
    want = {t.untyped_storage().data_ptr() for t in tensors}
    return [b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg.get("blocks", ())
            if b["address"] in want and b.get("state") == "active_allocated"]


def run_residency(torch, wl, seed, rwkv6_run):
    """Phase 13: (a) a standalone ResidencyManager on the card and on the
    CPU with the same calls; (b) the engine's residency lane on rwkv6-1.6b
    beside the rwkv6 phase's decode traffic."""
    import gc
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.encoder import HashingEncoder
    from repro_torch.core.residency import ResidencyConfig, ResidencyManager
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import get_model
    from repro_torch.obs import MemorySink, Observability, Tracer
    from repro_torch.serving.engine import ServeEngine

    t0 = time.perf_counter()
    wls = tenant_workloads()
    sched = zipf_schedule(seed, len(wls[0].queries))
    gen_s = time.perf_counter() - t0
    config = ResidencyConfig(hot_budget=HOT_BUDGET, fsync=True,
                             digest_threshold=DIGEST_THRESHOLD)
    base = tempfile.mkdtemp(prefix="memforest_residency_")
    print(f"residency: card {card_line()} (one run)")
    try:
        # (a) the manager on the card ------------------------------------
        sink = MemorySink()
        obs = Observability(tracer=Tracer(sink=sink, enabled=True))
        encoder = RecordingEncoder(HashingEncoder(device="cuda"))
        mgr = ResidencyManager(os.path.join(base, "card"), config=config,
                               encoder=encoder, device="cuda", obs=obs)
        kernels.reset_counts()
        log, scores, ingest_s, query_s = residency_calls(torch, mgr, wls,
                                                         sched, "cuda")
        counts_a = read_counts(REPLACES)
        m = mgr.metrics()
        totals = span_totals(sink)
        tiers = [e[2] for e in log if e[0] == "query"]
        margins = [abs(x - DIGEST_THRESHOLD) for x in scores
                   if x is not None]
        sessions = TENANTS * TENANT_SESSIONS
        print(f"residency: tenants={TENANTS} hot_budget={HOT_BUDGET} "
              f"sessions={sessions} queries={TENANT_QUERIES} in events of "
              f"{QUERY_EVENT} (zipf s={ZIPF_S}) threshold={DIGEST_THRESHOLD} "
              f"fsync=on gen_s={gen_s:.3f} ingest_s={ingest_s:.4f} "
              f"sessions_per_s={sessions / ingest_s:.2f} query_s="
              f"{query_s:.4f} queries_per_s={TENANT_QUERIES / query_s:.2f}")
        print(f"residency: events hot={tiers.count('hot')} digest="
              f"{tiers.count('digest')} rehydrated={tiers.count('rehydrated')}"
              f" closest gate score to the threshold: "
              f"{min(margins) if margins else float('nan'):.6f} away")
        print("residency: metrics " + json.dumps(m, sort_keys=True))
        n_dem, n_reh = m["evictions"], m["rehydrations"]
        print(f"residency: demote_s={totals.get('residency.demote', 0.0):.4f}"
              f" ({n_dem} demotions, "
              f"{totals.get('residency.demote', 0.0) / max(n_dem, 1):.4f} s "
              f"each) rehydrate_s={totals.get('residency.rehydrate', 0.0):.4f}"
              f" ({n_reh} rehydrations, "
              f"{totals.get('residency.rehydrate', 0.0) / max(n_reh, 1):.4f} "
              f"s each) digest_answer_s="
              f"{totals.get('residency.digest_answer', 0.0):.4f} "
              f"checkpoint_s={totals.get('journal.checkpoint', 0.0):.4f}")
        print("residency: launches " + " ".join(
            f"{k}={n} plain={p}" for k, (n, p) in counts_a.items()),
            flush=True)
        for k, (n, p) in counts_a.items():
            need(p == 0, f"residency: {k} ran its plain version {p} times on "
                 "CUDA")
        for k in SLICE_KERNELS:
            need(counts_a[k][0] > 0, f"residency: {k} never launched")
        need(n_dem > 0 and n_reh > 0 and m["digest_answers"] > 0,
             "the schedule did not demote, rehydrate and answer from a "
             "digest")

        # an explicit demotion gives the card the tenant's bytes back
        tid = residents(mgr)[-1]
        mgr.query_batch(tid, wls[int(tid[1:])].queries[:QUERY_EVENT])
        forest = mgr.acquire(tid).forest
        held = [t for t in (forest._fact_dev, forest._root_dev,
                            forest._arena) if t is not None]
        n_tensors, device_bytes = len(held), forest.device_bytes()
        need(sum(t.untyped_storage().nbytes() for t in held)
             == device_bytes, f"{tid}: device_bytes {device_bytes} is not "
             "what its tensors hold")
        blocks = allocator_blocks(torch, held)
        del held
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        need(mgr.demote(tid), f"{tid} was not resident")
        torch.cuda.synchronize()
        demote_s = time.perf_counter() - t0
        after = torch.cuda.memory_allocated()
        print(f"residency: demote({tid}) {demote_s:.4f} s device_bytes="
              f"{device_bytes} in {n_tensors} tensors, allocator blocks of "
              f"{sum(blocks)} bytes; memory_allocated {before} -> {after} "
              f"(fell {before - after}); memory_reserved {reserved} -> "
              f"{torch.cuda.memory_reserved()}")
        need(len(blocks) == n_tensors and before - after == sum(blocks),
             f"demote({tid}) freed {before - after} bytes on the card, the "
             f"allocator's blocks of its {n_tensors} tensors ({device_bytes} "
             f"bytes of data) hold {sum(blocks)}")
        need(forest.device_bytes() == 0, "the demoted forest holds bytes")
        del forest

        # a rehydration and one query upload that tenant's rows only
        others = {t: mgr.acquire(t).forest for t in residents(mgr)}
        seen = {t: (f.index_uploads, f.index_row_updates, f.arena_syncs)
                for t, f in others.items()}
        t0 = time.perf_counter()
        store = mgr.acquire(tid)
        torch.cuda.synchronize()
        rehydrate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.query_batch(wls[int(tid[1:])].queries[:QUERY_EVENT])
        torch.cuda.synchronize()
        first_query_s = time.perf_counter() - t0
        f = store.forest
        print(f"residency: rehydrate({tid}) {rehydrate_s:.4f} s, first query "
              f"{first_query_s:.4f} s: its uploads={f.index_uploads} "
              f"arena_syncs={f.arena_syncs} device_bytes={f.device_bytes()}; "
              f"{len(others)} other residents unchanged")
        need(f.index_uploads == 2, f"{tid} uploaded {f.index_uploads} indexes")
        for t, g in others.items():
            need((g.index_uploads, g.index_row_updates, g.arena_syncs)
                 == seen[t], f"rehydrating {tid} moved {t}'s device rows")
        del others, store, f
        digests = [mgr.state_digest(f"t{i:03d}") for i in range(TENANTS)]
        mgr.close()
        del mgr
        gc.collect()

        # the same calls on the CPU, given the card encoder's bits
        probe = HashingEncoder(device="cpu")
        texts, card_out = encoder.calls[0]
        diff = float(np.abs(probe.encode(texts) - card_out).max())
        print(f"residency: the CPU's own hashing encoder against the card's "
              f"on {len(texts)} texts: max |diff|={diff:.3e} (the state "
              "digest hashes the encoder's bits: the CPU run replays the "
              "card's)")
        t0 = time.perf_counter()
        cpu = ResidencyManager(os.path.join(base, "cpu"), config=config,
                               encoder=ReplayEncoder(encoder.calls,
                                                     encoder.dim),
                               device="cpu")
        cpu_log, cpu_scores, _, _ = residency_calls(torch, cpu, wls, sched,
                                                    "cpu")
        cpu_digests = [cpu.state_digest(f"t{i:03d}") for i in range(TENANTS)]
        cpu.close()
        need(cpu_log == log, "card and CPU differ: " + first_difference(
            (log, scores), (cpu_log, cpu_scores)))
        score_err = max((abs(a - b) for a, b in zip(scores, cpu_scores)
                         if a is not None), default=0.0)
        need(cpu_digests == digests, "the tenants' state digests differ "
             "between the card and the CPU")
        print(f"residency: cpu run {time.perf_counter() - t0:.2f} s: every "
              f"tier decision ({len(log)} entries), answer, evidence and the "
              f"{TENANTS} state digests equal to the card's; the gate's "
              f"scores within {score_err:.3e}", flush=True)

        # a restarted manager: every tenant cold, no device bytes
        mgr = ResidencyManager(os.path.join(base, "card"), config=config,
                               device="cuda")
        m = mgr.metrics()
        need(m["tenants"] == TENANTS and m["hot_tenants"] == 0
             and m["device_bytes"] == 0, f"the restarted manager: {m}")
        print(f"residency: restarted manager: {m['tenants']} tenants, all "
              f"cold, device_bytes=0, digest_bytes={m['digest_bytes']}")
        mgr.close()
        del mgr

        # (b) the engine's residency lane on rwkv6-1.6b ------------------
        params, ref_tokens, _ = rwkv6_run
        cfg = get_config(SSM_ARCHS["rwkv6"][0])
        mgr = ResidencyManager(os.path.join(base, "lane"), config=config,
                               device="cuda")
        sink = MemorySink()
        obs = Observability(tracer=Tracer(sink=sink, enabled=True))
        engine = ServeEngine(get_model(cfg), params, max_batch=8, max_len=512,
                             max_ingest_batch=16, residency=mgr,
                             residency_budget=1, obs=obs)
        prompts = ssm_prompts(wl, HashTokenizer(cfg.vocab_size),
                              DECODE_PROMPTS)
        kernels.reset_counts()
        t0 = time.perf_counter()
        for i, w in enumerate(wls):
            for s in w.sessions:
                engine.submit_session(s, tenant=f"t{i:03d}")
        for p in prompts:
            engine.submit(p, max_new_tokens=NEW_TOKENS, prefix_key="summarize")
        engine.run_until_drained()
        torch.cuda.synchronize()
        round1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rids = [engine.submit_query(wls[rank].queries[j],
                                    tenant=f"t{rank:03d}")
                for rank, qi in sched for j in qi]
        for p in prompts:
            engine.submit(p, max_new_tokens=NEW_TOKENS, prefix_key="summarize")
        engine.run_until_drained()
        torch.cuda.synchronize()
        round2_s = time.perf_counter() - t0
        counts_b = read_counts(REPLACES)
        results = [engine.pop_query_result(r) for r in rids]
        m = engine.metrics()
        totals = span_totals(sink)
        print(f"residency: lane model={cfg.name} sessions={sessions} round1_s="
              f"{round1_s:.4f} sessions_per_s={sessions / round1_s:.2f} "
              f"queries={len(rids)} round2_s={round2_s:.4f} decoded_tokens="
              f"{m['decoded_tokens']} residency_turns={m['residency_turns']} "
              f"hot_tenants={m['hot_tenants']} evictions={m['evictions']} "
              f"rehydrations={m['rehydrations']} digest_answers="
              f"{m['digest_answers']}")
        print("residency: lane span_s " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(totals.items())
            if k.startswith(("engine.", "residency."))))
        print("residency: lane launches " + " ".join(
            f"{k}={n} plain={p}" for k, (n, p) in counts_b.items()),
            flush=True)
        need(m["hot_tenants"] <= HOT_BUDGET, f"{m['hot_tenants']} tenants "
             f"hot after the drain, budget {HOT_BUDGET}")
        need(m["residency_turns"] > 0, "the residency lane never ran")
        need(all(r is not None for r in results), "a query went unanswered")
        need([t for _, t in engine_tokens(engine)]
             == [t for _, t in ref_tokens],
             "the decoded tokens differ from the rwkv6 phase's")
        for k, (n, p) in counts_b.items():
            need(p == 0, f"residency lane: {k} ran its plain version {p} "
                 "times on CUDA")
        for k in SLICE_KERNELS:
            need(counts_b[k][0] > 0, f"residency lane: {k} never launched")
        need(counts_b["rwkv6_scan"][0] >= cfg.num_layers, "rwkv6_scan "
             f"launched {counts_b['rwkv6_scan'][0]} times, fewer than the "
             "layers of one prefill")
        print(f"residency: lane hot_tenants={m['hot_tenants']} <= "
              f"{HOT_BUDGET}, decoded tokens equal to the rwkv6 phase's")
        del engine
        mgr.close()
        return {k: (counts_a[k][0] + counts_b[k][0], 0) for k in REPLACES}
    finally:
        shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 14-17: the MoE, VLM and whisper families
# ---------------------------------------------------------------------------
MOE_SESSIONS = 128        # the slice's workload cut for olmoe's memory
VLM_PROMPT = 128          # pixtral's prompt tokens beside its 64 patches
WHISPER_PROMPT = 16       # whisper's decoder prompt beside its 1500 frames
FAMILY_STEPS = 32         # decode steps of the vlm and whisper phases
FLIP_MARGIN = 1e-5        # a router flip between devices below this is noise


class MoeDrops:
    """Counts the (token, choice) pairs ``moe_block`` drops past capacity,
    by the caller: the memory's encoder, the engine's prefill or its decode
    step. While it is entered, ``models.layers.moe_slots`` is wrapped to add
    each call's count to a tensor on the card (no host sync); ``read`` takes
    them to the host once."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.orig = layers, layers.moe_slots
        self.tag, self.sums = "encode", {}

    def __enter__(self):
        def counting(eidx, E, C):
            keep, slot = self.orig(eidx, E, C)
            dropped, total = self.sums.get(self.tag, (0, 0))
            self.sums[self.tag] = (dropped + (keep.numel() - keep.sum()),
                                   total + keep.numel())
            return keep, slot
        self.layers.moe_slots = counting
        return self

    def __exit__(self, *exc):
        self.layers.moe_slots = self.orig

    def model(self, model):
        """``model`` whose prefill and decode tag the calls they make."""
        def tagged(tag, fn):
            def call(*args):
                outer, self.tag = self.tag, tag
                try:
                    return fn(*args)
                finally:
                    self.tag = outer
            return call
        return model._replace(prefill=tagged("prefill", model.prefill),
                              decode=tagged("decode", model.decode))

    def read(self):
        return {tag: (int(d), n) for tag, (d, n) in self.sums.items()}


def memory_shape(mf) -> str:
    """The device index sizes of a memory: the shapes its ``topk_sim`` and
    ``browse_scores`` calls take (the moe check rows' constants)."""
    forest = mf.forest
    fact_dev, nf = forest.fact_index_device()
    root_dev, nr, _ = forest.root_index_device()
    arena, _ = forest.node_arena()
    nodes = sum(len(t.level) for t in forest.trees.values())
    return (f"facts={nf} fact_capacity={fact_dev.shape[0]} roots={nr} "
            f"root_capacity={root_dev.shape[0]} nodes={nodes} "
            f"arena_rows={arena.shape[0]}")


def check_launches(phase, counts, kernels) -> None:
    print(f"{phase}: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(p == 0, f"{k} ran its plain version {p} times on CUDA in the "
             f"{phase} phase")
    for k in kernels:
        need(counts[k][0] > 0, f"{k} never launched on the {phase} path")


def run_moe(torch, wl, seed):
    """Phase 14: the serve engine on olmoe-1b-7b at its published width and
    depth (bf16), its memory a ModelEncoder on the same weights, on the
    slice's first MOE_SESSIONS sessions."""
    from torch.profiler import ProfilerActivity

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.obs import MemorySink, Observability, Tracer

    cfg = get_config("olmoe_1b_7b")
    sessions = wl.sessions[:MOE_SESSIONS]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    print(f"moe: model={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"experts={cfg.num_experts} top_k={cfg.experts_per_token} "
          f"d_ff={cfg.d_ff} capacity_factor={cfg.moe_capacity_factor} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"params={param_count(params):,} "
          f"init_s={time.perf_counter() - t0:.2f} "
          f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)

    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))
    engine, tok = build_engine(cfg, params, "cuda", obs)
    prompts = decode_prompts(wl, tok, DECODE_PROMPTS)
    kernels.reset_counts()
    ingest_s, query_s, results = serve_traffic(
        torch, engine, prompts, sessions, wl.queries, NEW_TOKENS)
    counts = read_counts(REPLACES)

    m = engine.metrics()
    totals = span_totals(sink)
    mf = engine.memory
    decode_s = totals.get("engine.decode", 0.0)
    print(f"moe: sessions={len(sessions)} round1_s={ingest_s:.4f} "
          f"sessions_per_s={len(sessions) / ingest_s:.2f} "
          f"ingest_extract_s={totals.get('ingest.extract', 0.0):.4f} "
          f"encoder_tokens={mf.encoder.stats.tokens} "
          f"encoder_calls={mf.encoder.stats.calls} stats={mf.scale_stats()}")
    print(f"moe: queries_served={m['queries_served']} round2_s={query_s:.4f} "
          f"decode_steps={m['decode_steps']} "
          f"decoded_tokens={m['decoded_tokens']} decode_span_s={decode_s:.4f} "
          f"decoded_tokens_per_s={m['decoded_tokens'] / decode_s:.1f} "
          f"(decode spans) "
          f"{m['decoded_tokens'] / (ingest_s + query_s):.1f} (wall) "
          f"peak_device_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    roofline_line("moe", cfg, DECODE_PROMPTS, PROMPT_TOKENS + NEW_TOKENS,
                  decode_s / m["decode_steps"] * 1e3)
    print(f"moe: memory {memory_shape(mf)}")
    print("moe: metrics " + json.dumps(m, sort_keys=True))
    print("moe: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    browse_spans("moe", sink)
    check_launches("moe", counts, SERVE_KERNELS)
    need(m["prefills_reused"] >= 1, "moe: the prefix cache was never reused")
    need(len(results) == len(wl.queries)
         and all(r is not None for r in results), "moe: a query went "
         "unanswered")
    need(len(engine.finished) == 2 * DECODE_PROMPTS and m["decoded_tokens"] > 0,
         "moe: a decode request did not finish")
    texts = [t.text for s in sessions[:8] for t in s.turns]
    e1, e2 = mf.encoder.encode(texts), mf.encoder.encode(texts)
    need(e1.shape == (len(texts), cfg.d_model) and bool(np.isfinite(e1).all()),
         "moe: encoder output has the wrong shape or is not finite")
    need(e1.tobytes() == e2.tobytes(), "moe: two encodes of one batch differ")
    print(f"moe: encoder repeatable, {len(texts)} texts bitwise equal")
    del engine, mf

    # the drops, counted in an untimed repeat of the same traffic so that
    # the timed run above is the engine's own code
    engine, _ = build_engine(cfg, params, "cuda")
    drops = MoeDrops()
    engine.model = drops.model(engine.model)
    with drops:
        serve_traffic(torch, engine, prompts, sessions, wl.queries,
                      NEW_TOKENS)
    dropped = drops.read()
    print("moe: dropped (token, choice) pairs past capacity, in an untimed "
          "repeat " + " ".join(f"{tag}={d}/{n}"
                               for tag, (d, n) in sorted(dropped.items())))
    need(set(dropped) == {"encode", "prefill", "decode"},
         f"moe: moe_block ran for {sorted(dropped)}")
    del engine

    engine, _ = build_engine(cfg, params, "cuda")
    profiled_repeat(torch, "moe", lambda: serve_traffic(
        torch, engine, prompts, sessions, wl.queries, NEW_TOKENS),
        ingest_s + query_s, [ProfilerActivity.CUDA])
    del engine, params
    torch.cuda.empty_cache()
    print(f"moe: device_gib after freeing the weights="
          f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    return counts


def run_family(torch, phase, arch, prompt, seed):
    """Phases 15 (vlm, pixtral-12b) and 16 (whisper, whisper-base): bf16,
    published width and depth; ``prefill`` of DECODE_PROMPTS prompts from
    ``make_batch`` (pixtral's with its patch embeddings, whisper's with its
    1500 frames), then FAMILY_STEPS greedy ``decode`` steps, after one
    untimed warm-up of the same calls; then a profiled repeat for the
    device's idle share."""
    from torch.profiler import ProfilerActivity

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, make_batch

    cfg = get_config(arch)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda")
    torch.cuda.synchronize()
    print(f"{phase}: model={cfg.name} family={cfg.family} "
          f"layers={cfg.num_layers} encoder_layers={cfg.encoder_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype} "
          f"params={param_count(params):,} "
          f"init_s={time.perf_counter() - t0:.2f} "
          f"device_gib={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)
    batch = make_batch(cfg, "prefill", DECODE_PROMPTS, prompt, seed,
                       device="cuda")
    max_len = 512 if cfg.family == "vlm" else 64
    start = prompt + (cfg.num_patches if cfg.family == "vlm" else 0)

    def run(steps):
        logits, cache = model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = []
        for _ in range(steps):
            nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            logits, cache = model.decode(params, {"tokens": nxt}, cache)
        torch.cuda.synchronize()
        return logits, cache, out, time.perf_counter() - t1

    run(1)
    kernels.reset_counts()
    t0 = time.perf_counter()
    logits, cache, out, decode_s = run(FAMILY_STEPS)
    prefill_s = time.perf_counter() - t0 - decode_s
    counts = read_counts(REPLACES)
    tokens = DECODE_PROMPTS * FAMILY_STEPS
    print(f"{phase}: prompts={DECODE_PROMPTS} prompt_tokens={prompt} "
          f"sequence_start={start} prefill_s={prefill_s:.4f} "
          f"prefill_tokens_per_s={DECODE_PROMPTS * start / prefill_s:.1f} "
          f"decode_steps={FAMILY_STEPS} decode_s={decode_s:.4f} "
          f"decoded_tokens_per_s={tokens / decode_s:.1f} "
          f"ms_per_step={decode_s / FAMILY_STEPS * 1e3:.2f} "
          f"peak_device_gib={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    roofline_line(phase, cfg, DECODE_PROMPTS, start + FAMILY_STEPS,
                  decode_s / FAMILY_STEPS * 1e3)
    check_launches(phase, counts, ATTENTION_KERNELS)
    need(cache["lengths"].tolist() == [start + FAMILY_STEPS] * DECODE_PROMPTS,
         f"{phase}: the cache's lengths are {cache['lengths'].tolist()}, "
         f"want {start} + {FAMILY_STEPS}")
    need(logits.shape == (DECODE_PROMPTS, cfg.vocab_size)
         and bool(torch.isfinite(logits.float()).all()),
         f"{phase}: the last logits have the wrong shape or are not finite")
    need(counts["flash_attention"][0] >= cfg.num_layers + cfg.encoder_layers,
         f"{phase}: flash_attention launched {counts['flash_attention'][0]} "
         "times, fewer than the prefill's layers")
    need(counts["decode_attention"][0] == cfg.num_layers * FAMILY_STEPS,
         f"{phase}: decode_attention launched "
         f"{counts['decode_attention'][0]} times, not one a layer a step")
    del cache, logits
    profiled_repeat(torch, phase, lambda: run(FAMILY_STEPS),
                    prefill_s + decode_s, [ProfilerActivity.CUDA])
    del params, batch
    torch.cuda.empty_cache()
    print(f"{phase}: device_gib after freeing the weights="
          f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    return counts


def run_moe_parity(torch, seed):
    """olmoe at full width and depth 2, float32, through the engine on the
    card and on the CPU with the same weights and traffic. The card run
    records each moe_block call's input and routing; in the CPU run each
    moe_block takes the card call's input (so noise does not build up
    layer over layer), and its expert choices must equal the card's. A
    choice that differs where the two probabilities lie within FLIP_MARGIN
    is float noise between the devices: that token keeps the card's choice
    and the flip is printed. A wider difference fails."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_config("olmoe_1b_7b").replace(num_layers=2, dtype="float32",
                                            param_dtype="float32")
    wl = make_workload(num_entities=4, num_sessions=4,
                       transitions_per_entity=3, num_queries=8, seed=seed)
    gpu_params = T.init_params(cfg, seed, device="cuda")
    cpu_params = to_cpu(gpu_params)
    orig = L.moe_block
    calls, flips, held = [], [], {"in_err": 0.0, "calls": 0}

    def recording(p, x, cfg_):
        xf = x.reshape(-1, x.shape[-1])
        gw, gi, _ = L.moe_gate(p, xf, cfg_)
        calls.append((x.cpu(), gi.cpu(), gw.cpu()))
        return orig(p, x, cfg_)

    def replaying(p, x, cfg_):
        n = held["calls"]
        need(n < len(calls), "moe parity: the CPU run made more moe_block "
             "calls than the card's")
        x_card, gi_card, gw_card = calls[n]
        held["calls"] = n + 1
        need(x_card.shape == x.shape, f"moe parity: call {n} has shape "
             f"{tuple(x.shape)} on the CPU, {tuple(x_card.shape)} on the card")
        held["in_err"] = max(held["in_err"],
                             float((x - x_card).abs().max()))
        T_, D = x.shape[0] * x.shape[1], x.shape[2]
        xf = x_card.reshape(T_, D)
        gw, gi, aux = L.moe_gate(p, xf, cfg_)
        differ = (gi != gi_card).any(dim=1)
        if bool(differ.any()):
            probs = torch.softmax(xf @ p["router"], dim=-1)
            for t in torch.arange(T_)[differ].tolist():
                j = int((gi[t] != gi_card[t]).to(torch.int64).argmax())
                a, b = int(gi[t, j]), int(gi_card[t, j])
                margin = abs(float(probs[t, a] - probs[t, b]))
                flips.append((n, t, j, a, b, margin))
                need(margin < FLIP_MARGIN, f"moe parity: call {n} token {t} "
                     f"choice {j}: expert {a} on the CPU, {b} on the card, "
                     f"probabilities {margin:.3e} apart (noise is below "
                     f"{FLIP_MARGIN})")
            gi = torch.where(differ[:, None], gi_card, gi)
            gw = torch.where(differ[:, None], gw_card, gw)
        return L.moe_experts(p, xf, gw, gi, cfg_).reshape(x.shape), aux

    runs = {}
    texts = [t.text for s in wl.sessions[:2] for t in s.turns]
    try:
        for device, params, hook in (("cuda", gpu_params, recording),
                                     ("cpu", cpu_params, replaying)):
            L.moe_block = hook
            engine, tok = build_engine(cfg, params, device)
            t0 = time.perf_counter()
            _, _, results = serve_traffic(torch, engine,
                                          decode_prompts(wl, tok, 4),
                                          wl.sessions, wl.queries, 8)
            runs[device] = (engine, results, engine.memory.encoder.encode(
                texts), time.perf_counter() - t0)
    finally:
        L.moe_block = orig
    (ge, gres, gemb, gs), (ce, cres, cemb, cs) = runs["cuda"], runs["cpu"]
    need(held["calls"] == len(calls), f"moe parity: the CPU run made "
         f"{held['calls']} moe_block calls, the card's {len(calls)}")
    need(held["in_err"] <= 1e-3, f"moe parity: a moe_block input differs "
         f"between the devices by {held['in_err']:.3e}")
    emb_err = float(np.abs(gemb - cemb).max())
    need(emb_err <= 1e-4, f"moe parity: encoder embeddings differ by {emb_err}")
    same_engines("family_parity olmoe", ge, ce, gres, cres)
    fa = ge.memory.forest
    tokens = sum(c[1].shape[0] for c in calls)
    print(f"family_parity: {cfg.name} width, {cfg.num_layers} layers, "
          f"float32: sessions={len(wl.sessions)} queries={len(gres)} "
          f"decoded_tokens={ge.metrics()['decoded_tokens']} tokens equal, "
          f"facts={len(fa.facts)} trees={len(fa.trees)} answers equal, "
          f"embedding max_abs_err={emb_err:.3e} (tol 1e-4); "
          f"moe_block calls={len(calls)} routed tokens={tokens}, each CPU "
          f"layer on the card layer's input (inputs apart by at most "
          f"{held['in_err']:.3e}); router flips={len(flips)}"
          + (" (float noise, held on the card's choice: " + "; ".join(
              f"call {n} token {t} choice {j} cpu {a} card {b} margin "
              f"{mg:.3e}" for n, t, j, a, b, mg in flips[:8]) + ")"
             if flips else "")
          + f" card_s={gs:.3f} cpu_s={cs:.3f}", flush=True)
    del runs, ge, ce, gpu_params, cpu_params, calls
    torch.cuda.empty_cache()


def run_family_parity(torch, seed):
    """Phase 17: card against CPU in float32 with the same weights: olmoe
    (run_moe_parity), then pixtral at full width and depth 2 and whisper at
    full width and depth: equal greedy tokens, logits within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, make_batch

    torch.cuda.reset_peak_memory_stats()
    run_moe_parity(torch, seed)
    for arch, layers, prompt in (("pixtral_12b", 2, 32),
                                 ("whisper_base", None, WHISPER_PROMPT)):
        cfg = get_config(arch).replace(dtype="float32", param_dtype="float32")
        if layers:
            cfg = cfg.replace(num_layers=layers)
        model = get_model(cfg)
        gpu_params = model.init(seed, device="cuda")
        cpu_params = to_cpu(gpu_params)
        batch = make_batch(cfg, "prefill", 2, prompt, seed, device="cuda")
        runs = {}
        for device, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            b = {k: v.to(device) for k, v in batch.items()}
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, b, 128)
            out, steps = [logits.cpu()], []
            for _ in range(4):
                nxt = torch.argmax(logits, dim=-1)
                steps.append(nxt.tolist())
                logits, cache = model.decode(params, {"tokens": nxt}, cache)
                out.append(logits.cpu())
            runs[device] = (out, steps, cache["lengths"].tolist(),
                            time.perf_counter() - t0)
        (gl, gt, glen, gs), (cl, ct, clen, cs) = runs["cuda"], runs["cpu"]
        err = max(float((a - b).abs().max()) for a, b in zip(gl, cl))
        need(gt == ct, f"family_parity {cfg.name}: decoded tokens differ: "
             f"{gt} on the card, {ct} on the CPU")
        need(glen == clen, f"family_parity {cfg.name}: cache lengths differ")
        need(err <= 1e-4, f"family_parity {cfg.name}: logits differ by {err}")
        print(f"family_parity: {cfg.name} width, {cfg.num_layers} layers, "
              f"float32: batch 2, prompt {prompt}"
              + (f" + {cfg.num_patches} patches" if cfg.family == "vlm"
                 else f" + {cfg.encoder_seq_len} frames")
              + f", 4 decode steps: tokens equal, logits max_abs_err="
              f"{err:.3e} (tol 1e-4) card_s={gs:.3f} cpu_s={cs:.3f}",
              flush=True)
        del runs, gpu_params, cpu_params, batch
        torch.cuda.empty_cache()
    print("family_parity: peak_device_gib="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")


# ---------------------------------------------------------------------------
# phases 18-21: training
# ---------------------------------------------------------------------------
TRAIN_STEPS = 8
TRAIN_SEQ = 512
TRAIN_BATCH = 8
TRAIN_PARAM_ATOL = 1e-4     # train_parity: card against CPU after 3 steps
PARITY_STEPS = 3
STATE_BYTES = 12            # a parameter's train state: bf16 value and
#                             gradient, float32 AdamW moments
# phase: (arch, layers (None: the published depth), why the depth is cut).
# zamba2-7b at 81 layers has about 6.75e9 parameters, 81 GB of states: 36
# layers (six groups of six, each followed by the shared block) have about
# 3.24e9 and 38.9 GB.
TRAIN_RUNS = {
    "train": ("phi3_mini", None, ""),
    "train_zamba2": ("zamba2_7b", 36, "81 layers need about 81 GB of train "
                     "states; 36 layers are six groups of six, each followed "
                     "by the shared block"),
    "train_rwkv6": ("rwkv6_1b6", None, ""),
}
# device kernels of each family's train step, by the name they run under
TRAIN_DEVICE_KERNELS = {
    "dense": ("flash_attention_tc", "bwd_dq_tc", "bwd_dkv_tc"),
    "hybrid": ("ssd_bf16_kernel", "ssd_bwd_bf16_kernel", "flash_attention_tc",
               "bwd_dq_tc", "bwd_dkv_tc"),
    "ssm": ("wkv_bf16_kernel", "wkv_bwd_bf16_kernel"),
}


def train_launches(cfg):
    """Launches of each kernel of ``cfg``'s train step with remat, whose
    rematerialised layers run their forward twice: every layer of the dense
    family and rwkv6, zamba2's Mamba2 layers (not its shared block, as the
    reference checkpoints the Mamba2 layers only); whisper's encoder and
    decoder layers."""
    L = cfg.num_layers
    if cfg.family == "encdec":
        L += cfg.encoder_layers
    if cfg.family == "hybrid":
        G = L // cfg.attn_every
        return {"mamba2_ssd": 2 * L, "mamba2_ssd_bwd": L,
                "flash_attention": G, "flash_attention_bwd": G}
    if cfg.family == "ssm":
        return {"rwkv6_scan": 2 * L, "rwkv6_scan_bwd": L}
    return {"flash_attention": 2 * L, "flash_attention_bwd": L}


def run_train(torch, wl, seed, phase="train"):
    """Phases 18-20: one architecture of ``TRAIN_RUNS`` through the port's
    train step on the card. Returns the launch counts of the 8 steps."""
    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    from repro_torch.tree import leaves_with_paths
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch, layers, why = TRAIN_RUNS[phase]
    cfg = get_config(arch)
    published = cfg.num_layers
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
        print(f"{phase}: {cfg.name} depth cut from {published} to {layers} "
              f"layers at published width: {why}", flush=True)
    need(cfg.remat and cfg.dtype == "bfloat16", f"{phase}: {cfg.name}'s "
         "config must train in bf16 with remat")
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=TRAIN_STEPS)
    state = init_train_state(model, tcfg, seed, device="cuda")
    corpus = [t.text for s in wl.sessions for t in s.turns]
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=seed, corpus=corpus)
    step_fn = make_train_step(model, tcfg)

    def batch_at(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in pipe.batch_at(i).items()}

    real_update = opt_mod.adamw_update
    seen = []

    def inspecting(params, grads, st, c, **kw):
        seen.extend((path, g) for path, g in leaves_with_paths(grads))
        return real_update(params, grads, st, c, **kw)

    batches = [batch_at(i) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    kernels.reset_counts()
    metrics, step_ms = [], []
    for i in range(TRAIN_STEPS):
        if i == 0:
            opt_mod.adamw_update = inspecting
        try:
            t0 = time.perf_counter()
            state, m = step_fn(state, batches[i])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            opt_mod.adamw_update = real_update
        if i == 0:
            # the first step's gradients, before AdamW consumed them (the
            # check waits for the device, outside the timed steps' median)
            n_params = sum(1 for _ in leaves_with_paths(state["params"]))
            need(len(seen) == n_params, f"{phase}: {len(seen)} gradients for "
                 f"{n_params} parameters")
            bad = [path for path, g in seen
                   if g is None or not bool(torch.isfinite(g).all())
                   or not bool((g != 0).any())]
            need(not bad, f"{phase}: parameters without a finite nonzero "
                 f"gradient on the first step: {bad[:6]}")
            kinds = sorted({str(path[-1]) for path, _ in seen})
            print(f"{phase}: first step gradients present, finite and nonzero "
                  f"for all {len(seen)} parameters ({len(kinds)} kinds: "
                  + ", ".join(kinds) + ")", flush=True)
            del seen[:]
        metrics.append(m)
    counts = read_counts(REPLACES)
    losses = torch.stack([m["loss"] for m in metrics]).tolist()
    gnorms = torch.stack([m["grad_norm"] for m in metrics]).tolist()
    need(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
         f"{phase}: a loss or grad_norm is not finite: {losses} {gnorms}")
    want = train_launches(cfg)
    check_launches(phase, counts, tuple(want))
    for k, n in want.items():
        need(counts[k][0] == n * TRAIN_STEPS, f"{phase}: {k} launched "
             f"{counts[k][0]} times in {TRAIN_STEPS} steps, want "
             f"{n * TRAIN_STEPS}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    params = sum(t.numel() for _, t in leaves_with_paths(state["params"]))
    states_gb = params * STATE_BYTES / 1e9

    # one more step under the profiler: the device's idle share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    busy_s, top = device_busy(prof)
    idle = max(0.0, 1.0 - busy_s / prof_s) if busy_s > 0 else None
    print(f"{phase}: {cfg.name} params={params} layers={cfg.num_layers} "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ} steps={TRAIN_STEPS} losses="
          + ",".join(f"{x:.5f}" for x in losses) + " grad_norms=" + ",".join(
              f"{x:.4f}" for x in gnorms), flush=True)
    print(f"{phase}: step_ms={','.join(f'{x:.2f}' for x in step_ms)} "
          f"median_step_ms={med:.3f} (steps 2-{TRAIN_STEPS}) "
          f"tokens_per_s={tokens / (med / 1e3):.1f} peak_gb={peak_gb:.3f} "
          f"(states {states_gb:.2f} GB) card {card_line()}", flush=True)
    print(f"{phase}: profiled step s={prof_s:.4f} device_busy_s={busy_s:.4f} "
          f"idle_share=" + (f"{idle:.4f}" if idle is not None else
                            "not measured (no device events)")
          + " top: " + ", ".join(f"{k[:40]}={us / 1e3:.2f}ms"
                                 for k, us in top), flush=True)
    # the family's kernels' share of the profiled step's device time
    by_name = device_us_by_name(prof)
    kern_ms = {kern: sum(us for k, us in by_name.items() if kern in k) / 1e3
               for kern in TRAIN_DEVICE_KERNELS.get(cfg.family,
                                                    TRAIN_DEVICE_KERNELS["dense"])}
    scans = sum(ms for k, ms in kern_ms.items()
                if k.startswith(("ssd_", "wkv_")))
    print(f"{phase}: profiled step kernels " + " ".join(
        f"{k}={ms:.2f}ms" for k, ms in kern_ms.items())
        + (f" share={sum(kern_ms.values()) / (busy_s * 1e3):.4f} of device "
           f"busy (scans {scans / (busy_s * 1e3):.4f})"
           if busy_s > 0 else ""), flush=True)
    check_launches(phase, counts, ())
    del state, batches, metrics
    torch.cuda.empty_cache()
    print(f"{phase}: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return counts


def _parity_batch(cfg, rng, B, S):
    b = {"tokens": rng.integers(3, cfg.vocab_size, size=(B, S)).astype(
        np.int32),
         "labels": rng.integers(3, cfg.vocab_size, size=(B, S)).astype(
        np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)
                                 ).astype(np.float32)
    return b


def run_train_parity(torch, seed):
    """Phase 21: five float32 trainings on the card and on the CPU from one
    initial state (made on the CPU from a seeded generator, copied to the
    card), batches from a seeded numpy generator; then the runner's restart
    from a checkpoint on the card. Returns the card's launch counts."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.fault_tolerance import FaultTolerantRunner
    from repro_torch.training.optimizer import clone_tree
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    from repro_torch.tree import leaves, map_tree

    t_phase = time.perf_counter()
    f32 = dict(dtype="float32", param_dtype="float32")
    cases = (
        ("whisper-base", get_config("whisper_base").replace(**f32), 2, 32,
         {}),
        ("llama3-8b smoke", get_smoke_config("llama3_8b").replace(**f32), 4,
         64, dict(microbatch_size=2, grad_compression="topk")),
        ("olmoe-1b-7b smoke", get_smoke_config("olmoe_1b_7b").replace(**f32),
         4, 64, {}),
        # two chunks of the scans, so the chunk carry is exercised
        ("zamba2-7b smoke", get_smoke_config("zamba2_7b").replace(**f32), 4,
         128, {}),
        ("rwkv6-1.6b smoke", get_smoke_config("rwkv6_1b6").replace(**f32), 4,
         128, {}))
    total = {k: 0 for k in REPLACES}
    for name, cfg, B, S, kw in cases:
        model = get_model(cfg)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                           total_steps=PARITY_STEPS, **kw)
        cpu_state = init_train_state(model, tcfg, seed, device="cpu")
        card_state = map_tree(lambda t: t.to("cuda", copy=True), cpu_state)
        rng = np.random.default_rng(seed)
        batches = [_parity_batch(cfg, rng, B, S) for _ in range(PARITY_STEPS)]
        step = make_train_step(model, tcfg)
        kernels.reset_counts()
        t0 = time.perf_counter()
        card_m = []
        for b in batches:
            card_state, m = step(card_state, {
                k: torch.from_numpy(v).to("cuda") for k, v in b.items()})
            card_m.append(m)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = read_counts(REPLACES)
        family_kernels = tuple(train_launches(cfg))
        check_launches(f"train_parity {name}", counts, family_kernels)
        for k in total:
            total[k] += counts[k][0]
        t0 = time.perf_counter()
        cpu_m = []
        for b in batches:
            cpu_state, m = step(cpu_state, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
            cpu_m.append(m)
        cpu_s = time.perf_counter() - t0
        worst = 0.0
        for mc, mp in zip(card_m, cpu_m):
            for k in ("loss", "grad_norm"):
                a, c = float(mc[k]), float(mp[k])
                rel = abs(a - c) / max(abs(c), 1e-30)
                worst = max(worst, rel)
                need(rel <= 1e-4, f"train_parity {name}: {k} {a} on the "
                     f"card, {c} on the CPU")
        perr = max((a.cpu() - b).abs().max().item() for a, b in zip(
            leaves(card_state["params"]), leaves(cpu_state["params"])))
        need(perr <= TRAIN_PARAM_ATOL, f"train_parity {name}: parameters "
             f"differ by {perr:.3e} (tol {TRAIN_PARAM_ATOL})")
        print(f"train_parity: {name} B={B} S={S} {kw or ''} losses="
              + ",".join(f"{float(m['loss']):.6f}" for m in card_m)
              + f" worst_rel_loss_or_grad_norm={worst:.3e} (tol 1e-04) "
              f"param_max_abs_err={perr:.3e} (tol {TRAIN_PARAM_ATOL:.0e}) "
              f"card_s={card_s:.3f} cpu_s={cpu_s:.3f} launches " + " ".join(
                  f"{k}={counts[k][0]}" for k in family_kernels), flush=True)
        del cpu_state, card_state

    # the runner on the card: failures at steps 2 and 3 restore the last
    # checkpoint; the run ends where an uninterrupted one does
    cfg = get_smoke_config("llama3_8b").replace(**f32)
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=5)
    s0 = init_train_state(model, tcfg, seed, device="cuda")
    rng = np.random.default_rng(seed + 1)
    batches = [{k: torch.from_numpy(v).to("cuda")
                for k, v in _parity_batch(cfg, rng, 4, 64).items()}
               for _ in range(5)]
    step = make_train_step(model, tcfg)
    want = clone_tree(s0)
    for b in batches:
        want, _ = step(want, b)
    with tempfile.TemporaryDirectory() as d:
        runner = FaultTolerantRunner(
            step, lambda st, i: ckpt.save(d, i, st, extra={"step": i}),
            lambda: (ckpt.restore(d, s0)[0], ckpt.latest_step(d)),
            checkpoint_every=2)
        ckpt.save(d, 0, s0, extra={"step": 0})
        runner.inject_failure(2)
        runner.inject_failure(3)
        got, end = runner.run(clone_tree(s0), 0, 5, lambda i: batches[i])
        torch.cuda.synchronize()
    err = max((a - b).abs().max().item()
              for a, b in zip(leaves(got["params"]), leaves(want["params"])))
    need(end == 5 and runner.log.restarts == 2,
         f"train_parity: the runner ended at {end} after "
         f"{runner.log.restarts} restarts")
    need(err <= 1e-6, f"train_parity: the restarted run differs from the "
         f"uninterrupted one by {err:.3e}")
    print(f"train_parity: runner restarts={runner.log.restarts} end_step={end} "
          f"max_abs_diff_to_uninterrupted={err:.3e} (tol 1e-06) phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return {k: (n, 0) for k, n in total.items()}


# sharded_train: (arch, layers on one card) at published width; both run
# whole with four cards. On one card the (2, 2) mesh repeats it, and the
# data-replicated blocks are stored once per position: llama3-8b at 2 layers
# (1.49e9 parameters, about 24 GB of states so) and olmoe-1b-7b at 4 of its
# 16 (1.88e9).
SHARDED_TRAIN = (("llama3_8b", 2), ("olmoe_1b_7b", 4))
SHARDED_MESH = (2, 2)
SHARDED_STEPS = {False: 3, True: 8}         # by whether the cards are four
SHARDED_PARITY_STEPS = 2


def sync_all(torch, mesh) -> None:
    for d in mesh.distinct():
        torch.cuda.synchronize(d)


def sharded_state(torch, model, mesh, seed):
    """The train state of ``model`` placed on ``mesh``: the parameters made
    on the mesh's first device, the moments as zeros that only each
    position's block of materialises."""
    from repro_torch.training.train_loop import shard_train_state
    from repro_torch.tree import map_tree

    dev = mesh.devices[0]
    params = model.init(seed, device=dev)

    def zeros(p):
        return torch.zeros((), dtype=torch.float32, device=dev).expand(p.shape)

    state = {"params": params, "opt": {
        "m": map_tree(zeros, params), "v": map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev)}}
    return shard_train_state(state, mesh, model.cfg)


def run_sharded_train(torch, wl, seed):
    """Phase 22: llama3-8b and olmoe-1b-7b through the port's sharded train
    step on a (2, 2) mesh, then the smoke configs' card-against-CPU parity.
    Returns the launch counts of the timed steps."""
    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import Sharded
    from repro_torch.models import get_model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import leaves_with_paths
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    four = torch.cuda.device_count() >= 4
    # with four cards or more, the first four: one card a position
    mesh = make_mesh(SHARDED_MESH, ("data", "model"),
                     None if four else "cuda:0")
    need(tuple(mesh.dims) == SHARDED_MESH, f"sharded_train: mesh {mesh.dims}")
    steps = SHARDED_STEPS[four]
    cards = mesh.distinct()
    print(f"sharded_train: mesh {mesh.shape} over "
          + ", ".join(str(d) for d in mesh.devices) + f", {steps} steps, "
          f"card {card_line()}", flush=True)
    corpus = [t.text for s in wl.sessions for t in s.turns]
    total = {k: 0 for k in REPLACES}
    for arch, layers in SHARDED_TRAIN:
        t_model = time.perf_counter()
        for d in cards:
            torch.zeros((), device=d)    # the allocator of a card not used yet
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(d)
        cfg = get_config(arch)
        if not four:
            cfg = cfg.replace(num_layers=layers)
        need(cfg.remat and cfg.dtype == "bfloat16", f"sharded_train: "
             f"{cfg.name}'s config must train in bf16 with remat")
        model = get_model(cfg)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=steps)
        state = sharded_state(torch, model, mesh, seed)
        torch.cuda.empty_cache()
        n_params = sum(math.prod(w.shape)
                       for _, w in leaves_with_paths(state["params"]))
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                             global_batch=TRAIN_BATCH, seed=seed,
                             corpus=corpus)
        batches = [{k: torch.from_numpy(v).to(mesh.devices[0])
                    for k, v in pipe.batch_at(i).items()}
                   for i in range(steps + 1)]
        step_fn = make_train_step(model, tcfg)
        real_update = opt_mod.adamw_update
        seen = []

        def inspecting(params, grads, st, c, **kw):
            seen.extend(leaves_with_paths(grads))
            return real_update(params, grads, st, c, **kw)

        sync_all(torch, mesh)
        init_s = time.perf_counter() - t_model
        kernels.reset_counts()
        metrics, step_ms = [], []
        for i in range(steps):
            if i == 0:
                opt_mod.adamw_update = inspecting
            try:
                t0 = time.perf_counter()
                with activate_mesh(mesh):
                    state, m = step_fn(state, batches[i])
                sync_all(torch, mesh)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                opt_mod.adamw_update = real_update
            if i == 0:
                bad = [path for path, g in seen if not isinstance(g, Sharded)
                       or not all(bool(torch.isfinite(t).all())
                                  for t in g.parts)
                       or not any(bool((t != 0).any()) for t in g.parts)]
                need(len(seen) == len(leaves_with_paths(state["params"]))
                     and not bad, f"sharded_train {cfg.name}: parameters "
                     f"without a finite nonzero gradient: {bad[:6]}")
                print(f"sharded_train: {cfg.name} first step gradients "
                      f"present, finite and nonzero for all {len(seen)} "
                      "parameters", flush=True)
                del seen[:]
            metrics.append(m)
        counts = read_counts(REPLACES)
        losses = [float(m["loss"]) for m in metrics]
        gnorms = [float(m["grad_norm"]) for m in metrics]
        need(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
             f"sharded_train {cfg.name}: a loss or grad_norm is not finite: "
             f"{losses} {gnorms}")
        check_launches(f"sharded_train {cfg.name}", counts,
                       ("flash_attention", "flash_attention_bwd"))
        want = train_launches(cfg)
        for k, n in want.items():
            need(counts[k][0] == n * mesh.size * steps, f"sharded_train "
                 f"{cfg.name}: {k} launched {counts[k][0]} times in {steps} "
                 f"steps on {mesh.size} positions, want "
                 f"{n * mesh.size * steps}")
        for k in total:
            total[k] += counts[k][0]
        peaks = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with activate_mesh(mesh):
                state, _ = step_fn(state, batches[steps])
            sync_all(torch, mesh)
            prof_s = time.perf_counter() - t0
        busy_s, top = device_busy(prof)
        idle = (max(0.0, 1.0 - busy_s / (prof_s * len(cards)))
                if busy_s > 0 else None)
        med = statistics.median(step_ms[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"sharded_train: {cfg.name} params={n_params} "
              f"layers={cfg.num_layers} B={TRAIN_BATCH} S={TRAIN_SEQ} "
              f"steps={steps} init_s={init_s:.2f} losses="
              + ",".join(f"{x:.5f}" for x in losses) + " grad_norms="
              + ",".join(f"{x:.4f}" for x in gnorms), flush=True)
        print(f"sharded_train: {cfg.name} step_ms="
              + ",".join(f"{x:.2f}" for x in step_ms)
              + f" median_step_ms={med:.3f} (steps 2-{steps}) "
              f"tokens_per_s={tokens / (med / 1e3):.1f} peak_gb_per_card="
              + ",".join(f"{x:.3f}" for x in peaks)
              + f" (states {n_params * STATE_BYTES / 1e9:.2f} GB in all)",
              flush=True)
        print(f"sharded_train: {cfg.name} profiled step s={prof_s:.4f} "
              f"device_busy_s={busy_s:.4f} over {len(cards)} card(s) "
              "idle_share=" + (f"{idle:.4f}" if idle is not None else
                               "not measured (no device events)")
              + " top: " + ", ".join(f"{k[:40]}={us / 1e3:.2f}ms"
                                     for k, us in top), flush=True)
        print(f"sharded_train: {cfg.name} model_s="
              f"{time.perf_counter() - t_model:.1f}", flush=True)
        del state, batches, metrics, prof
        for d in cards:
            torch.cuda.empty_cache()
    run_sharded_parity(torch, seed)
    print(f"sharded_train: phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {k: (n, 0) for k, n in total.items()}


def run_sharded_parity(torch, seed):
    """llama3-8b's and olmoe-1b-7b's smoke configs in float32 on a (2, 2)
    mesh on the card and one on the CPU, from one initial state and the
    same batches: losses and ``grad_norm`` within 1e-4 relative, the
    parameters within ``TRAIN_PARAM_ATOL`` after ``SHARDED_PARITY_STEPS``
    steps."""
    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.models import get_model
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 shard_train_state)
    from repro_torch.tree import leaves

    f32 = dict(dtype="float32", param_dtype="float32")
    axes = ("data", "model")
    card = make_mesh(SHARDED_MESH, axes, "cuda:0")
    host = make_mesh(SHARDED_MESH, axes, "cpu")
    for arch in ("llama3_8b", "olmoe_1b_7b"):
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch).replace(**f32)
        model = get_model(cfg)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                           total_steps=SHARDED_PARITY_STEPS)
        start = init_train_state(model, tcfg, seed, device="cpu")
        states = {"card": shard_train_state(start, card, cfg),
                  "cpu": shard_train_state(start, host, cfg)}
        rng = np.random.default_rng(seed)
        batches = [_parity_batch(cfg, rng, 4, 64)
                   for _ in range(SHARDED_PARITY_STEPS)]
        step = make_train_step(model, tcfg)
        got = {}
        kernels.reset_counts()
        for name, mesh in (("card", card), ("cpu", host)):
            st, ms = states[name], []
            for b in batches:
                with activate_mesh(mesh):
                    st, m = step(st, {k: torch.from_numpy(v).to(
                        mesh.devices[0]) for k, v in b.items()})
                ms.append(m)
            got[name] = (gather_tree(st["params"], "cpu"), ms)
            if name == "card":
                counts = read_counts(REPLACES)
                check_launches(f"sharded_train parity {cfg.name}", counts,
                               ("flash_attention", "flash_attention_bwd"))
        worst = 0.0
        for mc, mp in zip(got["card"][1], got["cpu"][1]):
            for k in ("loss", "grad_norm"):
                a, c = float(mc[k]), float(mp[k])
                rel = abs(a - c) / max(abs(c), 1e-30)
                worst = max(worst, rel)
                need(rel <= 1e-4, f"sharded_train parity {cfg.name}: {k} "
                     f"{a} on the card, {c} on the CPU")
        perr = max((a - b).abs().max().item() for a, b in zip(
            leaves(got["card"][0]), leaves(got["cpu"][0])))
        need(perr <= TRAIN_PARAM_ATOL, f"sharded_train parity {cfg.name}: "
             f"parameters differ by {perr:.3e} (tol {TRAIN_PARAM_ATOL})")
        print(f"sharded_train: parity {cfg.name} mesh {card.shape} "
              f"steps={SHARDED_PARITY_STEPS} losses=" + ",".join(
                  f"{float(m['loss']):.6f}" for m in got["card"][1])
              + f" worst_rel_loss_or_grad_norm={worst:.3e} (tol 1e-04) "
              f"param_max_abs_err={perr:.3e} (tol {TRAIN_PARAM_ATOL:.0e}) "
              f"launches flash_attention={counts['flash_attention'][0]} "
              f"flash_attention_bwd={counts['flash_attention_bwd'][0]} "
              f"s={time.perf_counter() - t0:.2f}", flush=True)


# sharded_serve: (arch, layers, mesh, dtype). llama3-8b at published width
# cut to 2 layers, bf16, on a (2, 2) mesh (the heads form) and a (1, 16) mesh
# (the production model width: the sequence form, 256 rows a position), then
# olmoe-1b-7b at 4 layers on (2, 2) (the MoE's decode through its data-shard
# branch), each repeating one card. olmoe runs in bf16 and in float32. In
# bf16 the sharded and unsharded sums round apart, which can flip a token's
# top 8 of the router; a flipped token's output is another function, so the
# bf16 run holds only the tokens whose experts agree in every layer
# (``RouteLog``, ``route_flips``) and prints the gap over all of them beside
# the count of flips. The float32 run holds every token.
SHARDED_SERVE = (("llama3_8b", 2, (2, 2), "bfloat16"),
                 ("llama3_8b", 2, (1, 16), "bfloat16"),
                 ("olmoe_1b_7b", 4, (2, 2), "bfloat16"),
                 ("olmoe_1b_7b", 4, (2, 2), "float32"))
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_STEPS = 8, 512, 4096, 32
SERVE_GAP = 5e-2      # the logits' largest gap over their largest magnitude
SERVE_PARITY = (("llama3_8b", (2, 2)), ("llama3_8b", (1, 4)),
                ("olmoe_1b_7b", (2, 2)))
# four cards: llama3-8b whole on (2, 2), decode_32k cut from batch 128 to 24
# (its 549.8 GB cache fits no four cards); prompts of 32704 tokens into a
# 32768-row cache, 64 decode steps; rows 0-1 held to one card's unsharded run
SERVE_32K = {"batch": 24, "prompt": 32704, "max_len": 32768, "steps": 64,
             "held_rows": 2}


def serve_tokens(torch, model, params, batch, max_len, steps, mesh=None,
                 forced=None, keep=None):
    """Prefill, then ``steps`` decode steps: greedy from the gathered
    logits, or the tokens ``forced`` (steps, B) -> (tokens (steps, B) fed,
    the logits of the prefill and of each step but the last (rows ``keep``,
    float32, on the CPU), the final cache, prefill s, each step's s)."""
    from repro_torch.launch.mesh import activate_mesh
    from repro_torch.launch.sharding import Sharded, gather

    def whole(lg):
        lg = gather(lg) if isinstance(lg, Sharded) else lg
        return lg if keep is None else lg[keep]

    cards = mesh.distinct() if mesh is not None else (
        torch.device("cuda", torch.cuda.current_device()),)

    def sync():
        for d in cards:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    fed, logits_out, step_s = [], [], []
    with activate_mesh(mesh):
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
        sync()
        prefill_s = time.perf_counter() - t0
        for i in range(steps):
            lg = whole(logits)
            logits_out.append(lg.float().cpu())
            if forced is None:
                nxt = torch.argmax(gather(logits) if isinstance(
                    logits, Sharded) else logits, dim=-1)
            else:
                nxt = forced[i].to(batch["tokens"].device)
            fed.append(nxt)
            t0 = time.perf_counter()
            logits, cache = model.decode(params, {"tokens": nxt}, cache)
            sync()
            step_s.append(time.perf_counter() - t0)
    return torch.stack(fed), logits_out, cache, prefill_s, step_s


def serve_gap(torch, label, got, want, tokens) -> str:
    """Hold the sharded run's logits ``got`` (a list, one per step) to the
    unsharded run's ``want`` on the same fed tokens: the largest gap within
    SERVE_GAP of the unsharded logits' largest magnitude, and the greedy
    token the sharded run fed equal to the unsharded argmax wherever the
    unsharded top-two margin exceeds that gap."""
    gap = max((g - w).abs().max().item() for g, w in zip(got, want))
    top = max(w.abs().max().item() for w in want)
    need(gap <= SERVE_GAP * top, f"{label}: the logits differ from the "
         f"unsharded run's by {gap:.4e}, over {SERVE_GAP} of their largest "
         f"magnitude {top:.4e}")
    firm = same = 0
    for i, w in enumerate(want):
        two = torch.topk(w, 2, dim=-1).values
        sure = (two[:, 0] - two[:, 1]) > gap
        agree = torch.argmax(w, dim=-1) == tokens[i].cpu()
        firm += int(sure.sum())
        same += int((agree & sure).sum())
        need(bool(agree[sure].all()), f"{label}: step {i}: a greedy token "
             "differs where the unsharded top-two margin exceeds the gap")
    return (f"logits_max_gap={gap:.4e} (limit {SERVE_GAP} x {top:.4e}) "
            f"greedy_tokens_held={same}/{firm} (margin over the gap)")


class RouteLog:
    """While entered, every call of ``layers.moe_gate`` (the unsharded MoE's
    and each position's in ``moe_block_shards``) appends its tokens' expert
    ids, sorted per token (the set each token chose), to ``calls``, kept on
    the card. With ``replay`` (one (T, K) id tensor a call, as
    ``batch_routes`` gives a run's), call i takes those experts instead of
    its own top K, weighted by its own router probabilities renormalised
    over them as ``moe_gate`` weights its choices: a run with another run's
    choices."""

    def __init__(self, torch, replay=None):
        from repro_torch.models import layers
        self.torch, self.layers, self.calls = torch, layers, []
        self.replay = replay

    def __enter__(self):
        gate, calls, torch = self.layers.moe_gate, self.calls, self.torch
        replay, self.gate = self.replay, gate

        def recorded(p, xf, cfg):
            gw, gi, aux = gate(p, xf, cfg)
            if replay is not None:
                gi = replay[len(calls)]
                probs = torch.softmax(xf.to(torch.float32)
                                      @ p["router"].to(torch.float32), -1)
                w = torch.gather(probs, 1, gi)
                gw = (w / (w.sum(-1, keepdim=True) + 1e-9)).to(xf.dtype)
            calls.append(torch.sort(gi, dim=-1).values)
            return gw, gi, aux
        self.layers.moe_gate = recorded
        return self

    def __exit__(self, *exc):
        self.layers.moe_gate = self.gate


def batch_routes(log, mesh):
    """A sharded run's ``RouteLog`` as the batch's: one (T, K) a forward a
    layer. That run logs one call a position a layer, each on its data
    shard's tokens; the positions at model coordinate 0, in data order,
    give the batch's tokens in order."""
    torch = log.torch
    per = mesh.size
    lead = sorted((pos for pos in range(per)
                   if mesh.coord(pos, "model") == 0),
                  key=lambda pos: mesh.index_over(pos, ("data",)))
    return [torch.cat([log.calls[c + pos] for pos in lead])
            for c in range(0, len(log.calls), per)]


def route_flips(torch, label, sharded, whole, layers, B, S, forwards):
    """For each forward (the prefill, then each decode step), a (B, tokens)
    bool, True where a token's set of experts differs in some layer between
    two runs' routes (``batch_routes``, or a ``RouteLog``'s ``calls``)."""
    need(len(sharded) == forwards * layers == len(whole), f"{label}: the "
         f"router ran {len(sharded)} and {len(whole)} times, want "
         f"{forwards * layers}")
    flips = []
    for f in range(forwards):
        n = S if f == 0 else 1
        differ = torch.zeros(B, n, dtype=torch.bool)
        for li in range(layers):
            c = f * layers + li
            differ |= (sharded[c] != whole[c]).any(dim=-1).view(B, n).cpu()
        flips.append(differ)
    return flips


def serve_held(torch, label, model, params, batch, max_len, tokens, got,
               want, routes, mesh) -> str:
    """``serve_gap`` of a SHARDED_SERVE run: the sharded run's logits ``got``
    against the unsharded run's ``want`` on the fed ``tokens``. An MoE run
    also counts the tokens whose experts differ between the two runs
    (``routes``, the two runs' ``RouteLog``s). In bf16 their sums round
    apart and a token whose top K flips is another function, so a bf16 MoE
    run is held instead to the unsharded run made with the sharded run's
    experts, every token."""
    cfg = model.cfg
    if cfg.family != "moe":
        return serve_gap(torch, label, got, want, tokens)
    layers = cfg.num_layers
    B, S = batch["tokens"].shape
    sharded = batch_routes(routes[0], mesh)
    flips = route_flips(torch, label, sharded, routes[1].calls, layers, B, S,
                        len(got) + 1)
    rows = torch.stack([f.any(dim=-1) for f in flips]).any(dim=0)
    gap = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"{label}: route flips against the unsharded run: prefill "
          f"{int(flips[0].sum())}/{flips[0].numel()} tokens, decode "
          f"{sum(int(f.sum()) for f in flips[1:])}/{len(got) * B} (in any "
          f"of {layers} layers); rows with a flip {int(rows.sum())}/{B}; "
          f"logits_max_gap {gap:.4e}", flush=True)
    if cfg.dtype != "bfloat16":
        return serve_gap(torch, label, got, want, tokens)
    replayed = RouteLog(torch, replay=sharded)
    with replayed:
        _, want, _, _, _ = serve_tokens(torch, model, params, batch,
                                        max_len, len(got), forced=tokens)
    need(len(replayed.calls) == len(sharded), f"{label}: the replayed run "
         f"routed {len(replayed.calls)} times, want {len(sharded)}")
    return "with the sharded run's experts: " + serve_gap(
        torch, label + " (the sharded run's experts)", got, want, tokens)


def run_sharded_serve(torch, seed):
    """Phase 23: prefill and decode on a model mesh through the entry points
    (``get_model(cfg).prefill`` and ``.decode`` under ``activate_mesh``, the
    parameters placed by ``param_shardings``, the cache by
    ``launch.sharding.cache_shardings``). With four cards or more: the
    four-card run (``run_sharded_serve_32k``). Otherwise, on one card
    (SHARDED_SERVE): prefill of SERVE_BATCH x SERVE_PROMPT into a
    SERVE_MAX_LEN cache, SERVE_STEPS greedy decode steps; each run held to
    the same weights unsharded on the card (``serve_gap``), its launches
    exact; then the smoke configs in float32, the card's mesh against the
    CPU's. Returns the launch counts of the sharded runs."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import param_shardings, place_tree
    from repro_torch.models import get_model, make_batch

    t_phase = time.perf_counter()
    if torch.cuda.device_count() >= 4:
        total = run_sharded_serve_32k(torch, seed)
        run_sharded_serve_parity(torch, seed)
        print(f"sharded_serve: phase_s={time.perf_counter() - t_phase:.1f}",
              flush=True)
        return total
    total = {k: 0 for k in REPLACES}
    print(f"sharded_serve: card {card_line()}", flush=True)
    for arch, layers, shape, dtype in SHARDED_SERVE:
        t_run = time.perf_counter()
        cfg = get_config(arch).replace(num_layers=layers, dtype=dtype,
                                       param_dtype=dtype)
        if cfg.family == "moe":
            # the mesh takes the MoE's capacity per data shard, another
            # function where choices are dropped: at E / K no choice is
            # dropped in either run
            cfg = cfg.replace(moe_capacity_factor=cfg.num_experts
                              / cfg.experts_per_token)
        model = get_model(cfg)
        mesh = make_mesh(shape, ("data", "model"), "cuda:0")
        params = model.init(seed, device="cuda")
        placed = place_tree(params, mesh, param_shardings(
            mesh, params, moe_fsdp=cfg.moe_fsdp_params))
        batch = make_batch(cfg, "prefill", SERVE_BATCH, SERVE_PROMPT, seed,
                           device="cuda")
        serve_tokens(torch, model, placed, batch, SERVE_MAX_LEN, 1, mesh)
        routes = (RouteLog(torch), RouteLog(torch))
        kernels.reset_counts()
        with routes[0]:
            tokens, got, cache, prefill_s, step_s = serve_tokens(
                torch, model, placed, batch, SERVE_MAX_LEN, SERVE_STEPS, mesh)
        counts = read_counts(REPLACES)
        tp = mesh.shape["model"]
        form = ("heads" if cfg.num_kv_heads % tp == 0 else "sequence")
        label = (f"sharded_serve {cfg.name} {dtype} mesh {shape} ({form} "
                 "form)")
        check_launches(label, counts, ATTENTION_KERNELS)
        want = {"flash_attention": layers * mesh.size,
                "decode_attention": layers * mesh.size * SERVE_STEPS}
        for k, n in want.items():
            need(counts[k][0] == n, f"{label}: {k} launched {counts[k][0]} "
                 f"times, want {n} (layers x positions"
                 + (" x steps)" if k == "decode_attention" else ")"))
        for k in total:
            total[k] += counts[k][0]
        need(cache["lengths"].shape == (SERVE_BATCH,) and all(
            bool((t == SERVE_PROMPT + SERVE_STEPS).all())
            for t in cache["lengths"].parts), f"{label}: lengths")
        kspec = cache["k"].spec
        del cache, placed
        with routes[1]:
            _, want_logits, _, base_prefill_s, base_s = serve_tokens(
                torch, model, params, batch, SERVE_MAX_LEN, SERVE_STEPS,
                forced=tokens)
        held = serve_held(torch, label, model, params, batch, SERVE_MAX_LEN,
                          tokens, got, want_logits, routes, mesh)
        med = statistics.median(step_s[1:])
        print(f"{label}: cache spec {kspec} B={SERVE_BATCH} "
              f"prompt={SERVE_PROMPT} max_len={SERVE_MAX_LEN} "
              f"steps={SERVE_STEPS} prefill_s={prefill_s:.4f} "
              f"median_step_ms={med * 1e3:.3f} (unsharded "
              f"{statistics.median(base_s[1:]) * 1e3:.3f}, prefill "
              f"{base_prefill_s:.4f} s) launches flash_attention="
              f"{counts['flash_attention'][0]} decode_attention="
              f"{counts['decode_attention'][0]} {held} "
              f"s={time.perf_counter() - t_run:.2f}", flush=True)
        del params, batch
        torch.cuda.empty_cache()
    run_sharded_serve_parity(torch, seed)
    print(f"sharded_serve: phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {k: (n, 0) for k, n in total.items()}


def run_sharded_serve_parity(torch, seed):
    """The smoke configs in float32 on a mesh repeating the card and on one
    repeating the CPU, from one set of weights and tokens: prefill of 4 x 23
    tokens into 32 rows, 6 decode steps with fixed tokens (the rows cross a
    shard boundary in the sequence form); every logit within 1e-4 of the
    largest, lengths equal."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (gather, param_shardings,
                                             place_tree)
    from repro_torch.models import get_model

    f32 = dict(dtype="float32", param_dtype="float32")
    for arch, shape in SERVE_PARITY:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch).replace(**f32)
        model = get_model(cfg)
        params = model.init(seed, device="cpu")
        rng = np.random.default_rng(seed)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 23)))
        forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (6, 4)))
        got = {}
        kernels.reset_counts()
        for name, dev in (("card", "cuda:0"), ("cpu", "cpu")):
            mesh = make_mesh(shape, ("data", "model"), dev)
            placed = place_tree(params, mesh, param_shardings(
                mesh, params, moe_fsdp=cfg.moe_fsdp_params))
            _, logits, cache, _, _ = serve_tokens(
                torch, model, placed, {"tokens": prompt.to(dev)}, 32, 6,
                mesh, forced=forced)
            got[name] = (logits, gather(cache["lengths"], "cpu"))
            if name == "card":
                counts = read_counts(REPLACES)
                check_launches(f"sharded_serve parity {cfg.name} {shape}",
                               counts, ATTENTION_KERNELS)
        top = max(w.abs().max().item() for w in got["cpu"][0])
        err = max((a - b).abs().max().item()
                  for a, b in zip(got["card"][0], got["cpu"][0]))
        need(err <= 1e-4 * top, f"sharded_serve parity {cfg.name} {shape}: "
             f"the logits differ by {err:.3e} (tol 1e-4 x {top:.3e})")
        need(torch.equal(got["card"][1], got["cpu"][1]),
             f"sharded_serve parity {cfg.name} {shape}: lengths differ")
        print(f"sharded_serve: parity {cfg.name} mesh {shape} float32 "
              f"logits_max_abs_err={err:.3e} (tol 1e-4 x {top:.3e}) "
              f"launches flash_attention={counts['flash_attention'][0]} "
              f"decode_attention={counts['decode_attention'][0]} "
              f"s={time.perf_counter() - t0:.2f}", flush=True)


def run_sharded_serve_32k(torch, seed):
    """The four-card run: llama3-8b whole (bf16) on a (2, 2) mesh over the
    first four cards, SERVE_32K: prefill of 24 prompts of 32704 tokens into
    a 32768-row cache (the heads form: 4 of the 8 KV heads and 12 rows a
    card), 64 greedy decode steps. Prints the step's ms, tokens/s, each
    card's peak GB, the idle share over the cards of a profiled step and
    the ``roofline:`` line (the bytes each card must read a step over the
    memory rate). Rows 0-1 are then held to one card's unsharded prefill and
    decode of those rows (``serve_gap``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import (gather, param_shardings,
                                             place_tree)
    from repro_torch.models import get_model, make_batch
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    run = SERVE_32K
    cfg = get_config("llama3_8b")
    model = get_model(cfg)
    mesh = make_mesh((2, 2), ("data", "model"))
    cards = mesh.distinct()
    print(f"sharded_serve: four cards: mesh {mesh.shape} over "
          + ", ".join(str(d) for d in mesh.devices) + f", card {card_line()}",
          flush=True)
    for d in cards:
        torch.zeros((), device=d)
        torch.cuda.reset_peak_memory_stats(d)
    first = mesh.devices[0]
    params = model.init(seed, device=first)
    placed = place_tree(params, mesh, param_shardings(mesh, params))
    del params
    torch.cuda.empty_cache()
    batch = make_batch(cfg, "prefill", run["batch"], run["prompt"], seed,
                       device=first)
    init_s = time.perf_counter() - t0
    kernels.reset_counts()
    tokens, got, cache, prefill_s, step_s = serve_tokens(
        torch, model, placed, batch, run["max_len"], run["steps"], mesh,
        keep=slice(0, run["held_rows"]))
    counts = read_counts(REPLACES)
    label = f"sharded_serve {cfg.name} decode_32k B={run['batch']} four cards"
    check_launches(label, counts, ATTENTION_KERNELS)
    L = cfg.num_layers
    for k, n in (("flash_attention", L * mesh.size),
                 ("decode_attention", L * mesh.size * run["steps"])):
        need(counts[k][0] == n, f"{label}: {k} launched {counts[k][0]} "
             f"times, want {n}")
    peaks = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
    by_card = {d: 0 for d in cards}
    for w in leaves(placed) + [cache["k"], cache["v"]]:
        for pos, t in enumerate(w.parts):
            by_card[mesh.devices[pos]] += t.numel() * t.element_size()
    nbytes = max(by_card.values())
    memory_ms = nbytes / roofline.HBM_BW * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with activate_mesh(mesh):
            t1 = time.perf_counter()
            nxt = tokens[-1]
            for _ in range(4):
                _, cache = model.decode(placed, {"tokens": nxt}, cache)
            for d in cards:
                torch.cuda.synchronize(d)
            prof_s = time.perf_counter() - t1
    busy_s, top = device_busy(prof)
    idle = (max(0.0, 1.0 - busy_s / (prof_s * len(cards)))
            if busy_s > 0 else None)
    med = statistics.median(step_s[2:])
    print(f"{label}: prompt={run['prompt']} max_len={run['max_len']} "
          f"steps={run['steps']} init_s={init_s:.2f} prefill_s={prefill_s:.3f} "
          f"step_ms=" + ",".join(f"{x * 1e3:.2f}" for x in step_s[:8])
          + f",... median_step_ms={med * 1e3:.3f} (steps 3-{run['steps']}) "
          f"tokens_per_s={run['batch'] / med:.1f} peak_gb_per_card="
          + ",".join(f"{x:.3f}" for x in peaks) + " idle_share="
          + (f"{idle:.4f}" if idle is not None else "not measured")
          + f" (4 profiled steps, {prof_s:.4f} s, device busy "
          f"{busy_s:.4f} s over {len(cards)} cards) top: "
          + ", ".join(f"{k[:40]}={us / 1e3:.2f}ms" for k, us in top),
          flush=True)
    print(f"roofline: sharded_serve {cfg.name} decode B={run['batch']} "
          f"S={run['max_len']} mesh (2, 2) bytes_per_card=" + ",".join(
              f"{by_card[d]:.6e}" for d in cards)
          + f" memory_ms={memory_ms:.5f} (the fullest card at "
          f"{roofline.HBM_BW / 1e12:g} TB/s) tokens_per_s_bound="
          f"{run['batch'] / memory_ms * 1e3:.1f} measured_ms_per_step="
          f"{med * 1e3:.5f} measured_over_memory={med * 1e3 / memory_ms:.2f}",
          flush=True)
    del cache, placed, prof
    for d in cards:
        torch.cuda.empty_cache()
    # rows 0-1 on one card, unsharded, fed the sharded run's tokens
    rows = slice(0, run["held_rows"])
    params = model.init(seed, device=first)
    one = {k: v[rows] for k, v in batch.items()}
    _, want, _, base_prefill_s, base_s = serve_tokens(
        torch, model, params, one, run["max_len"], run["steps"],
        forced=tokens[:, rows])
    held = serve_gap(torch, f"{label} rows 0-1", got, want, tokens[:, rows])
    print(f"{label}: rows 0-1 against one card's unsharded run (prefill "
          f"{base_prefill_s:.3f} s, median step "
          f"{statistics.median(base_s[2:]) * 1e3:.3f} ms): {held} "
          f"s={time.perf_counter() - t0:.1f}", flush=True)
    del params, batch
    torch.cuda.empty_cache()
    return {k: (n, 0) for k, (n, _) in counts.items()}


# sharded_ssm: (arch, layers) at published width, bf16 with remat, each on
# the meshes SHARDED_SSM_MESHES repeating one card. rwkv6-1.6b cut from 24
# to 4 layers; zamba2-7b from 81 to 7: a group of six Mamba2 layers, the
# shared block, then one remainder layer, so that the remainder path runs.
# With four cards or more instead: zamba2-7b whole (81 layers, 6.75e9
# parameters) on (2, 2) over the first four, SSM_FOUR_STEPS steps.
SHARDED_SSM = (("rwkv6_1b6", 4), ("zamba2_7b", 7))
SHARDED_SSM_MESHES = ((2, 2), (1, 16))
SSM_TRAIN_STEPS, SSM_FOUR_STEPS, SSM_PARITY_STEPS = 3, 8, 2
SSM_PARITY_PROMPT, SSM_PARITY_MAX_LEN, SSM_PARITY_DECODE = 64, 96, 4


def sharded_train_run(torch, label, model, mesh, steps, seed,
                      seq=TRAIN_SEQ, keep=False):
    """``steps`` bf16 steps of ``model``'s train step with ZeRO-1 on
    ``mesh`` from ``sharded_state``, the last one under the profiler (CUDA
    events only), on batches of TRAIN_BATCH x ``seq`` from ``make_batch``
    at seeds ``seed``, ``seed`` + 1, ...: every loss finite, every parameter
    a finite, nonzero gradient at the first step, each kernel's launches
    exact (``train_launches`` a position a step). Prints the steps' ms,
    tokens/s, each card's peak GB and the last step's idle share over the
    cards. Returns the launch counts of the steps; with ``keep`` also the
    state and the steps' metrics."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.launch.mesh import activate_mesh
    from repro_torch.launch.sharding import Sharded
    from repro_torch.models import make_batch
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import leaves_with_paths

    cfg = model.cfg
    t0 = time.perf_counter()
    cards = mesh.distinct()
    for d in cards:
        torch.zeros((), device=d)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(d)
    state = sharded_state(torch, model, mesh, seed)
    torch.cuda.empty_cache()
    n_params = sum(math.prod(w.shape)
                   for _, w in leaves_with_paths(state["params"]))
    batches = [make_batch(cfg, "train", TRAIN_BATCH, seq, seed + i,
                          device=mesh.devices[0]) for i in range(steps)]
    step_fn = make_train_step(model, TrainConfig(
        learning_rate=3e-4, warmup_steps=2, total_steps=steps))
    real_update, seen = opt_mod.adamw_update, []

    def inspecting(params, grads, st, c, **kw):
        seen.extend(leaves_with_paths(grads))
        return real_update(params, grads, st, c, **kw)

    sync_all(torch, mesh)
    init_s = time.perf_counter() - t0
    kernels.reset_counts()
    metrics, step_ms = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    for i in range(steps):
        opt_mod.adamw_update = inspecting if i == 0 else real_update
        if i == steps - 1:
            prof.start()
        try:
            t1 = time.perf_counter()
            with activate_mesh(mesh):
                state, m = step_fn(state, batches[i])
            sync_all(torch, mesh)
            step_ms.append((time.perf_counter() - t1) * 1e3)
        finally:
            opt_mod.adamw_update = real_update
            if i == steps - 1:
                prof.stop()
        metrics.append(m)
    counts = read_counts(REPLACES)
    t1 = time.perf_counter()
    need(all(isinstance(g, Sharded) for _, g in seen), f"{label}: a "
         "gradient is not placed on the mesh")
    # each part's float32 sum of |g|: finite iff the part is, nonzero iff
    # some element is; one copy to the host for all of them
    sums = torch.stack([torch.stack([t.detach().float().abs().sum().to(
        mesh.devices[0]) for t in g.parts]) for _, g in seen]).cpu()
    bad = [path for (path, _), row in zip(seen, sums)
           if not (bool(torch.isfinite(row).all()) and bool((row > 0).any()))]
    need(len(seen) == len(leaves_with_paths(state["params"])) and not bad,
         f"{label}: parameters without a finite nonzero gradient: {bad[:6]}")
    del seen[:], sums
    grads_s = time.perf_counter() - t1
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    need(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
         f"{label}: a loss or grad_norm is not finite: {losses} {gnorms}")
    want = train_launches(cfg)
    check_launches(label, counts, tuple(want))
    for k, n in want.items():
        need(counts[k][0] == n * mesh.size * steps, f"{label}: {k} launched "
             f"{counts[k][0]} times in {steps} steps on {mesh.size} "
             f"positions, want {n} a position a step")
    peaks = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
    t1 = time.perf_counter()
    busy_s, top = raw_device_busy(prof)
    report_s = time.perf_counter() - t1
    prof_s = step_ms[-1] / 1e3
    idle = (max(0.0, 1.0 - busy_s / (prof_s * len(cards)))
            if busy_s > 0 else None)
    med = statistics.median(step_ms[1:])
    print(f"{label}: params={n_params} layers={cfg.num_layers} "
          f"B={TRAIN_BATCH} S={seq} steps={steps} init_s={init_s:.2f} "
          "losses=" + ",".join(f"{x:.5f}" for x in losses) + " grad_norms="
          + ",".join(f"{x:.4f}" for x in gnorms) + " gradients present, "
          f"finite and nonzero for all {len(leaves_with_paths(state['params']))}"
          " parameters; launches a position a step: " + " ".join(
              f"{k}={counts[k][0] // (mesh.size * steps)}" for k in want),
          flush=True)
    print(f"{label}: step_ms=" + ",".join(f"{x:.2f}" for x in step_ms)
          + f" median_step_ms={med:.3f} (steps 2-{steps}, the last "
          f"profiled) tokens_per_s={TRAIN_BATCH * seq / (med / 1e3):.1f}"
          " peak_gb_per_card=" + ",".join(f"{x:.3f}" for x in peaks)
          + f" (states {n_params * STATE_BYTES / 1e9:.2f} GB in all) last "
          f"step device_busy_s={busy_s:.4f} over {len(cards)} card(s) "
          "idle_share=" + (f"{idle:.4f}" if idle is not None else
                           "not measured (no device events)") + " top: "
          + ", ".join(f"{k[:40]}={us / 1e3:.2f}ms" for k, us in top)
          + f" s={time.perf_counter() - t0:.2f} (the gradients' check "
          f"{grads_s:.2f}, the profile's report {report_s:.2f})", flush=True)
    del batches, prof
    if keep:
        return counts, state, metrics
    del state, metrics
    torch.cuda.empty_cache()
    return counts


def ssm_serve_launches(cfg, mesh):
    """(launches of a prefill, of a decode step) of ``cfg`` on ``mesh``:
    each position runs every scan layer's kernel once and each application
    of the shared block its attention once."""
    P = mesh.size
    if cfg.family == "ssm":
        return {"rwkv6_scan": cfg.num_layers * P}, {}
    G = cfg.num_layers // cfg.attn_every
    return ({"mamba2_ssd": cfg.num_layers * P, "flash_attention": G * P},
            {"decode_attention": G * P})


def run_sharded_ssm(torch, seed):
    """Phase 24: rwkv6 and zamba2 on a model mesh through the entry points
    (``Model.loss`` in the train step, ``Model.prefill`` and ``.decode``
    under ``activate_mesh``; parameters placed by ``param_shardings``, the
    train state by ``shard_train_state``, the cache by ``launch.sharding.
    cache_shardings``). On one card, each of SHARDED_SSM on each of
    SHARDED_SSM_MESHES (repeating the card): SSM_TRAIN_STEPS ZeRO-1 steps
    (``sharded_train_run``), then a prefill of SERVE_BATCH x SERVE_PROMPT
    into SERVE_MAX_LEN rows and SERVE_STEPS greedy steps held to the same
    weights unsharded on the card (``serve_gap``), launches exact; then the
    smoke configs in float32, the card's (2, 2) mesh against the CPU's
    (``run_sharded_ssm_parity``). With four cards or more instead:
    zamba2-7b whole on (2, 2) over the first four for SSM_FOUR_STEPS steps.
    Returns the launch counts of the sharded runs."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import param_shardings, place_tree
    from repro_torch.models import get_model, make_batch

    t_phase = time.perf_counter()
    total = {k: 0 for k in REPLACES}
    if torch.cuda.device_count() >= 4:
        mesh = make_mesh((2, 2), ("data", "model"))
        print(f"sharded_ssm: four cards: mesh {mesh.shape} over "
              + ", ".join(str(d) for d in mesh.devices)
              + f", card {card_line()}", flush=True)
        model = get_model(get_config("zamba2_7b"))
        counts = sharded_train_run(
            torch, f"sharded_ssm {model.cfg.name} mesh (2, 2) four cards",
            model, mesh, SSM_FOUR_STEPS, seed)
        for k in total:
            total[k] += counts[k][0]
        run_sharded_ssm_parity(torch, seed)
        print(f"sharded_ssm: phase_s={time.perf_counter() - t_phase:.1f}",
              flush=True)
        return {k: (n, 0) for k, n in total.items()}
    print(f"sharded_ssm: card {card_line()}", flush=True)
    for arch, layers in SHARDED_SSM:
        cfg = get_config(arch).replace(num_layers=layers)
        need(cfg.remat and cfg.dtype == "bfloat16", f"sharded_ssm: "
             f"{cfg.name}'s config must train in bf16 with remat")
        model = get_model(cfg)
        params = model.init(seed, device="cuda")
        batch = make_batch(cfg, "prefill", SERVE_BATCH, SERVE_PROMPT, seed,
                           device="cuda")
        for shape in SHARDED_SSM_MESHES:
            t_run = time.perf_counter()
            mesh = make_mesh(shape, ("data", "model"), "cuda:0")
            label = f"sharded_ssm {cfg.name} mesh {shape}"
            counts = sharded_train_run(torch, label + " train", model, mesh,
                                       SSM_TRAIN_STEPS, seed)
            for k in total:
                total[k] += counts[k][0]
            placed = place_tree(params, mesh, param_shardings(mesh, params))
            # the prefill and the steps launch distinct kernels: the total
            # of each holds both counts
            pre_want, step_want = ssm_serve_launches(cfg, mesh)
            kernels.reset_counts()
            tokens, got, cache, prefill_s, step_s = serve_tokens(
                torch, model, placed, batch, SERVE_MAX_LEN, SERVE_STEPS, mesh)
            counts = read_counts(REPLACES)
            check_launches(label + " serve", counts,
                           tuple(pre_want) + tuple(step_want))
            for k in REPLACES:
                want = pre_want.get(k, 0) + SERVE_STEPS * step_want.get(k, 0)
                need(counts[k][0] == want, f"{label}: {k} launched "
                     f"{counts[k][0]} times in a prefill and {SERVE_STEPS} "
                     f"steps, want {want}")
                total[k] += counts[k][0]
            need(all(bool((t == SERVE_PROMPT + SERVE_STEPS).all())
                     for t in cache["lengths"].parts), f"{label}: lengths")
            specs = {k: c.spec for k, c in cache.items()}
            del cache, placed
            _, want_logits, _, base_prefill_s, base_s = serve_tokens(
                torch, model, params, batch, SERVE_MAX_LEN, SERVE_STEPS,
                forced=tokens)
            held = serve_gap(torch, label, got, want_logits, tokens)
            print(f"{label} serve: cache specs {specs} B={SERVE_BATCH} "
                  f"prompt={SERVE_PROMPT} max_len={SERVE_MAX_LEN} "
                  f"steps={SERVE_STEPS} prefill_s={prefill_s:.4f} "
                  f"median_step_ms={statistics.median(step_s[1:]) * 1e3:.3f} "
                  f"(unsharded {statistics.median(base_s[1:]) * 1e3:.3f}, "
                  f"prefill {base_prefill_s:.4f} s) launches a prefill "
                  + " ".join(f"{k}={n}" for k, n in pre_want.items())
                  + ", a step " + (" ".join(f"{k}={n}" for k, n in
                                            step_want.items()) or "none")
                  + f" {held} s={time.perf_counter() - t_run:.2f}",
                  flush=True)
            del got, want_logits
            torch.cuda.empty_cache()
        del params, batch
    run_sharded_ssm_parity(torch, seed)
    print(f"sharded_ssm: phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {k: (n, 0) for k, n in total.items()}


SSM_PARAM_ATOL = 5e-4    # sharded_ssm parity: AdamW moves an element whose
#                          gradient is near its eps (1e-8) by up to the
#                          learning rate (3e-4) a step on a rounding
#                          difference; the gradients are held first


def run_sharded_ssm_parity(torch, seed):
    """rwkv6's and zamba2's smoke configs in float32 on a (2, 2) mesh
    repeating the card and one repeating the CPU, from one initial state
    and the same batches: SSM_PARITY_STEPS ZeRO-1 steps (losses and
    ``grad_norm`` within 1e-4 relative, every leaf of the first step's
    gradient within 1e-3 of its largest magnitude, the parameters within
    ``SSM_PARAM_ATOL``); then, from the initial parameters, a prefill and
    SSM_PARITY_DECODE decode steps with fixed tokens (every logit within
    1e-4 of the largest, lengths equal)."""
    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import (gather, gather_tree,
                                             param_shardings, place_tree)
    from repro_torch.models import get_model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 shard_train_state)
    from repro_torch.tree import leaves

    f32 = dict(dtype="float32", param_dtype="float32")
    axes = ("data", "model")
    for arch, _ in SHARDED_SSM:
        t0 = time.perf_counter()
        cfg = get_smoke_config(arch).replace(**f32)
        model = get_model(cfg)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1,
                           total_steps=SSM_PARITY_STEPS)
        start = init_train_state(model, tcfg, seed, device="cpu")
        rng = np.random.default_rng(seed)
        batches = [_parity_batch(cfg, rng, 4, 64)
                   for _ in range(SSM_PARITY_STEPS)]
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (4, SSM_PARITY_PROMPT)))
        forced = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (SSM_PARITY_DECODE + 1, 4)))
        step = make_train_step(model, tcfg)
        real_update = opt_mod.adamw_update
        got = {}
        for name, dev in (("card", "cuda:0"), ("cpu", "cpu")):
            kernels.reset_counts()
            mesh = make_mesh(SHARDED_MESH, axes, dev)
            st, ms, first = shard_train_state(start, mesh, cfg), [], []

            def keeping(params, grads, state, c, **kw):
                if not first:
                    first.append(gather_tree(grads, "cpu"))
                return real_update(params, grads, state, c, **kw)

            opt_mod.adamw_update = keeping
            try:
                for b in batches:
                    with activate_mesh(mesh):
                        st, m = step(st, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()})
                    ms.append(m)
            finally:
                opt_mod.adamw_update = real_update
            placed = place_tree(start["params"], mesh,
                                param_shardings(mesh, start["params"]))
            _, logits, cache, _, _ = serve_tokens(
                torch, model, placed, {"tokens": prompt.to(dev)},
                SSM_PARITY_MAX_LEN, SSM_PARITY_DECODE + 1, mesh,
                forced=forced)
            got[name] = (gather_tree(st["params"], "cpu"), ms, first[0],
                         logits, gather(cache["lengths"], "cpu"))
            if name == "card":
                counts = read_counts(REPLACES)
                check_launches(f"sharded_ssm parity {cfg.name}", counts,
                               tuple(train_launches(cfg)))
        worst = 0.0
        for mc, mp in zip(got["card"][1], got["cpu"][1]):
            for k in ("loss", "grad_norm"):
                a, c = float(mc[k]), float(mp[k])
                rel = abs(a - c) / max(abs(c), 1e-30)
                worst = max(worst, rel)
                need(rel <= 1e-4, f"sharded_ssm parity {cfg.name}: {k} {a} "
                     f"on the card, {c} on the CPU")
        gerr = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                    1e-30)
                   for a, b in zip(leaves(got["card"][2]),
                                   leaves(got["cpu"][2])))
        need(gerr <= 1e-3, f"sharded_ssm parity {cfg.name}: a gradient leaf "
             f"differs by {gerr:.3e} of its largest magnitude")
        perr = max((a - b).abs().max().item() for a, b in zip(
            leaves(got["card"][0]), leaves(got["cpu"][0])))
        need(perr <= SSM_PARAM_ATOL, f"sharded_ssm parity {cfg.name}: "
             f"parameters differ by {perr:.3e} (tol {SSM_PARAM_ATOL})")
        top = max(w.abs().max().item() for w in got["cpu"][3])
        err = max((a - b).abs().max().item()
                  for a, b in zip(got["card"][3], got["cpu"][3]))
        need(err <= 1e-4 * top, f"sharded_ssm parity {cfg.name}: the logits "
             f"differ by {err:.3e} (tol 1e-4 x {top:.3e})")
        need(torch.equal(got["card"][4], got["cpu"][4]),
             f"sharded_ssm parity {cfg.name}: lengths differ")
        print(f"sharded_ssm: parity {cfg.name} mesh {SHARDED_MESH} float32 "
              f"steps={SSM_PARITY_STEPS} worst_rel_loss_or_grad_norm="
              f"{worst:.3e} (tol 1e-04) first step's gradient leaves "
              f"{gerr:.3e} of their largest (tol 1e-03) param_max_abs_err="
              f"{perr:.3e} (tol {SSM_PARAM_ATOL:.0e}) prefill "
              f"{SSM_PARITY_PROMPT} + {SSM_PARITY_DECODE} steps "
              f"logits_max_abs_err={err:.3e} (tol 1e-4 x {top:.3e}) "
              "launches " + " ".join(f"{k}={n}" for k, (n, _) in
                                     counts.items() if n)
              + f" s={time.perf_counter() - t0:.2f}", flush=True)


# sharded_whisper: whisper-base at its published width and depth (6 + 6
# layers, d 512, 8 heads of 64, 1500 frames, vocab 51865), bf16 with remat,
# on SHARDED_SSM_MESHES repeating one card. The train batch is 8 x 448
# decoder tokens, whisper's published decoder context (arXiv:2212.04356),
# beside 8 x 1500 frames; serve prefills 8 prompts of WHISPER_PROMPT tokens
# into a 64-row cache and decodes FAMILY_STEPS steps, as the whisper phase.
WHISPER_SEQ = 448
WHISPER_STEPS = 3                 # ZeRO-1 steps, then a topk and an int8 step
WHISPER_MAX_LEN = 64
WHISPER_TRAIN_REL = 2e-2          # loss and grad_norm, mesh against unsharded
#                                   on the card: both bf16, the mesh's
#                                   row-parallel partials summed in bf16
WHISPER_PARITY = {"layers": 1, "batch": 2, "tokens": 64, "steps": 4}
WHISPER_CKPT_LAYERS = 2           # the checkpoint's state: 2 + 2 layers


def whisper_reference(torch, model, cfg, seed, methods):
    """The unsharded run on the card of what ``run_sharded_whisper`` runs on
    a mesh: WHISPER_STEPS steps from the same initial state and batches as
    ``sharded_train_run``, then one step for each of ``methods`` with a
    zero error state. Returns the steps' (loss, grad_norm)."""
    from repro_torch.config import TrainConfig
    from repro_torch.models import make_batch
    from repro_torch.training import optimizer
    from repro_torch.training.grad_compress import init_error_state
    from repro_torch.training.train_loop import make_train_step

    params = model.init(seed, device="cuda")
    state = {"params": params, "opt": optimizer.init_opt_state(params)}
    out, ms = [], []
    kw = dict(learning_rate=3e-4, warmup_steps=2, total_steps=WHISPER_STEPS)
    for i, method in enumerate(["none"] * WHISPER_STEPS + list(methods)):
        t0 = time.perf_counter()
        if method != "none":
            state["err"] = init_error_state(state["params"])
        b = make_batch(cfg, "train", TRAIN_BATCH, WHISPER_SEQ,
                       seed + min(i, WHISPER_STEPS - 1), device="cuda")
        state, m = make_train_step(model, TrainConfig(
            grad_compression=method, **kw))(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        ms.append((time.perf_counter() - t0) * 1e3)
    print("sharded_whisper: the unsharded steps on the card, ms: "
          + ",".join(f"{x:.2f}" for x in ms), flush=True)
    del state
    torch.cuda.empty_cache()
    return out


def whisper_compression_exact(torch, cfg, meshes, seed) -> None:
    """A gradient tree of whisper-base's shapes in bf16 (random normal, so
    many values tie) and a float32 error state, compressed unsharded on the
    card; then on each of ``meshes``, placed as the train step holds them
    and compressed there: the thresholds, the scales, the compressed
    gradients and the new error state bit for bit the unsharded ones. Prints
    a line a mesh."""
    from repro_torch.launch.sharding import (Sharded, gather_tree,
                                             param_shardings, place_tree,
                                             zero1_shardings)
    from repro_torch.models.factory import param_specs
    from repro_torch.training import grad_compress as gc
    from repro_torch.training.optimizer import within
    from repro_torch.tree import leaves, map_tree

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)
    specs = param_specs(cfg)
    grads = map_tree(lambda t: torch.randn(t.shape, generator=gen,
                                           device="cuda").to(torch.bfloat16),
                     specs)
    err = map_tree(lambda t: 1e-2 * torch.randn(
        t.shape, generator=gen, device="cuda"), specs)
    groups = gc.stacked_groups(grads)
    g32 = [g.float() + e for g, e in zip(leaves(grads), leaves(err))]
    want_cut = {"topk": torch.stack([torch.topk(torch.cat(
        [g32[i].reshape(-1) for i in idx]).abs(), max(int(sum(
            g32[i].numel() for i in idx) * 0.125), 1)).values[-1]
        for idx in groups]),
        "int8": torch.stack([torch.max(torch.stack([
            g32[i].abs().max() for i in idx])) for idx in groups])
        / 127.0 + 1e-12}
    del g32
    want = {m: gc.compress(grads, err, method=m)[:2] for m in want_cut}
    base_s = time.perf_counter() - t0
    for mesh in meshes:
        t0 = time.perf_counter()
        sg = place_tree(grads, mesh, param_shardings(mesh, grads))
        se = place_tree(err, mesh, zero1_shardings(mesh, err))
        blocks = [Sharded(e.mesh, e.spec, e.shape, [
            g.parts[p][within(e.region(p), g.region(p))].float() + e.parts[p]
            for p in range(mesh.size)])
            for g, e in zip(leaves(sg), leaves(se))]
        cuts = {"topk": gc._thresholds(blocks, groups, 0.125),
                "int8": gc._scales(blocks, groups)}
        del blocks
        for method, (c0, e0) in want.items():
            need(torch.equal(cuts[method].view(torch.int32),
                             want_cut[method].view(torch.int32)),
                 f"sharded_whisper {mesh.shape}: the {method} cut of a group "
                 "differs from the unsharded one")
            c, e, _ = gc.compress(sg, se, method=method)
            for name, got, ref_ in (("gradients", c, c0),
                                    ("error state", e, e0)):
                same = all(torch.equal(a, b) for a, b in zip(
                    leaves(gather_tree(got)), leaves(ref_)))
                need(same, f"sharded_whisper {mesh.shape}: the {method} "
                     f"compressed {name} differ from the unsharded ones")
            del c, e
        del sg, se
        torch.cuda.synchronize()
        print(f"sharded_whisper whisper-base mesh {tuple(mesh.dims)} "
              f"compression: {len(groups)} groups, "
              f"{sum(t.numel() for t in leaves(grads))} elements: topk "
              "thresholds, int8 scales, compressed gradients and error "
              f"states bit-equal to the unsharded compress (s={base_s:.2f})"
              f" s={time.perf_counter() - t0:.2f}", flush=True)
    del grads, err, want
    torch.cuda.empty_cache()


def whisper_checkpoint(torch, cfg, seed) -> str:
    """The (2, 2) ZeRO-1 state of ``cfg`` after 2 steps saved through
    ``runtime.checkpoint`` and restored onto (2, 2) (by the state's
    ``Sharded`` leaves), onto (1, 16) (from ``meta`` specs and that mesh's
    ``train_state_shardings``) and unsharded: every restored leaf, gathered,
    bit for bit the saved one (the parameters, the step and the ZeRO-1
    moments, which the other mesh lays out anew); and the third step after
    the restore onto (2, 2) bit for bit the uninterrupted third step.
    Returns the line's report."""
    import tempfile

    from repro_torch.config import TrainConfig
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import gather_tree
    from repro_torch.models import get_model, make_batch
    from repro_torch.runtime import checkpoint
    from repro_torch.training import optimizer
    from repro_torch.training.train_loop import (make_train_step,
                                                 train_state_shardings,
                                                 train_state_specs)
    from repro_torch.tree import leaves, map_tree

    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=3)
    step = make_train_step(model, tcfg)
    mesh = make_mesh((2, 2), ("data", "model"), "cuda:0")
    state = sharded_state(torch, model, mesh, seed)
    batches = [make_batch(cfg, "train", TRAIN_BATCH, WHISPER_SEQ, seed + i,
                          device="cuda") for i in range(3)]
    for b in batches[:2]:
        with activate_mesh(mesh):
            state, _ = step(state, b)
    saved = optimizer.clone_tree(state)
    with activate_mesh(mesh):
        state, _ = step(state, batches[2])
    whole = gather_tree(saved)
    want = leaves(whole)
    nbytes = sum(x.numel() * x.dtype.itemsize for x in want)
    times = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        checkpoint.save(root, 2, saved)
        save_s = time.perf_counter() - t0
        del saved
        for target in ((2, 2), (1, 16), None):
            t0 = time.perf_counter()
            if target == (2, 2):
                got, _ = checkpoint.restore(root, state)
            elif target is None:
                got, _ = checkpoint.restore(root, map_tree(
                    torch.empty_like, whole))
            else:
                tmesh = make_mesh(target, ("data", "model"), "cuda:0")
                specs = train_state_specs(model, tcfg)
                got, _ = checkpoint.restore(root, specs, shardings=(
                    train_state_shardings(tmesh, specs, cfg)))
            torch.cuda.synchronize()
            times[target] = time.perf_counter() - t0
            back = leaves(got if target is None else gather_tree(got))
            need(len(back) == len(want) and all(
                torch.equal(a, b) for a, b in zip(back, want)),
                f"sharded_whisper checkpoint: the state restored onto "
                f"{target} differs from the saved one")
            del back
            if target == (2, 2):
                with activate_mesh(mesh):
                    got, _ = step(got, batches[2])
                same = all(torch.equal(a, b) for a, b in zip(
                    [t for x in leaves(got) for t in x.parts],
                    [t for x in leaves(state) for t in x.parts]))
                need(same, "sharded_whisper checkpoint: the third step after "
                     "a restore onto (2, 2) differs from the uninterrupted "
                     "one")
            del got
    del state, whole, want
    torch.cuda.empty_cache()
    return (f"checkpoint ({cfg.encoder_layers} + {cfg.num_layers} layers of "
            f"{cfg.name}, {nbytes / 1e6:.1f} MB "
            f"of state) save_s={save_s:.2f} restore_s (2, 2) "
            f"{times[(2, 2)]:.2f}, (1, 16) {times[(1, 16)]:.2f} from meta "
            f"specs, unsharded {times[None]:.2f}: every leaf bit-equal to the "
            "saved state; the third step after the (2, 2) restore bit-equal "
            "to the uninterrupted one")


def run_sharded_whisper_parity(torch, seed) -> str:
    """whisper-base at full width and WHISPER_PARITY's depth in float32 on a
    (2, 2) mesh repeating the card and one repeating the CPU: the loss and
    every gradient leaf of one batch of 2 x 64 tokens beside 1500 frames,
    then a prefill and 4 decode steps with fixed tokens (every logit within
    1e-4 of the largest, lengths equal)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import (Sharded, gather, gather_tree,
                                             param_shardings, place_tree)
    from repro_torch.models import get_model
    from repro_torch.training import optimizer
    from repro_torch.tree import leaves, map_tree

    t0 = time.perf_counter()
    p = WHISPER_PARITY
    cfg = get_config("whisper_base").replace(
        dtype="float32", param_dtype="float32", num_layers=p["layers"],
        encoder_layers=p["layers"])
    model = get_model(cfg)
    params = model.init(seed, device="cpu")
    rng = np.random.default_rng(seed)
    batch = _parity_batch(cfg, rng, p["batch"], p["tokens"])
    prompt = {"frames": torch.from_numpy(batch["frames"]),
              "tokens": torch.from_numpy(batch["tokens"][:, :16]).long()}
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (p["steps"] + 1, p["batch"])))
    got = {}
    for name, dev in (("card", "cuda:0"), ("cpu", "cpu")):
        t1 = time.perf_counter()
        mesh = make_mesh(SHARDED_MESH, ("data", "model"), dev)
        placed = place_tree(params, mesh, param_shardings(mesh, params))
        parts = [t for w in leaves(placed) for t in w.parts]
        for t in parts:
            t.requires_grad_(True)
        with activate_mesh(mesh):
            loss, _ = model.loss(placed, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})
        g = iter(torch.autograd.grad(loss, parts, allow_unused=True,
                                     materialize_grads=True))
        loss = loss.detach()
        for t in parts:
            t.requires_grad_(False)
        grads = map_tree(lambda w: Sharded(w.mesh, w.spec, w.shape,
                                           [next(g) for _ in w.parts]),
                         placed)
        grads = gather_tree(optimizer.reduce_grads(grads), "cpu")
        _, logits, cache, _, _ = serve_tokens(
            torch, model, placed, {k: v.to(dev) for k, v in prompt.items()},
            WHISPER_MAX_LEN, p["steps"] + 1, mesh, forced=forced)
        got[name] = (loss.item(), grads, logits,
                     gather(cache["lengths"], "cpu"),
                     time.perf_counter() - t1)
        del placed, parts, cache
    card, cpu = got["card"], got["cpu"]
    lrel = abs(card[0] - cpu[0]) / abs(cpu[0])
    need(lrel <= 1e-4, f"sharded_whisper parity: loss {card[0]} on the card, "
         f"{cpu[0]} on the CPU")
    gerr = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(leaves(card[1]), leaves(cpu[1])))
    need(gerr <= 1e-3, f"sharded_whisper parity: a gradient leaf differs by "
         f"{gerr:.3e} of its largest magnitude")
    top = max(w.abs().max().item() for w in cpu[2])
    err = max((a - b).abs().max().item() for a, b in zip(card[2], cpu[2]))
    need(err <= 1e-4 * top, f"sharded_whisper parity: the logits differ by "
         f"{err:.3e} (tol 1e-4 x {top:.3e})")
    need(torch.equal(card[3], cpu[3]), "sharded_whisper parity: lengths "
         "differ")
    return (f"parity {cfg.name} at {p['layers']} + {p['layers']} layers, "
            f"mesh {SHARDED_MESH}, float32, B={p['batch']} S={p['tokens']}: "
            f"loss rel {lrel:.3e} (tol 1e-04), gradient leaves {gerr:.3e} "
            f"of their largest (tol 1e-03), prefill 16 + {p['steps']} steps "
            f"logits_max_abs_err={err:.3e} (tol 1e-4 x {top:.3e}), card_s="
            f"{card[4]:.2f} cpu_s={cpu[4]:.2f} s="
            f"{time.perf_counter() - t0:.2f}")


def run_sharded_whisper(torch, seed):
    """Phase 25: whisper-base (the ``encdec`` family) on a model mesh through
    the entry points (the train step on ``Model.loss``, ``Model.prefill`` and
    ``.decode`` under ``activate_mesh``), on SHARDED_SSM_MESHES repeating
    the card. On each mesh: WHISPER_STEPS ZeRO-1 bf16 steps of 8 x
    WHISPER_SEQ tokens beside 8 x 1500 frames (``sharded_train_run``: every
    parameter a finite nonzero gradient), then a ``topk`` and an ``int8``
    step, each from a zero error state; every loss and ``grad_norm`` held to
    the same steps unsharded on the card within WHISPER_TRAIN_REL; a
    prefill of 8 x WHISPER_PROMPT tokens beside 1500 frames into
    WHISPER_MAX_LEN rows and FAMILY_STEPS greedy steps held to the
    unsharded run (``serve_gap``); launches exact. Then one gradient tree
    compressed on each mesh bit for bit as unsharded
    (``whisper_compression_exact``), the checkpoint
    (``whisper_checkpoint``) and the float32 parity, card against CPU
    (``run_sharded_whisper_parity``). Returns the launch counts of the
    sharded train and serve runs."""
    from repro_torch import kernels
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import empty_on_mesh
    from repro_torch.launch.mesh import activate_mesh, make_mesh
    from repro_torch.launch.sharding import (param_shardings, place_tree,
                                             zero1_shardings)
    from repro_torch.models import get_model, make_batch
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import map_tree

    t_phase = time.perf_counter()
    print(f"sharded_whisper: card {card_line()}", flush=True)
    cfg = get_config("whisper_base")
    need(cfg.remat and cfg.dtype == "bfloat16", "sharded_whisper: "
         f"{cfg.name}'s config must train in bf16 with remat")
    model = get_model(cfg)
    methods = ("topk", "int8")
    total = {k: 0 for k in REPLACES}
    t0 = time.perf_counter()
    want_train = whisper_reference(torch, model, cfg, seed, methods)
    ref_s = time.perf_counter() - t0
    params = model.init(seed, device="cuda")
    batch = make_batch(cfg, "prefill", DECODE_PROMPTS, WHISPER_PROMPT, seed,
                       device="cuda")
    per_step = train_launches(cfg)
    layers = cfg.num_layers + cfg.encoder_layers
    for shape in SHARDED_SSM_MESHES:
        t_run = time.perf_counter()
        mesh = make_mesh(shape, ("data", "model"), "cuda:0")
        P = mesh.size
        label = f"sharded_whisper {cfg.name} mesh {shape}"
        counts, state, metrics = sharded_train_run(
            torch, label + " train", model, mesh, WHISPER_STEPS, seed,
            seq=WHISPER_SEQ, keep=True)
        b = make_batch(cfg, "train", TRAIN_BATCH, WHISPER_SEQ,
                       seed + WHISPER_STEPS - 1, device="cuda")
        err_specs = map_tree(lambda w: torch.empty(
            w.shape, dtype=torch.float32, device="meta"), state["params"])
        err_sh = zero1_shardings(mesh, err_specs)
        kernels.reset_counts()
        t1 = time.perf_counter()
        for method in methods:
            state["err"] = empty_on_mesh(err_specs, err_sh, mesh)
            with activate_mesh(mesh):
                state, m = make_train_step(model, TrainConfig(
                    grad_compression=method, learning_rate=3e-4,
                    warmup_steps=2, total_steps=WHISPER_STEPS))(state, b)
            metrics.append(m)
        sync_all(torch, mesh)
        comp_s = time.perf_counter() - t1
        comp_counts = read_counts(REPLACES)
        check_launches(label + " compressed steps", comp_counts,
                       tuple(per_step))
        for k in REPLACES:
            n = counts[k][0] + comp_counts[k][0]
            want = per_step.get(k, 0) * P * (WHISPER_STEPS + len(methods))
            need(n == want, f"{label}: {k} launched {n} times in "
                 f"{WHISPER_STEPS + len(methods)} steps, want {want}")
            total[k] += n
        ratio = TrainConfig().compression_ratio
        need(float(metrics[-2]["compress_ratio"]) == ratio * 8 / 2 and
             float(metrics[-1]["compress_ratio"]) == 0.5,
             f"{label}: compress_ratio")
        worst = 0.0
        for i, (m, (loss0, gn0)) in enumerate(zip(metrics, want_train)):
            for k, want in (("loss", loss0), ("grad_norm", gn0)):
                got = float(m[k])
                rel = abs(got - want) / abs(want)
                worst = max(worst, rel)
                need(math.isfinite(got) and rel <= WHISPER_TRAIN_REL,
                     f"{label}: step {i + 1} {k} {got} on the mesh, {want} "
                     f"unsharded (tol {WHISPER_TRAIN_REL} relative)")
        print(f"{label} train: the {len(methods)} compressed steps "
              + " ".join(f"{k}: loss={float(m['loss']):.5f} grad_norm="
                         f"{float(m['grad_norm']):.4f} compress_ratio="
                         f"{float(m['compress_ratio'])}" for k, m in
                         zip(methods, metrics[-len(methods):]))
              + f" s={comp_s:.2f}; every loss and grad_norm against the "
              f"unsharded steps on the card (s={ref_s:.2f}): worst rel "
              f"{worst:.3e} (tol {WHISPER_TRAIN_REL}) launches a position a "
              "step: " + " ".join(f"{k}={n}" for k, n in per_step.items()),
              flush=True)
        del state, metrics, b
        torch.cuda.empty_cache()
        placed = place_tree(params, mesh, param_shardings(mesh, params))
        kernels.reset_counts()
        tokens, got, cache, prefill_s, step_s = serve_tokens(
            torch, model, placed, batch, WHISPER_MAX_LEN, FAMILY_STEPS, mesh)
        counts = read_counts(REPLACES)
        serve_want = {"flash_attention": layers * P,
                      "decode_attention": cfg.num_layers * P * FAMILY_STEPS}
        check_launches(label + " serve", counts, tuple(serve_want))
        for k in REPLACES:
            need(counts[k][0] == serve_want.get(k, 0), f"{label}: {k} "
                 f"launched {counts[k][0]} times in a prefill and "
                 f"{FAMILY_STEPS} steps, want {serve_want.get(k, 0)}")
            total[k] += counts[k][0]
        need(all(bool((t == WHISPER_PROMPT + FAMILY_STEPS).all())
                 for t in cache["lengths"].parts), f"{label}: lengths")
        specs = {k: c.spec for k, c in cache.items()}
        form = ("the sequence form (decode_attention_lse)"
                if "model" in str(specs["self_k"][2]) else "the heads form")
        del cache, placed
        _, want_logits, _, base_prefill_s, base_s = serve_tokens(
            torch, model, params, batch, WHISPER_MAX_LEN, FAMILY_STEPS,
            forced=tokens)
        held = serve_gap(torch, label, got, want_logits, tokens)
        print(f"{label} serve: cache specs {specs} B={DECODE_PROMPTS} "
              f"prompt={WHISPER_PROMPT} frames={cfg.encoder_seq_len} "
              f"max_len={WHISPER_MAX_LEN} steps={FAMILY_STEPS} "
              f"prefill_s={prefill_s:.4f} median_step_ms="
              f"{statistics.median(step_s[1:]) * 1e3:.3f} (unsharded "
              f"{statistics.median(base_s[1:]) * 1e3:.3f}, prefill "
              f"{base_prefill_s:.4f} s) launches a prefill flash_attention="
              f"{layers * P}, a step decode_attention={cfg.num_layers * P} "
              f"in {form} {held} s={time.perf_counter() - t_run:.2f}",
              flush=True)
        del got, want_logits
        torch.cuda.empty_cache()
    del params, batch
    torch.cuda.empty_cache()
    whisper_compression_exact(torch, cfg, [make_mesh(
        shape, ("data", "model"), "cuda:0") for shape in SHARDED_SSM_MESHES],
        seed)
    t0 = time.perf_counter()
    report = whisper_checkpoint(torch, cfg.replace(
        num_layers=WHISPER_CKPT_LAYERS, encoder_layers=WHISPER_CKPT_LAYERS),
        seed)
    print(f"sharded_whisper: {report} s={time.perf_counter() - t0:.2f}",
          flush=True)
    print("sharded_whisper: " + run_sharded_whisper_parity(torch, seed),
          flush=True)
    print("sharded_whisper: launches " + " ".join(
        f"{k}={total[k]}" for k in ("flash_attention", "flash_attention_bwd",
                                    "decode_attention"))
          + " (decode_attention counts the lse form's launches at (1, 16)) "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return {k: (n, 0) for k, n in total.items()}


# ---------------------------------------------------------------------------
# phase 26: the dry run on fake tensors, and against the card
# ---------------------------------------------------------------------------
# (a): full-width cells on the production (16, 16) mesh of fake cuda
# positions, each in a process of its own started after the build, beside
# the phases that use the card (they use the host's CPU only)
DRYRUN_CELLS = (("llama3_8b", "decode_32k"), ("llama3_8b", "train_4k"))
DRYRUN_NICE = 5           # below the phases that time the card
# (b): the tracker's peak over all positions against the card's
# max_memory_allocated (less what the card held before that is not an
# argument of the step): within this fraction, written before the first run
DRYRUN_MARGIN = 0.05


def start_dryrun(tmp: Path):
    """Phase 26 (a) in the background: ``python -m
    repro_torch.launch.dryrun`` for each of ``DRYRUN_CELLS`` at full width
    on the production single-pod mesh, its output under ``tmp``. Returns the
    processes; ``finish_dryrun`` waits for them, and they are killed at
    exit if it never does."""
    import atexit
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log = open(tmp / f"{arch}__{shape}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(tmp)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            preexec_fn=lambda: os.nice(DRYRUN_NICE))
        procs.append((arch, shape, proc, log))

    def stop():
        for _, _, proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    atexit.register(stop)
    return procs


def finish_dryrun(procs, tmp: Path):
    """Wait for phase 26 (a)'s processes; print each cell's peak GB a
    position, collective bytes and roofline terms. Returns {cell: result}."""
    out = {}
    for arch, shape, proc, log in procs:
        t0 = time.perf_counter()
        rc = proc.wait()
        log.flush()
        text = (tmp / f"{arch}__{shape}.log").read_text()
        need(rc == 0, f"dryrun: {arch} {shape} exited {rc}:\n{text[-3000:]}")
        with open(tmp / f"{arch}__{shape}__single.json") as fh:
            r = json.load(fh)
        need(r["ok"] and not r.get("skipped"),
             f"dryrun: {arch} {shape}: {r.get('error')}")
        m, t, c = r["memory"], r["roofline"], r["collectives"]
        print(f"dryrun: (a) {arch} {shape} mesh {r['mesh_shape']} fake "
              f"{r['device']}: {r['depth']['mode']} (layers traced "
              f"{r['depth']['layers']}, checked "
              f"{r['depth'].get('checked_layers', [])}) trace_s="
              f"{r['trace_s']} waited_s={time.perf_counter() - t0:.1f} "
              f"peak_gb={m['peak_gb']:.4f} (position {m['position']}: "
              f"argument {m['argument_gb']:.4f}, temp {m['temp_gb']:.4f}, "
              f"output {m['output_gb']:.4f}) all_positions_peak_gb="
              f"{m['all_positions_peak_gb']:.2f}", flush=True)
        print(f"dryrun: (a) {arch} {shape} collectives a device a step "
              f"(position {r['collective_position']}): "
              + " ".join(f"{k}={v:.6e}" for k, v in sorted(c.items()))
              + f"; flops a position {r['cost_analysis_raw']['flops']:.6e}",
              flush=True)
        print(f"dryrun: (a) {arch} {shape} roofline compute_ms="
              f"{t['compute_s'] * 1e3:.5f} memory_ms={t['memory_s'] * 1e3:.5f}"
              f" collective_ms={t['collective_s'] * 1e3:.5f} dominant="
              f"{t['dominant']} useful_ratio={t['useful_ratio']:.4f} "
              f"roofline_mfu={t['roofline_mfu']:.4f}; top sites: "
              + "; ".join(f"{b:.4e} {kind} x{n} {site}" for b, kind, n, _,
                          site in r["collective_sites"][:4]), flush=True)
        need(m["peak_gb"] > m["argument_gb"] > 0 and c["total"] > 0
             and r["cost_analysis_raw"]["flops"] > 0,
             f"dryrun: {arch} {shape}: empty figures")
        kern = r["kernels"]
        need("flash_attention" in kern if shape == "train_4k"
             else "decode_attention" in kern,
             f"dryrun: {arch} {shape}: no kernel call ({sorted(kern)})")
        out[f"{arch}__{shape}"] = r
    return out


def dryrun_against_card(torch, label, cfg, shape, mesh, tcfg):
    """Phase 26 (b): the cell traced on fake tensors, then its step run for
    real on the card (after one step that builds and allocates what stays),
    both under the collective counter and the memory tracker. Every number
    of the two records must be equal, and the tracker's peak within
    ``DRYRUN_MARGIN`` of the card's ``max_memory_allocated``, per card
    where the positions are on cards of their own."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    fake = dryrun.trace_cell(cfg, shape, mesh, tcfg, fake=True)
    fake_s = time.perf_counter() - t0
    cell = dryrun.build_cell(cfg, shape, mesh, tcfg)
    args = dryrun.cell_arguments(cell, mesh)
    cell[0](*args)
    sync_all(torch, mesh)
    cards = mesh.distinct()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    before = {d: torch.cuda.memory_allocated(d) for d in cards}
    real = dryrun.measure_step(cell[0], args, mesh)
    sync_all(torch, mesh)
    peak = {d: torch.cuda.max_memory_allocated(d) for d in cards}
    missed = dryrun.differ(fake["nums"], real["nums"])
    need(not missed, f"dryrun: (b) {label}: the fake run differs from the "
         "card's in " + ", ".join(f"{k} {fake['nums'].get(k)} != "
                                  f"{real['nums'].get(k)}" for k in missed[:8]))
    need(fake["shapes"] == real["shapes"], f"dryrun: (b) {label}: sites differ")
    nums = real["nums"]
    if len(cards) == 1:
        args_bytes = sum(nums[f"mem|{p}|argument"] for p in range(mesh.size))
        groups = [(cards[0], nums["mem_all|peak"], args_bytes)]
    else:
        groups = [(mesh.devices[p], nums[f"mem|{p}|peak"],
                   nums[f"mem|{p}|argument"]) for p in range(mesh.size)]
    ratios = []
    for d, tracked, args_bytes in groups:
        held = before[d] - int(args_bytes)   # on the card, not the step's
        card = peak[d] - held
        ratios.append(tracked / card)
        print(f"dryrun: (b) {label} on {d}: tracker peak {int(tracked)} B, "
              f"card max_memory_allocated {peak[d]} B less {held} B held "
              f"before = {int(card)} B, ratio {tracked / card:.6f}",
              flush=True)
    coll = {k.split("|", 2)[2]: v for k, v in nums.items()
            if k.startswith("coll|0|")}
    print(f"dryrun: (b) {label} mesh {mesh.shape}: fake == card in all "
          f"{len(nums)} numbers (collectives {coll}, "
          f"{sum(1 for k in nums if k.startswith('site|'))} site entries, "
          f"peaks {[int(nums[f'mem|{p}|peak']) for p in range(mesh.size)]}, "
          f"flops {nums['flops']:.6e}); fake trace {fake_s:.2f} s, card step "
          f"{real['seconds']:.2f} s", flush=True)
    need(all(abs(r - 1) <= DRYRUN_MARGIN for r in ratios),
         f"dryrun: (b) {label}: tracker peak over the card's "
         f"{[round(r, 6) for r in ratios]} outside 1 +- {DRYRUN_MARGIN}")
    return ratios


def run_dryrun(torch, procs, tmp: Path):
    """Phase 26: (a) the background cells' results; (b) ``sharded_train``'s
    llama3-8b cell (2 layers, 8 x 512, (2, 2)) and a ``sharded_serve``
    decode cell (llama3-8b at 2 layers, 8 sequences against 4096 rows,
    (2, 2)) each traced on fake tensors and run on the card, to the byte;
    one card a position with four cards or more. Returns (a)'s results."""
    from repro_torch.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    four = torch.cuda.device_count() >= 4
    mesh = make_mesh(SHARDED_MESH, ("data", "model"),
                     None if four else "cuda:0")
    cfg = get_config("llama3_8b").replace(num_layers=2)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=SHARDED_STEPS[four])
    torch.cuda.empty_cache()
    dryrun_against_card(torch, "sharded_train llama3_8b 2 layers", cfg,
                        ShapeConfig("train", seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, kind="train"),
                        mesh, tcfg)
    torch.cuda.empty_cache()
    dryrun_against_card(torch, "sharded_serve llama3_8b decode", cfg,
                        ShapeConfig("decode", seq_len=SERVE_MAX_LEN,
                                    global_batch=SERVE_BATCH, kind="decode"),
                        mesh, tcfg)
    torch.cuda.empty_cache()
    print(f"dryrun: (b) done at {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    results = finish_dryrun(procs, tmp)
    print(f"dryrun: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return results


def roofline_line(phase, cfg, batch, context, ms_per_step) -> None:
    """The analytic bytes and FLOPs of one decode step of ``cfg`` at
    ``batch`` sequences of ``context`` tokens on one card
    (``repro_torch.launch.roofline``), its memory term, the measured time
    of a step and their ratio."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import roofline
    shape = ShapeConfig(f"{phase}_decode", seq_len=context,
                        global_batch=batch, kind="decode")
    by = roofline.analytic_bytes(cfg, shape, num_devices=1, tp=1)
    fl = roofline.analytic_flops(cfg, shape)
    terms = roofline.roofline_terms(cfg, shape, num_devices=1, tp=1,
                                    collective_bytes_per_dev=0.0)
    memory_ms = terms["memory_s"] * 1e3
    print(f"roofline: {phase} {cfg.name} decode B={batch} S={context} "
          f"bytes={by.total:.6e} (weights {by.weights:.6e}, cache "
          f"{by.cache:.6e}, activations {by.activations:.6e}) "
          f"flops={fl.hlo_equiv:.6e} memory_ms={memory_ms:.5f} "
          f"compute_ms={terms['compute_s'] * 1e3:.5f} dominant="
          f"{terms['dominant']} measured_ms_per_step={ms_per_step:.5f} "
          f"measured_over_memory={ms_per_step / memory_ms:.2f}", flush=True)


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, which
    nests it in one (anonymous) namespace: ``ssd_bwd_bf16_kernel<Li1>``."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled[:72]
    pos = m.end() + int(m.group(1))
    n = re.match(r"\d+", mangled[pos:])
    if not n:
        return mangled[:72]
    start = pos + n.end()
    name = mangled[start:start + int(n.group())]
    targs = re.match(r"I(.*?)E(?=E)", mangled[start + int(n.group()):])
    return name + (f"<{targs.group(1)}>" if targs else "")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def device_us_by_name(prof):
    """Device microseconds of each device item of a profile, by name."""
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                    # host ops: their kernels count below
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    return by_name


def device_busy(prof):
    """(device busy seconds, the eight largest device items in us)."""
    by_name = device_us_by_name(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()) / 1e6, top


def raw_device_busy(prof):
    """``device_busy`` from the profile's raw device events, without parsing
    them into the profiler's event tree (``key_averages`` takes seconds on a
    step of a 16-position mesh)."""
    from torch.autograd import DeviceType
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
            by_name[ev.name()] = (by_name.get(ev.name(), 0.0)
                                  + ev.duration_ns() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()) / 1e6, top


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    started = time.perf_counter()

    def stamp(phase):
        print(f"time: {phase} done at {time.perf_counter() - started:.1f} s",
              flush=True)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    smi_line = card_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    peaks = peaks_for(name)
    print(smi_line)
    print(f"device: {name} capability={cap[0]}.{cap[1]} torch={torch.__version__}"
          f" cuda={torch.version.cuda} peaks: {peaks['bytes'] / 1e12:.2f} TB/s, "
          f"{peaks['fp32'] / 1e12:.0f} TFLOP/s fp32, "
          f"{peaks['bf16'] / 1e12:.0f} TFLOP/s bf16 (tensor cores, dense)",
          flush=True)
    need(cap == (9, 0), f"compute capability {cap}, need 9.0 (sm_90a)")

    # 2. build --------------------------------------------------------------
    lib = _build.library()
    regs, entry = [], ""
    for ln in lib.ptxas.splitlines():          # each kernel's registers and spills
        if "Compiling entry function" in ln:
            entry = kernel_name(ln.split("'")[1] if "'" in ln else ln.strip())
        elif "registers" in ln or "spill" in ln:
            regs.append(f"{entry}: {ln.strip()}")
    print(f"build: {' '.join(p.name for p in lib.paths)} "
          f"nvcc_s={lib.build_s:.2f}", flush=True)
    for ln in regs:
        print(f"build: {ln}")

    stamp("build")

    # 26 (a) starts here, on the host's CPU beside the card's phases
    import tempfile
    dryrun_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dryrun_procs = start_dryrun(dryrun_tmp)

    # 3. kernel checks ------------------------------------------------------
    results = check_kernels(torch, peaks, args.seed)
    results.update(check_attention_bwd(torch, peaks, args.seed))
    results.update(check_scan_bwd(torch, peaks, args.seed))
    stamp("check")

    # 4. the main path ------------------------------------------------------
    from repro_torch.obs import MemorySink, Observability, Tracer
    t0 = time.perf_counter()
    wl = make_slice_workload(args.seed)
    gen_s = time.perf_counter() - t0
    sink = MemorySink()
    obs = Observability(tracer=Tracer(sink=sink, enabled=True))

    kernels.reset_counts()
    mf, answers, ingest_s, query_s = run_slice(torch, wl, "cuda", obs)
    counts = read_counts(REPLACES)

    turns = sum(len(s.turns) for s in wl.sessions)
    print(f"slice: sessions={len(wl.sessions)} turns={turns} "
          f"queries={len(wl.queries)} gen_s={gen_s:.3f} "
          f"stats={mf.scale_stats()} device_bytes={mf.device_bytes()}")
    print(f"slice: ingest_s={ingest_s:.4f} "
          f"sessions_per_s={len(wl.sessions) / ingest_s:.1f}")
    print("slice: queries_per_s " + " ".join(
        f"{m}={len(wl.queries) / s:.1f}" for m, s in query_s.items()))
    totals = span_totals(sink)
    print("slice: span_s " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(totals.items())), flush=True)
    browse_spans("slice", sink)
    print("slice: launches " + " ".join(
        f"{k}={n} plain={p}" for k, (n, p) in counts.items()))
    for k, (n, p) in counts.items():
        need(n > 0 or k not in SLICE_KERNELS,
             f"{k} never launched on the main path")
        need(p == 0, f"{k} ran its plain version {p} times on CUDA")

    check_level_upload(torch, mf, wl)

    texts = [t.text for s in wl.sessions[:16] for t in s.turns]
    e1 = mf.encoder.encode(texts)
    e2 = mf.encoder.encode(texts)
    need(e1.tobytes() == e2.tobytes(), "two encodes of one batch differ")
    print(f"slice: encoder repeatable, {len(texts)} texts bitwise equal")

    from torch.profiler import ProfilerActivity
    profiled_repeat(torch, "slice",
                    lambda: (run_slice(torch, wl, "cuda"),
                             torch.cuda.synchronize()),
                    ingest_s + sum(query_s.values()),
                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])

    cpu_mf, cpu_answers, cpu_ingest_s, cpu_query_s = run_slice(torch, wl, "cpu")
    print(f"slice: cpu rerun ingest_s={cpu_ingest_s:.4f} matches: "
          + compare_systems(mf, cpu_mf, answers, cpu_answers), flush=True)
    del cpu_mf
    stamp("slice")

    # 4a. the slice memory through meshes on the card -----------------------
    sharded_counts = run_sharded(torch, wl, mf, answers)
    del mf
    stamp("sharded")

    # 4b. the write-path ablations of Figure 6 ------------------------------
    ablation_counts = run_ablations(torch, wl)
    stamp("ablations")

    # 5. the serve engine on llama3-8b ---------------------------------------
    serve_counts, serve_mesh_counts = run_serve(torch, wl, args.seed)
    add_counts(sharded_counts, serve_mesh_counts)
    stamp("serve")

    # 6. the same engine on the card and on the CPU --------------------------
    run_parity(torch, args.seed)
    stamp("parity")

    # 7-8. the serve engine on zamba2-7b and rwkv6-1.6b ----------------------
    ssm_counts = {}
    for phase in SSM_ARCHS:
        if phase == "rwkv6":
            ssm_counts[phase], rwkv6_run = run_ssm_serve(
                torch, wl, args.seed, phase, keep=True)
        else:
            ssm_counts[phase] = run_ssm_serve(torch, wl, args.seed, phase)
        stamp(phase)

    # 9. both on the card and on the CPU --------------------------------------
    run_ssm_parity(torch, args.seed)
    stamp("ssm_parity")

    # 10. durability and maintenance of the memory on the card ---------------
    durable_counts = run_durable(torch, wl, args.seed)
    stamp("durable")

    # 11. the engine's maintenance lane on rwkv6-1.6b -------------------------
    lane_counts = run_maintenance_lane(torch, wl, rwkv6_run)
    stamp("maintenance_lane")

    # 12. MemForest beside the paper's five baselines ------------------------
    baseline_counts = run_baselines(torch, wl, args.seed)
    stamp("baselines")

    # 13. tenant residency: the manager, then the engine's lane on rwkv6 -----
    residency_counts = run_residency(torch, wl, args.seed, rwkv6_run)
    del rwkv6_run
    torch.cuda.empty_cache()
    stamp("residency")

    # 14. the serve engine on olmoe-1b-7b, its memory on the same weights ----
    moe_counts = run_moe(torch, wl, args.seed)
    stamp("moe")

    # 15-16. pixtral-12b and whisper-base through prefill and decode ---------
    vlm_counts = run_family(torch, "vlm", "pixtral_12b", VLM_PROMPT,
                            args.seed)
    stamp("vlm")
    whisper_counts = run_family(torch, "whisper", "whisper_base",
                                WHISPER_PROMPT, args.seed)
    stamp("whisper")

    # 17. the three families on the card and on the CPU ----------------------
    run_family_parity(torch, args.seed)
    stamp("family_parity")

    # 18-21. training: phi3-mini, zamba2-7b and rwkv6-1.6b on the card, then
    # card against CPU ----------------------------------------------------
    train_counts = {}
    for phase in TRAIN_RUNS:
        train_counts[phase] = run_train(torch, wl, args.seed, phase)
        stamp(phase)
    train_parity_counts = run_train_parity(torch, args.seed)
    stamp("train_parity")

    # 22. tensor- and expert-parallel training with ZeRO-1 on a (2, 2) mesh --
    sharded_train_counts = run_sharded_train(torch, wl, args.seed)
    stamp("sharded_train")

    # 23. prefill and decode on a model mesh -------------------------------
    sharded_serve_counts = run_sharded_serve(torch, args.seed)
    stamp("sharded_serve")

    # 24. the ssm and hybrid families on a model mesh -----------------------
    sharded_ssm_counts = run_sharded_ssm(torch, args.seed)
    stamp("sharded_ssm")

    # 25. the encdec family on a model mesh, compression, checkpoints -------
    sharded_whisper_counts = run_sharded_whisper(torch, args.seed)
    stamp("sharded_whisper")

    # 26. the dry run on fake tensors, and against the card -----------------
    dryrun_results = run_dryrun(torch, dryrun_procs, dryrun_tmp)
    stamp("dryrun")

    # 27. kernels -----------------------------------------------------------
    summary = []
    for k in REPLACES:
        r = results[k]
        by_path = {"slice": counts[k][0],
                   "sharded": sharded_counts[k][0],
                   "ablations": ablation_counts[k][0],
                   "serve": serve_counts[k][0],
                   **{phase: c[k][0] for phase, c in ssm_counts.items()},
                   "durable": durable_counts[k][0],
                   "maintenance_lane": lane_counts[k][0],
                   "baselines": baseline_counts[k][0],
                   "residency": residency_counts[k][0],
                   "moe": moe_counts[k][0], "vlm": vlm_counts[k][0],
                   "whisper": whisper_counts[k][0],
                   **{phase: c[k][0] for phase, c in train_counts.items()},
                   "train_parity": train_parity_counts[k][0],
                   "sharded_train": sharded_train_counts[k][0],
                   "sharded_serve": sharded_serve_counts[k][0],
                   "sharded_ssm": sharded_ssm_counts[k][0],
                   "sharded_whisper": sharded_whisper_counts[k][0]}
        fake_calls = {cell: res["kernels"][k]["calls_per_position"]
                      for cell, res in dryrun_results.items()
                      if k in res["kernels"]}
        print(f"kernels: {k} launches={sum(by_path.values())} ("
              + ", ".join(f"{p} {n}" for p, n in by_path.items())
              + f") check=ok main_shape={r['shape']} dryrun_fake_calls "
              f"a position a step {fake_calls or 'none'}")
        summary.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "peak": r["peak"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "other_main_rows": r["other_main_rows"],
            # calls a position a step in phase 26 (a)'s fake runs: no launch
            "dryrun_fake_calls": fake_calls,
        })
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
