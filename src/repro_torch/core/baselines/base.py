"""Shared backend interface + cost accounting for baseline memory systems.

Counterpart of the JAX package's ``core/baselines/base.py``. Each baseline
reproduces the WRITE CRITICAL PATH CLASS of its reference system (paper
Table 1 / Appendix B). "LLM work" is an encoder forward with the same
dependency structure as the original: calls on a dependency chain use
``sequential=True`` (one forward per call — serialization is real
wall-clock here), independent calls are batched.

Each backend runs on one device, given as ``device`` (None: the CUDA card);
its encoder must run there too. The fact stores' top-k is the hand-written
``topk_sim`` kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import time
from typing import List, Set, Tuple

import numpy as np
import torch

from repro_torch.core.types import CanonicalFact, Query, QueryResult, Session, WriteStats
from repro_torch.data import templates as T
from repro_torch.device import check_encoder_device, resolve_device
from repro_torch.kernels import ops


class MemoryBackend:
    name = "base"

    def __init__(self, encoder, *, device=None):
        self.device = resolve_device(device)
        check_encoder_device(encoder, self.device, type(self).__name__)
        self.encoder = encoder
        self.write_stats = WriteStats()

    def ingest_session(self, session: Session) -> WriteStats:
        raise NotImplementedError

    def query(self, q: Query, final_topk: int = 10) -> QueryResult:
        raise NotImplementedError

    def _begin(self):
        return time.perf_counter(), self.encoder.stats.tokens, self.encoder.stats.calls

    def _end(self, t0, tok0, call0, depth: int, facts: int) -> WriteStats:
        s = WriteStats(
            wall_s=time.perf_counter() - t0,
            encoder_tokens=self.encoder.stats.tokens - tok0,
            encoder_calls=self.encoder.stats.calls - call0,
            llm_dependency_depth=depth,
            facts_written=facts,
        )
        self.write_stats.add(s)
        return s


class FactStore:
    """Flat embedding-indexed fact store shared by several baselines.

    The host state is the JAX package's: ``facts``, ``alive`` and ``emb``, a
    capacity-padded matrix grown by max(64, N) rows, so the kernel sees
    O(log N) key counts. The device keeps a copy of ``emb`` whose rows are
    normalized with the formula ``topk_sim`` applies, synced lazily before
    a top-k: the rows added or rewritten since the last one go up in one
    scatter, and capacity grows on the device (``ops.grow_rows``). Every
    write of a row goes through :meth:`add` or :meth:`set_emb`, which mark
    it for that sync."""

    def __init__(self, dim: int, device):
        self.dim = dim
        self.device = torch.device(device)
        self.facts: List[CanonicalFact] = []
        self.emb = np.zeros((0, dim), np.float32)
        self.alive: List[bool] = []
        self._dev = None              # (capacity, dim) normalized rows
        self._dirty: Set[int] = set()
        self.uploads = 0              # syncs that moved rows to the device
        self.grows = 0                # device-side capacity grows

    def add(self, fact: CanonicalFact, emb: np.ndarray) -> int:
        fact.fact_id = len(self.facts)
        self.facts.append(fact)
        self.alive.append(True)
        if fact.fact_id >= self.emb.shape[0]:
            grow = max(64, self.emb.shape[0])
            self.emb = np.concatenate([self.emb, np.zeros((grow, self.dim), np.float32)])
        self.set_emb(fact.fact_id, emb)
        fact.emb = emb
        return fact.fact_id

    def set_emb(self, fact_id: int, emb: np.ndarray) -> None:
        """Write row ``fact_id`` (an in-place rewrite, or an add's row) and
        mark it for the next sync: without the mark the card would go on
        scoring the old row."""
        self.emb[fact_id] = emb
        self._dirty.add(fact_id)

    def device_index(self) -> torch.Tensor:
        """The device copy, brought up to date with ``emb``."""
        cap = self.emb.shape[0]
        if self._dev is None:
            self._dev = torch.zeros((cap, self.dim), dtype=torch.float32,
                                    device=self.device)
        elif self._dev.shape[0] < cap:
            self.grows += 1
            self._dev = ops.grow_rows(self._dev, cap - self._dev.shape[0])
        if self._dirty:
            rows = sorted(self._dirty)
            self._dirty.clear()
            self.uploads += 1
            ops.scatter_rows(
                self._dev, torch.tensor(rows, device=self.device),
                ops.normalize_rows(
                    torch.from_numpy(self.emb[rows]).to(self.device)))
        return self._dev

    def topk(self, q_emb: np.ndarray, k: int) -> List[CanonicalFact]:
        n = len(self.facts)
        if n == 0 or k <= 0:
            # the JAX kernel returns nothing for k = 0; the CUDA kernel's
            # wrapper refuses k < 1, so no launch
            return []
        keys = self.device_index()
        q = ops.normalize_rows(torch.from_numpy(
            np.asarray(q_emb, np.float32)[None]).to(self.device))
        # capacity-padded matrix + runtime valid count
        _vals, idx = ops.topk_sim(q, keys, min(k, n), normalize=False,
                                  num_valid=n)
        out = []
        for i in idx[0].tolist():
            if i >= 0 and self.alive[i]:
                out.append(self.facts[i])
        return out

    @property
    def size(self) -> int:
        return sum(self.alive)


def turns_to_candidates(session: Session) -> List[Tuple[int, str, float, List]]:
    """(turn_idx, text, ts, parsed candidates) for user turns."""
    out = []
    for i, t in enumerate(session.turns):
        if t.role != "user":
            continue
        cands = T.parse_statement(t.text, (session.session_id, i))
        out.append((i, t.text, t.ts, cands))
    return out
