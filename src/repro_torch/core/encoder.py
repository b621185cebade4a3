"""Embedding encoder for the memory substrate.

HashingEncoder: deterministic token/bigram hashing into a fixed random
projection, the JAX package's default encoder. The table is built from
``np.random.default_rng(seed)`` exactly as the JAX package builds it, so the
same seed gives the same table bytes in both packages. The projection runs on
the encoder's device; the result returns to the host as numpy, which is where
the write and read paths consume it.

It counts calls and tokens, so the write path can report its cost.
"""
from __future__ import annotations

import re
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def _stable_hash(s: str) -> int:
    """Process-stable string hash (python's hash() is salted per process)."""
    return zlib.crc32(s.encode())

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_HASH_BUCKETS = 8192
# high-frequency glue words contribute almost nothing to a trained embedding
# model's similarity; the hashing stand-in drops them outright.
_STOP = frozenset(
    "a an the of in on at to as is was are were did does do now then it this "
    "that i you he she we they my your his her what where when which who".split()
)


# vocabulary-level id caches (what a trained tokenizer's vocab table is):
# unigram/bigram hashing is pure, and natural-language token vocabularies
# are small, so memoizing ids takes the per-token crc32+encode off the
# write path's host floor. Size-capped: arbitrary alphanumeric tokens (ids,
# hashes) would otherwise grow the dicts without bound in a long-lived
# serving process — on overflow we just stop inserting (misses stay cheap).
_VOCAB_CACHE_MAX = 1 << 16
_UNI_IDS: dict = {}
_BI_IDS: dict = {}


def _tokenize(text: str) -> List[int]:
    toks = [t for t in _TOKEN_RE.findall(text.lower()) if t not in _STOP]
    ids: List[int] = []
    append = ids.append
    prev = None
    for t in toks:
        if prev is not None:
            b = _BI_IDS.get((prev, t))
            if b is None:
                b = _stable_hash(prev + "_" + t) % _HASH_BUCKETS
                if len(_BI_IDS) < _VOCAB_CACHE_MAX:
                    _BI_IDS[(prev, t)] = b
            append(b)
        u = _UNI_IDS.get(t)
        if u is None:
            u = _stable_hash(t) % _HASH_BUCKETS
            if len(_UNI_IDS) < _VOCAB_CACHE_MAX:
                _UNI_IDS[t] = u
        append(u)
        prev = t
    return ids or [0]


def project(flat_ids: torch.Tensor, lengths: torch.Tensor,
            table: torch.Tensor) -> torch.Tensor:
    """flat_ids: (T,) bucket ids of all texts back to back, lengths: (B,)
    tokens per text (each >= 1) -> (B, dim) float32.

    Computes ``tanh(counts @ table)`` in gather + segment-sum form, then
    ``h / (||h|| + 1e-6)``. ``segment_reduce`` sums each text's rows in one
    fixed order on either device (no atomics), so an encode is bitwise
    repeatable on the card."""
    contrib = torch.segment_reduce(table[flat_ids], "sum", lengths=lengths,
                                   axis=0, unsafe=True)
    h = torch.tanh(contrib)
    n = torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-6
    return h / n


class EncoderStats:
    def __init__(self):
        self.calls = 0          # model invocations (a batch = 1 call)
        self.sequential_calls = 0  # calls that were on a dependency chain
        self.tokens = 0
        self.texts = 0

    def reset(self):
        self.__init__()


def hashing_table(dim: int, seed: int) -> np.ndarray:
    """The (buckets, dim) float32 projection table for ``seed``."""
    rng = np.random.default_rng(seed)
    return np.asarray(rng.normal(size=(_HASH_BUCKETS, dim)) / np.sqrt(dim),
                      np.float32)


class HashingEncoder:
    """Deterministic hashing encoder with LLM-like cost accounting.

    ``device=None`` means the CUDA card (see ``resolve_device``); ``table``
    replaces the seeded table (``convert.hashing_encoder_from_numpy``)."""

    def __init__(self, dim: int = 256, seed: int = 0, max_batch: int = 1024,
                 *, device=None, table: Optional[np.ndarray] = None):
        if table is None:
            table = hashing_table(dim, seed)
        if table.shape != (_HASH_BUCKETS, dim):
            raise ValueError(f"table must be ({_HASH_BUCKETS}, {dim}), got "
                             f"{table.shape}")
        self.dim = dim
        self.device = resolve_device(device)
        self._table = torch.tensor(np.asarray(table, np.float32),
                                   device=self.device)
        self.stats = EncoderStats()
        self.max_batch = max_batch

    def encode(self, texts: Sequence[str], *, sequential: bool = False) -> np.ndarray:
        """Batched encode. `sequential=True` marks calls that sit on a write
        dependency chain (baselines' state-dependent updates) — they are
        executed one-by-one to reproduce the serialization honestly."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        if sequential:
            outs = [self._encode_batch([t]) for t in texts]
            self.stats.sequential_calls += len(texts)
            return np.concatenate(outs, axis=0)
        outs = []
        for i in range(0, len(texts), self.max_batch):
            outs.append(self._encode_batch(texts[i:i + self.max_batch]))
        return np.concatenate(outs, axis=0)

    def _encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        id_lists = [_tokenize(t) for t in texts]
        lengths = np.fromiter((len(ids) for ids in id_lists), np.int64,
                              len(id_lists))
        flat = np.fromiter((i for ids in id_lists for i in ids), np.int64,
                           int(lengths.sum()))
        self.stats.calls += 1
        self.stats.tokens += int(lengths.sum())
        self.stats.texts += len(texts)
        out = project(torch.from_numpy(flat).to(self.device),
                      torch.from_numpy(lengths).to(self.device), self._table)
        return out.cpu().numpy()

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]
