"""Deterministic, shardable, checkpointable LM data pipeline.

A numpy copy of the JAX package's ``data/pipeline.py``, on the port's own
tokenizer: ``batch_at(step)`` generates the batch for any step directly from
(seed, step, dp_rank), so a checkpoint needs only the step counter and a
restart sees exactly the batches an uninterrupted run sees. Text corpora (the
synthetic session workload) are packed into fixed-length token sequences.
The batches are numpy arrays, equal to the reference's for the same
arguments; the caller moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer


class TokenPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 0,
                 corpus: Optional[List[str]] = None):
        assert global_batch % dp_size == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // dp_size
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.seed = seed
        self._tokens: Optional[np.ndarray] = None
        if corpus:
            tok = HashTokenizer(vocab_size)
            ids: List[int] = []
            for doc in corpus:
                ids.extend(tok.encode(doc, add_bos=True))
                ids.append(tok.eos_id)
            self._tokens = np.asarray(ids, np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for `step` on this dp shard: ``tokens`` and
        ``labels`` (B, S) int32, the labels shifted by one."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.dp_rank
        )
        B, S = self.local_batch, self.seq_len
        if self._tokens is not None and len(self._tokens) > S + 1:
            starts = rng.integers(0, len(self._tokens) - S - 1, size=B)
            tok = np.stack([self._tokens[s:s + S + 1] for s in starts])
        else:
            tok = rng.integers(3, self.vocab_size, size=(B, S + 1), dtype=np.int64)
        return {
            "tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
