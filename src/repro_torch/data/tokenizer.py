"""Deterministic hash tokenizer (no external vocab files)."""
from __future__ import annotations

import re
import zlib
from typing import List

_WORD_RE = re.compile(r"[a-zA-Z0-9]+|[^\sa-zA-Z0-9]")


class HashTokenizer:
    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size
        self.bos_id = 1
        self.eos_id = 2

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        toks = _WORD_RE.findall(text.lower())
        ids = [3 + (zlib.crc32(t.encode()) % (self.vocab_size - 3)) for t in toks]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:  # lossy (hash) — debugging only
        return " ".join(f"<{i}>" for i in ids)
