"""Core data model: sessions, dialogue cells, canonical facts, scopes.

The *canonical fact* is the paper's stable write unit (§3.1): one temporally
anchored piece of memory with retrieval-ready text, source references,
entity mention, topical signal, and a temporal anchor inherited from the
source session.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Turn:
    role: str                 # "user" | "assistant"
    text: str
    ts: float                 # unix-style timestamp
    turn_id: int = 0


@dataclass
class Session:
    session_id: str
    turns: List[Turn]
    ts: float = 0.0

    def __post_init__(self):
        if not self.ts and self.turns:
            self.ts = self.turns[0].ts


@dataclass
class DialogueCell:
    """A chunk of raw dialogue — session-tree leaf payload (high-fidelity
    fallback channel)."""
    cell_id: int
    session_id: str
    chunk_idx: int
    text: str
    ts: float
    emb: Optional[np.ndarray] = None


@dataclass
class CanonicalFact:
    fact_id: int
    text: str                 # retrieval-ready statement
    subject: str              # normalized entity label
    attribute: str            # topical signal
    value: str
    ts: float                 # temporal anchor
    prev_value: Optional[str] = None     # transition evidence ("moved FROM x")
    sources: List[Tuple[str, int]] = field(default_factory=list)  # (session, chunk)
    emb: Optional[np.ndarray] = None

    def key(self) -> Tuple[str, str, str]:
        return (self.subject, self.attribute, self.value)


@dataclass
class RawCandidate:
    """Pre-canonicalization extraction output (may be fragmented/duplicated)."""
    text: str
    subject: str
    attribute: str
    value: str
    ts: float
    prev_value: Optional[str]
    source: Tuple[str, int]


@dataclass
class Query:
    text: str
    qtype: str                # current | historical | transition_time | multi_session | single_session
    subject: str
    attribute: str
    anchor_value: Optional[str] = None   # for "before moving to X"
    gold: str = ""
    session_scope: Optional[str] = None


@dataclass
class QueryResult:
    answer: str
    evidence: List[str]
    retrieval_s: float = 0.0
    answer_s: float = 0.0
    encoder_calls: int = 0


@dataclass
class WriteStats:
    wall_s: float = 0.0
    encoder_tokens: int = 0
    encoder_calls: int = 0        # number of model invocations (batched = 1)
    llm_dependency_depth: int = 0  # longest dependent chain of model calls
    summary_refreshes: int = 0     # distinct node refreshes
    facts_written: int = 0

    def add(self, other: "WriteStats") -> None:
        self.wall_s += other.wall_s
        self.encoder_tokens += other.encoder_tokens
        self.encoder_calls += other.encoder_calls
        self.llm_dependency_depth = max(self.llm_dependency_depth, other.llm_dependency_depth)
        self.summary_refreshes += other.summary_refreshes
        self.facts_written += other.facts_written
