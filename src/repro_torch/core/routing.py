"""Write path stage 3: scope routing (paper §4.2, Eq. 6).

Routing needs NO LLM calls after extraction: session scope comes from the
source session, entity scope from the normalized subject label, scene scope
from nearest-centroid online clustering over topical embeddings (lightweight
cluster state: centroid + member counts, kept in the Forest).

Entity and scene trees take canonical facts as leaves; session trees take
dialogue cells (high-fidelity fallback channel).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.forest import Forest
from repro_torch.core.types import CanonicalFact, DialogueCell


def route_fact(fact: CanonicalFact, forest: Forest) -> List[Tuple[str, str]]:
    """Returns [(scope_key, kind)] for a canonical fact."""
    scopes = [(f"entity:{fact.subject.lower()}", "entity")]
    scene_id = forest.route_scene(fact.emb)
    scopes.append((f"scene:{scene_id}", "scene"))
    return scopes


def materialize_fact(fact: CanonicalFact, forest: Forest) -> List[Tuple[str, int]]:
    leaves = []
    for scope_key, kind in route_fact(fact, forest):
        leaf = forest.insert_item(
            scope_key, kind, "fact", fact.fact_id, fact.ts, fact.emb, fact.text
        )
        leaves.append((scope_key, leaf))
    return leaves


def materialize_cell(cell: DialogueCell, forest: Forest) -> Tuple[str, int]:
    scope_key = f"session:{cell.session_id}"
    leaf = forest.insert_item(
        scope_key, "session", "cell", cell.cell_id, cell.ts, cell.emb,
        cell.text[:200],
    )
    return scope_key, leaf
