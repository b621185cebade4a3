"""Synthetic temporal-memory workload generator.

Produces the LongMemEval-S-style evaluation instances this repo benchmarks
on: per-entity state *trajectories* (residence/job/project/preference
transitions over months), rendered into multi-session dialogues with
distractor chitchat, plus queries with exact gold answers across the
categories the paper analyzes:

  * current         — "Where does Bob live now?"            (knowledge-update)
  * historical      — "Where did Bob live before Miami?"    (temporal-reasoning)
  * transition_time — "When did Bob move to Miami?"         (temporal-reasoning)
  * multi_session   — "What was the first place Bob lived?" (multi-session)
  * single_session  — preference stated once among distractors

Everything is seeded and deterministic.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import Query, Session, Turn
from repro_torch.data import templates as T

NAMES = [
    "Bob", "Alice", "Carol", "David", "Erin", "Frank", "Grace", "Henry",
    "Irene", "Jack", "Karen", "Liam", "Mona", "Nina", "Oscar", "Paula",
]
CITIES = [
    "Boston", "Davis", "Miami", "Seattle", "Austin", "Denver", "Chicago",
    "Portland", "Atlanta", "Phoenix", "Madison", "Raleigh",
]
JOBS = [
    "teacher", "nurse", "barista", "carpenter", "designer", "writer",
    "chef", "gardener", "translator", "photographer",
]
PROJECTS = ["Apollo", "Borealis", "Cascade", "Dynamo", "Ember", "Falcon", "Gyro"]
PREFS = ["green tea", "black coffee", "jazz music", "rock climbing", "oil painting",
         "chess", "cycling", "pottery"]

VALUE_POOLS = {
    "residence": CITIES,
    "job": JOBS,
    "project": PROJECTS,
    "preference": PREFS,
}


@dataclass
class Trajectory:
    subject: str
    attribute: str
    events: List[Tuple[float, str]]  # (ts, value); first event = initial state

    def value_at(self, ts: float) -> Optional[str]:
        cur = None
        for t, v in self.events:
            if t <= ts:
                cur = v
        return cur


@dataclass
class Workload:
    sessions: List[Session]
    queries: List[Query]
    trajectories: List[Trajectory]
    gold_ranges: Dict[int, Tuple[str, str]] = field(default_factory=dict)
    # query idx -> (session_id containing the gold evidence, key span)


def make_workload(
    *,
    num_entities: int = 4,
    num_sessions: int = 12,
    transitions_per_entity: int = 3,
    distractor_turns: int = 6,
    num_queries: int = 40,
    seed: int = 0,
) -> Workload:
    rng = random.Random(seed)
    subjects = rng.sample(NAMES, num_entities)

    # --- build trajectories ------------------------------------------------
    trajectories: List[Trajectory] = []
    for subj in subjects:
        for attr, pool in VALUE_POOLS.items():
            if rng.random() < 0.35 and attr != "residence":
                continue  # not every entity has every attribute
            n_vals = min(1 + transitions_per_entity, len(pool))
            vals = rng.sample(pool, n_vals)
            t0 = rng.uniform(0, 12)
            gaps = [rng.uniform(3, 14) for _ in range(n_vals - 1)]
            events = [(t0, vals[0])]
            t = t0
            for v, g in zip(vals[1:], gaps):
                t += g
                events.append((t, v))
            trajectories.append(Trajectory(subj, attr, events))

    # --- schedule events into sessions --------------------------------------
    all_events: List[Tuple[float, Trajectory, int]] = []
    for tr in trajectories:
        for i, (ts, _) in enumerate(tr.events):
            all_events.append((ts, tr, i))
    all_events.sort(key=lambda x: x[0])

    t_min = all_events[0][0]
    t_max = all_events[-1][0] + 1
    bounds = [t_min + (t_max - t_min) * i / num_sessions for i in range(num_sessions + 1)]

    sessions: List[Session] = []
    event_session: Dict[Tuple[str, str, int], str] = {}
    for s in range(num_sessions):
        sid = f"s{s:03d}"
        lo, hi = bounds[s], bounds[s + 1]
        turns: List[Turn] = []
        ts_base = lo
        ev_here = [(ts, tr, i) for ts, tr, i in all_events if lo <= ts < hi]
        stmts: List[Tuple[float, str]] = []
        for ts, tr, i in ev_here:
            if i == 0:
                text = T.render_state(tr.attribute, tr.subject, tr.events[0][1], ts)
            else:
                text = T.render_transition(
                    tr.attribute, tr.subject, tr.events[i - 1][1], tr.events[i][1], ts
                )
            stmts.append((ts, text))
            event_session[(tr.subject, tr.attribute, i)] = sid
        # interleave with distractors
        n_turns = len(stmts) + distractor_turns
        stmt_iter = iter(sorted(stmts))
        positions = sorted(rng.sample(range(n_turns), len(stmts)))
        tid = 0
        for j in range(n_turns):
            if positions and j == positions[0]:
                positions.pop(0)
                ts, text = next(stmt_iter)
            else:
                ts, text = ts_base + j * 0.01, rng.choice(T.CHITCHAT)
            turns.append(Turn("user", text, ts, tid)); tid += 1
            turns.append(Turn("assistant", rng.choice(T.ASSISTANT_ACKS), ts + 0.001, tid)); tid += 1
        turns.sort(key=lambda t: t.ts)
        sessions.append(Session(sid, turns, ts=lo))

    # --- queries -------------------------------------------------------------
    queries: List[Query] = []
    gold_ranges: Dict[int, Tuple[str, str]] = {}
    multi = [tr for tr in trajectories if len(tr.events) >= 3]
    rng.shuffle(multi)
    qi = 0
    while len(queries) < num_queries and multi:
        tr = multi[qi % len(multi)]
        qi += 1
        g = T.ATTRS[tr.attribute]
        kind = ["current", "historical", "transition_time", "multi_session", "single_session"][
            len(queries) % 5
        ]
        last_ts, last_v = tr.events[-1]
        mid_idx = max(1, len(tr.events) - 1)
        if kind == "current":
            q = Query(g["q_current"].format(subj=tr.subject), "current",
                      tr.subject, tr.attribute, gold=last_v)
            gold_ranges[len(queries)] = (event_session[(tr.subject, tr.attribute, len(tr.events) - 1)], last_v)
        elif kind == "historical":
            anchor = tr.events[mid_idx][1]
            gold = tr.events[mid_idx - 1][1]
            q = Query(g["q_before"].format(subj=tr.subject, anchor=anchor), "historical",
                      tr.subject, tr.attribute, anchor_value=anchor, gold=gold)
            gold_ranges[len(queries)] = (event_session[(tr.subject, tr.attribute, mid_idx - 1)], gold)
        elif kind == "transition_time":
            anchor = tr.events[mid_idx][1]
            gold = T.ts_to_date(tr.events[mid_idx][0])
            q = Query(g["q_when"].format(subj=tr.subject, anchor=anchor), "transition_time",
                      tr.subject, tr.attribute, anchor_value=anchor, gold=gold)
            gold_ranges[len(queries)] = (event_session[(tr.subject, tr.attribute, mid_idx)], anchor)
        elif kind == "multi_session":
            gold = tr.events[0][1]
            q = Query(g["q_first"].format(subj=tr.subject), "multi_session",
                      tr.subject, tr.attribute, gold=gold)
            gold_ranges[len(queries)] = (event_session[(tr.subject, tr.attribute, 0)], gold)
        else:  # single_session: a preference-like lookup of the initial state
            gold = tr.events[0][1]
            q = Query(g["q_first"].format(subj=tr.subject), "single_session",
                      tr.subject, tr.attribute, gold=gold,
                      session_scope=event_session[(tr.subject, tr.attribute, 0)])
            gold_ranges[len(queries)] = (event_session[(tr.subject, tr.attribute, 0)], gold)
        queries.append(q)

    return Workload(sessions, queries, trajectories, gold_ranges)
