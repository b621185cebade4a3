"""Shared statement grammar for the synthetic temporal workload.

The generator renders state transitions into natural-ish sentences; the
extractor parses the same grammar (the stand-in for LLM language competence —
see the extraction module). Timestamps are "months since Jan 2020" floats; dates
render as "March 2023" style strings.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import RawCandidate

MONTHS = [
    "January", "February", "March", "April", "May", "June",
    "July", "August", "September", "October", "November", "December",
]


def ts_to_date(ts: float) -> str:
    m = int(ts)
    return f"{MONTHS[m % 12]} {2020 + m // 12}"


def date_to_ts(month: str, year: str) -> float:
    return float((int(year) - 2020) * 12 + MONTHS.index(month))


# attribute grammar: transition + state templates and their parse regexes
ATTRS: Dict[str, Dict[str, str]] = {
    "residence": {
        "transition": "{subj} moved from {old} to {new} in {date}.",
        "state": "{subj} lives in {val} as of {date}.",
        "q_current": "Where does {subj} live now?",
        "q_before": "Where did {subj} live before moving to {anchor}?",
        "q_when": "When did {subj} move to {anchor}?",
        "q_first": "What was the first place {subj} lived in?",
    },
    "job": {
        "transition": "{subj} changed jobs from {old} to {new} in {date}.",
        "state": "{subj} works as a {val} as of {date}.",
        "q_current": "What does {subj} work as now?",
        "q_before": "What job did {subj} have before becoming {anchor}?",
        "q_when": "When did {subj} become {anchor}?",
        "q_first": "What was the first job {subj} had?",
    },
    "project": {
        "transition": "{subj} switched project {old} to project {new} in {date}.",
        "state": "{subj} is working on project {val} as of {date}.",
        "q_current": "Which project is {subj} working on now?",
        "q_before": "Which project did {subj} work on before project {anchor}?",
        "q_when": "When did {subj} switch to project {anchor}?",
        "q_first": "What was the first project {subj} worked on?",
    },
    "preference": {
        "transition": "{subj} now prefers {new} over {old} since {date}.",
        "state": "{subj}'s favorite thing is {val} as of {date}.",
        "q_current": "What does {subj} prefer now?",
        "q_before": "What did {subj} prefer before {anchor}?",
        "q_when": "When did {subj} start preferring {anchor}?",
        "q_first": "What did {subj} prefer first?",
    },
}

_DATE = r"(January|February|March|April|May|June|July|August|September|October|November|December) (\d{4})"

_PARSERS: List[Tuple[str, re.Pattern]] = []
for attr, g in ATTRS.items():
    _PARSERS.append((
        attr,
        re.compile({
            "residence": rf"(?P<subj>[A-Z][a-z]+) moved from (?P<old>[A-Z][A-Za-z ]+?) to (?P<new>[A-Z][A-Za-z ]+?) in {_DATE}\.",
            "job": rf"(?P<subj>[A-Z][a-z]+) changed jobs from (?P<old>[a-z ]+?) to (?P<new>[a-z ]+?) in {_DATE}\.",
            "project": rf"(?P<subj>[A-Z][a-z]+) switched project (?P<old>[A-Za-z]+?) to project (?P<new>[A-Za-z]+?) in {_DATE}\.",
            "preference": rf"(?P<subj>[A-Z][a-z]+) now prefers (?P<new>[a-z ]+?) over (?P<old>[a-z ]+?) since {_DATE}\.",
        }[attr]),
    ))
    _PARSERS.append((
        attr + "::state",
        re.compile({
            "residence": rf"(?P<subj>[A-Z][a-z]+) lives in (?P<val>[A-Z][A-Za-z ]+?) as of {_DATE}\.",
            "job": rf"(?P<subj>[A-Z][a-z]+) works as a (?P<val>[a-z ]+?) as of {_DATE}\.",
            "project": rf"(?P<subj>[A-Z][a-z]+) is working on project (?P<val>[A-Za-z]+?) as of {_DATE}\.",
            "preference": rf"(?P<subj>[A-Z][a-z]+)'s favorite thing is (?P<val>[a-z ]+?) as of {_DATE}\.",
        }[attr]),
    ))


def render_transition(attr: str, subj: str, old: str, new: str, ts: float) -> str:
    return ATTRS[attr]["transition"].format(subj=subj, old=old, new=new, date=ts_to_date(ts))


def render_state(attr: str, subj: str, val: str, ts: float) -> str:
    return ATTRS[attr]["state"].format(subj=subj, val=val, date=ts_to_date(ts))


def parse_statement(text: str, source: Tuple[str, int]) -> List[RawCandidate]:
    """Extract raw fact candidates from one sentence (LLM stand-in)."""
    out: List[RawCandidate] = []
    for name, pat in _PARSERS:
        for m in pat.finditer(text):
            g = m.groupdict()
            date_groups = m.groups()[-2:]
            ts = date_to_ts(date_groups[0], date_groups[1])
            attr = name.split("::")[0]
            if "val" in g and g.get("val"):
                out.append(RawCandidate(
                    text=m.group(0), subject=g["subj"], attribute=attr,
                    value=g["val"].strip(), ts=ts, prev_value=None, source=source,
                ))
            else:
                out.append(RawCandidate(
                    text=m.group(0), subject=g["subj"], attribute=attr,
                    value=g["new"].strip(), ts=ts,
                    prev_value=g["old"].strip(), source=source,
                ))
    return out


# attribute keyword families (what an LLM knows about paraphrase): used by
# the guided-browse intent layer to recognize which attribute a query or an
# interval summary is about.
ATTR_KEYWORDS = {
    "residence": {"live", "lives", "lived", "moved", "place", "city", "residence"},
    "job": {"work", "works", "working", "job", "jobs", "became", "become", "career"},
    "project": {"project", "projects", "switched"},
    "preference": {"prefer", "prefers", "preferred", "favorite", "preferring"},
}


def infer_attribute(text: str) -> str:
    low = set(re.findall(r"[a-z]+", text.lower()))
    best, score = "", 0
    for attr, kws in ATTR_KEYWORDS.items():
        s = len(low & kws)
        if s > score:
            best, score = attr, s
    return best


CHITCHAT = [
    "The weather has been quite nice lately.",
    "Did you watch the game last weekend?",
    "I should really get more sleep these days.",
    "Traffic was terrible this morning.",
    "That restaurant downtown finally reopened.",
    "My phone battery keeps dying too fast.",
    "The new season of that show just dropped.",
    "I keep forgetting to water the plants.",
    "Someone recommended a great podcast to me.",
    "The coffee machine at work broke again.",
]

ASSISTANT_ACKS = [
    "That's great to hear, thanks for sharing.",
    "Noted — I'll remember that.",
    "Interesting, tell me more sometime.",
    "Got it, thanks for the update.",
    "Understood, I've made a note of that.",
]
