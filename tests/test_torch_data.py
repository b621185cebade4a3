"""The port's synthetic workload generator against the JAX package's: the
same seed gives the same sessions, turns, queries and gold answers."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.data.synthetic import make_workload as jax_make_workload
from repro_torch.data.synthetic import make_workload as torch_make_workload

SEEDS = [0, 11, 29]


def _as_dicts(items):
    return [dataclasses.asdict(x) for x in items]


@pytest.mark.parametrize("seed", SEEDS)
def test_sessions_and_turns_identical(seed):
    kw = dict(num_entities=6, num_sessions=14, transitions_per_entity=4,
              num_queries=30, seed=seed)
    a, b = jax_make_workload(**kw), torch_make_workload(**kw)
    assert _as_dicts(a.sessions) == _as_dicts(b.sessions)
    assert sum(len(s.turns) for s in b.sessions) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_queries_and_gold_identical(seed):
    kw = dict(num_entities=6, num_sessions=14, transitions_per_entity=4,
              num_queries=30, seed=seed)
    a, b = jax_make_workload(**kw), torch_make_workload(**kw)
    assert _as_dicts(a.queries) == _as_dicts(b.queries)
    assert [q.gold for q in a.queries] == [q.gold for q in b.queries]
    assert a.gold_ranges == b.gold_ranges
    assert _as_dicts(a.trajectories) == _as_dicts(b.trajectories)
