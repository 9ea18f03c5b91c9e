"""The one traffic generator: the same seed gives the same schedule, other
seeds other rows, every seed the same amount of work."""

import numpy as np
import pytest

from benchhelp import config, spec, traffic
from perfbench.harness.traffic import Schedule

CELLS = spec()["workloads"] + [
    {"name": "sparse-100k.steady", "config": "sparse-100k", "traffic": "steady"},
    {"name": "pview-1m.quiet", "config": "pview-1m", "traffic": "quiet"},
]


def schedule(cell, seed, capacity=None):
    cfg = config(cell["config"])
    n = capacity or cfg["capacity"]
    return Schedule(traffic(cell["traffic"]), n, cfg["seed_rows"], cfg["rumor_slots"], seed)


def flat(sched, requests):
    out = []
    for i in range(requests):
        for act in sched.actions(i):
            out.append((act[0], tuple(np.asarray(act[1]).tolist()) if act[0] != "rumor" else act[1:]))
    return out


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_same_seed_same_schedule(cell):
    big = 2**31 + 12345
    assert flat(schedule(cell, big), 120) == flat(schedule(cell, big), 120)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_other_seeds_other_rows_same_work(cell):
    a, b = flat(schedule(cell, 7), 120), flat(schedule(cell, 8), 120)
    assert [(k, len(v) if k != "rumor" else 1) for k, v in a] == [(k, len(v) if k != "rumor" else 1) for k, v in b]
    if a:
        assert a != b


def test_churn_keeps_the_up_count_and_spares_the_seeds():
    cell = next(c for c in CELLS if c["traffic"] == "churn")
    cfg = config(cell["config"])
    n = 20_000
    sched = schedule(cell, 3, capacity=n)
    up = np.arange(n) < sched.n_up
    churn = round(n * next(x for x in traffic("churn")["sources"] if x["kind"] == "churn")["per_second"])
    for i in range(60):
        for kind, rows in sched.actions(i):
            assert len(rows) == churn and len(set(rows.tolist())) == churn
            if kind == "crash":
                assert up[rows].all() and not set(rows.tolist()) & set(cfg["seed_rows"])
                up[rows] = False
            else:
                assert not up[rows].any()
                up[rows] = True
        assert up.sum() == sched.n_up
    assert sum(1 for i in range(60) if sched.actions(i)) == 12


def test_rumors_refresh_the_oldest_slot():
    cell = next(c for c in CELLS if c["traffic"] == "rumors")
    sched = schedule(cell, 11, capacity=4096)
    first = sched.actions(0)
    assert [a[0] for a in first] == ["crash"] + ["rumor"] * 8
    assert len(first[0][1]) == 4
    slots = [a[1] for i in range(1, 200) for a in sched.actions(i)]
    assert slots == [s % 8 for s in range(len(slots))] and len(slots) == 199 // 16
    crashed = set(first[0][1].tolist())
    assert all(a[2] not in crashed for i in range(200) for a in sched.actions(i) if a[0] == "rumor")


def test_unknown_source_kind_is_refused():
    with pytest.raises(ModuleNotFoundError):
        Schedule({"ticks_per_request": 1, "sources": [{"kind": "no_such_kind"}]}, 64, [0], 2, 1)
