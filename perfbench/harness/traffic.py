"""The one traffic generator: reads a traffic mix (a JSON file under
``perfbench/traffic/``) and makes, from ``--seed``, the host mutations due
at the start of each request of a cell.

A request is one call of ``ticks_per_request`` ticks; the mutations due at
the ticks it covers are applied at its start. A mix's parameters:

* ``ticks_per_request`` (1 or more), ``ticks_per_second`` (5: a gossip
  period of 200 ms);
* ``warm_ticks`` — ticks of the mix run through the window's own call
  before the window opens (set-up): they warm up every shape and bring the
  cluster to the state the window measures;
* ``initial_down`` — the share of the capacity down at the start (the top
  rows, free for joins);
* ``sources`` — the mutation sources, in the order their mutations apply
  at a tick: each names its ``kind`` (the module
  ``perfbench/sources/<kind>.py``) and that kind's parameters.

Every seed gets the same amount of work: the counts come from the file, the
seed picks only which rows.
"""

from __future__ import annotations

import importlib

import numpy as np


class Cluster:
    """What the sources share: which rows are up, the free rows in the order
    they join, the seed rows, the user-rumor slots and the seed's draws."""

    def __init__(self, capacity: int, n_up: int, seed_rows, rumor_slots: int, seed: int):
        self.n = capacity
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.up = np.arange(capacity) < n_up
        self.free = np.arange(n_up, capacity)
        self.seed_mask = np.zeros(capacity, bool)
        self.seed_mask[list(seed_rows)] = True
        self.rumor_slots = rumor_slots
        self._slot = 0

    def pick_up(self, count: int) -> np.ndarray:
        """``count`` distinct up rows other than the seeds, drawn from the
        seed (int64, in draw order)."""
        cand = np.flatnonzero(self.up & ~self.seed_mask)
        return self.rng.choice(cand, size=count, replace=False).astype(np.int64)

    def origin(self) -> int:
        """An up row drawn from the seed (a rumor's origin)."""
        rows = np.flatnonzero(self.up)
        return int(rows[self.rng.integers(rows.shape[0])])

    def next_slot(self) -> int:
        """The user-rumor slot started longest ago."""
        slot = self._slot
        self._slot = (slot + 1) % self.rumor_slots
        return slot


class Schedule:
    """The mutations of a cell's requests, in request order: ``actions(i)``
    lists the actions of request ``i`` (tuples whose first item names the
    action, as the engines' ``apply`` reads them), in the order they
    apply."""

    def __init__(self, traffic: dict, capacity: int, seed_rows, rumor_slots: int, seed: int):
        self.tpr = int(traffic["ticks_per_request"])
        self.tps = int(traffic.get("ticks_per_second", 5))
        self.n_up = capacity - int(round(capacity * float(traffic.get("initial_down", 0.0))))
        self.cluster = Cluster(capacity, self.n_up, seed_rows, rumor_slots, seed)
        self.sources = [importlib.import_module(f"perfbench.sources.{s['kind']}").Source(s, self.cluster, self.tps)
                        for s in traffic.get("sources", [])]
        self.done: list = []

    def _request(self, i: int) -> list:
        acts = []
        for t in range(i * self.tpr, (i + 1) * self.tpr):
            for src in self.sources:
                acts += src.at(t)
        return acts

    def actions(self, i: int) -> list:
        while len(self.done) <= i:
            self.done.append(self._request(len(self.done)))
        return self.done[i]


def warm_requests(traffic: dict) -> int:
    """Requests before the window: ``warm_ticks`` rounded up to whole
    requests, at least one."""
    tpr = int(traffic["ticks_per_request"])
    return max(1, -(-int(traffic.get("warm_ticks", 0)) // tpr))
