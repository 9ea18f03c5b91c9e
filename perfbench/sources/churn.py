"""Churn: once every simulated second, ``per_second`` of the capacity
crashes (up rows other than the seeds, drawn from the seed) and as many
free rows join; crashed rows are free again after the joins of their
second, in the order they crashed. Actions ``("crash", rows)`` and
``("join", rows)``."""

import numpy as np


class Source:
    def __init__(self, params: dict, cluster, ticks_per_second: int):
        self.c = cluster
        self.tps = ticks_per_second
        self.count = int(round(cluster.n * float(params["per_second"])))

    def at(self, t: int) -> list:
        if not self.count or t % self.tps:
            return []
        c = self.c
        crash = c.pick_up(self.count)
        join = c.free[: self.count].astype(np.int64)
        c.free = np.concatenate([c.free[self.count :], crash])
        c.up[crash] = False
        c.up[join] = True
        return [("crash", crash), ("join", join)]
