"""A crash wave: ``share`` of the capacity (up rows other than the seeds,
drawn from the seed) crashes at the first tick. Action ``("crash", rows)``,
the rows sorted."""

import numpy as np


class Source:
    def __init__(self, params: dict, cluster, ticks_per_second: int):
        self.c = cluster
        self.count = int(round(cluster.n * float(params["share"])))

    def at(self, t: int) -> list:
        if t or not self.count:
            return []
        rows = np.sort(self.c.pick_up(self.count))
        self.c.up[rows] = False
        return [("crash", rows)]
