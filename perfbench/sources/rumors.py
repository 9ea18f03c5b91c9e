"""User rumors: ``initial`` rumors start at the first tick, one per slot
from slot 0; after that a fresh rumor every ``every`` ticks (0: none), each
into the slot started longest ago. Origins are up rows drawn from the seed.
Action ``("rumor", slot, origin)``."""


class Source:
    def __init__(self, params: dict, cluster, ticks_per_second: int):
        self.c = cluster
        self.initial = int(params.get("initial", 0))
        self.every = int(params.get("every", 0))
        if self.initial > cluster.rumor_slots:
            raise ValueError(f"{self.initial} initial rumors for {cluster.rumor_slots} slots")

    def _rumor(self) -> tuple:
        slot = self.c.next_slot()
        return ("rumor", slot, self.c.origin())

    def at(self, t: int) -> list:
        if t == 0:
            return [self._rumor() for _ in range(self.initial)]
        if self.every and t % self.every == 0:
            return [self._rumor()]
        return []
