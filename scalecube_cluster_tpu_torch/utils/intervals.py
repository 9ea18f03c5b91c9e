"""Closed-interval set for gossip sequence-id dedup.

Parity with reference ``SequenceIdCollector``
(``cluster/gossip/SequenceIdCollector.java:15-74``): an ordered set of closed
``[lo, hi]`` intervals; ``add`` returns False if the id was already present
and merges adjacent intervals; the interval count is the gossip-segmentation
signal (``GossipProtocolImpl.checkGossipSegmentation``, threshold
``GossipConfig.java:12``).

The vectorized kernel uses a dense received-seq bitmap instead; this class is
the scalar-engine implementation and the oracle for bitmap gap-count tests.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple


class SequenceIdCollector:
    """Ordered disjoint closed-interval set over non-negative ints."""

    def __init__(self) -> None:
        # Sorted, disjoint, non-adjacent list of [lo, hi] closed intervals.
        self._intervals: List[List[int]] = []

    def add(self, seq_id: int) -> bool:
        """Insert ``seq_id``; returns True if it was new, False if duplicate."""
        iv = self._intervals
        # Find first interval with lo > seq_id.
        idx = bisect.bisect_right(iv, [seq_id, float("inf")])
        # Check containment in the interval before the insertion point.
        if idx > 0 and iv[idx - 1][1] >= seq_id:
            return False
        # Try to extend the previous interval (seq_id == prev.hi + 1).
        extend_prev = idx > 0 and iv[idx - 1][1] + 1 == seq_id
        # Try to extend the next interval (seq_id == next.lo - 1).
        extend_next = idx < len(iv) and iv[idx][0] - 1 == seq_id
        if extend_prev and extend_next:
            iv[idx - 1][1] = iv[idx][1]
            del iv[idx]
        elif extend_prev:
            iv[idx - 1][1] = seq_id
        elif extend_next:
            iv[idx][0] = seq_id
        else:
            iv.insert(idx, [seq_id, seq_id])
        return True

    def __contains__(self, seq_id: int) -> bool:
        iv = self._intervals
        idx = bisect.bisect_right(iv, [seq_id, float("inf")])
        return idx > 0 and iv[idx - 1][1] >= seq_id

    def size(self) -> int:
        """Number of disjoint intervals (the segmentation metric)."""
        return len(self._intervals)

    def clear(self) -> None:
        self._intervals.clear()

    def intervals(self) -> List[Tuple[int, int]]:
        return [(lo, hi) for lo, hi in self._intervals]

    def __repr__(self) -> str:
        return f"SequenceIdCollector({self._intervals})"
