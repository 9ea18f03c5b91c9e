"""Closed-form SWIM math: a copy of the JAX package's
``utils/cluster_math.py`` (it imports no JAX).

Function-for-function parity with reference ``ClusterMath``
(``cluster/ClusterMath.java:8-135``). These are pure scalar functions used as

* protocol knobs (gossip spread/sweep horizons, suspicion timeout),
* oracle for kernel tests, and
* expected-rounds curves for the benchmark harness.

All functions accept plain ints/floats and return plain values so they can be
used both host-side and (re-expressed in jnp where needed) inside the kernel.
"""

from __future__ import annotations

import math


def ceil_log2(num: int) -> int:
    """``ceil(log2(n + 1))`` via bit length — reference ClusterMath.java:133-135
    (``32 - numberOfLeadingZeros(num)``)."""
    if num < 0:
        raise ValueError("num must be >= 0")
    return int(num).bit_length()


def gossip_periods_to_spread(repeat_mult: int, cluster_size: int) -> int:
    """Rounds after which a rumor has most likely reached everyone
    (reference ClusterMath.java:111-113)."""
    return repeat_mult * ceil_log2(cluster_size)


def gossip_periods_to_sweep(repeat_mult: int, cluster_size: int) -> int:
    """Rounds after which a rumor is garbage-collected
    (reference ClusterMath.java:99-102)."""
    return 2 * (gossip_periods_to_spread(repeat_mult, cluster_size) + 1)


def gossip_dissemination_time(repeat_mult: int, cluster_size: int, gossip_interval: float) -> float:
    """Expected wall-clock dissemination time (reference ClusterMath.java:70-79)."""
    return gossip_periods_to_spread(repeat_mult, cluster_size) * gossip_interval


def gossip_timeout_to_sweep(repeat_mult: int, cluster_size: int, gossip_interval: float) -> float:
    """Wall-clock sweep timeout (reference ClusterMath.java:85-92)."""
    return gossip_periods_to_sweep(repeat_mult, cluster_size) * gossip_interval


def gossip_convergence_probability(
    fanout: int, repeat_mult: int, cluster_size: int, loss: float
) -> float:
    """P(everyone infected) under iid message loss
    (reference ClusterMath.java:38-44)."""
    fanout_with_loss = (1.0 - loss) * fanout
    spread_size = cluster_size - math.pow(cluster_size, -(fanout_with_loss * repeat_mult - 2))
    return spread_size / cluster_size


def gossip_convergence_percent(
    fanout: int, repeat_mult: int, cluster_size: int, loss_percent: float
) -> float:
    """Same as :func:`gossip_convergence_probability`, in percent
    (reference ClusterMath.java:22-27)."""
    return gossip_convergence_probability(fanout, repeat_mult, cluster_size, loss_percent / 100.0) * 100.0


def max_messages_per_gossip_per_node(fanout: int, repeat_mult: int, cluster_size: int) -> int:
    """Upper bound on per-node messages for one rumor
    (reference ClusterMath.java:54-67)."""
    return fanout * repeat_mult * ceil_log2(cluster_size)


def max_messages_per_gossip_total(fanout: int, repeat_mult: int, cluster_size: int) -> int:
    """Cluster-wide message bound for one rumor (reference ClusterMath.java:47-52)."""
    return cluster_size * max_messages_per_gossip_per_node(fanout, repeat_mult, cluster_size)


def suspicion_timeout(suspicion_mult: int, cluster_size: int, ping_interval: float) -> float:
    """Suspicion timeout before a SUSPECT member is declared DEAD
    (reference ClusterMath.java:123-125)."""
    return suspicion_mult * ceil_log2(cluster_size) * ping_interval
