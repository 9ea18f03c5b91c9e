"""Constants the partial-view and sparse engines share with the dense
engine's state module, the host-side delay conversion, and the namespace
tables."""

from __future__ import annotations

import numpy as np

ALIVE0_KEY = 0  # precedence key of ALIVE, incarnation 0, epoch 0
NEVER = -(1 << 30)  # "changed long ago" sentinel for *_since / *_at leaves
NO_CANDIDATE_I32 = int(np.iinfo(np.int32).min)  # scatter-max identity


def delay_mean_to_q(mean_delay_ticks: float) -> float:
    """Exponential mean delay (in ticks) -> geometric parameter q (f32),
    computed on the host."""
    if mean_delay_ticks <= 0:
        return 0.0
    return float(np.float32(np.exp(np.float32(-1.0 / mean_delay_ticks))))


def build_namespace_tables(namespaces):
    """Per-row namespace strings -> (ns_id [N] int32, ns_rel [G, G] bool),
    numpy, by the reference's prefix-hierarchy relatedness."""
    from ..utils.namespaces import are_namespaces_related

    uniq = sorted(set(namespaces))
    gid = {ns: g for g, ns in enumerate(uniq)}
    ids = np.asarray([gid[ns] for ns in namespaces], np.int32)
    g = len(uniq)
    rel = np.zeros((g, g), bool)
    for a in uniq:
        for b in uniq:
            rel[gid[a], gid[b]] = are_namespaces_related(a, b)
    return ids, rel
