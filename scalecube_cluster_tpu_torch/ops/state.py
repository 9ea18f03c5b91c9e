"""Constants the partial-view engine shares with the dense engine's state
module, and the host-side delay conversion."""

from __future__ import annotations

import numpy as np

NEVER = -(1 << 30)  # "changed long ago" sentinel for *_since / *_at leaves
NO_CANDIDATE_I32 = int(np.iinfo(np.int32).min)  # scatter-max identity


def delay_mean_to_q(mean_delay_ticks: float) -> float:
    """Exponential mean delay (in ticks) -> geometric parameter q (f32),
    computed on the host."""
    if mean_delay_ticks <= 0:
        return 0.0
    return float(np.float32(np.exp(np.float32(-1.0 / mean_delay_ticks))))
