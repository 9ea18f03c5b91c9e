"""Peaks of the card and the bytes the port's kernels need, for the
kernels' roofline shares.

The card: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet: 3.35 TB/s
of memory bandwidth, at the full 700 W power limit. A card set below it
runs slower under load; the run prints its limit beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def delivery_combine_bytes(ym_words: int, yu_words: int, rumor_slots: int, fanout: int, n: int,
                           senders: int) -> int:
    """Bytes one ``delivery_combine`` launch needs: ``inv`` [F, N] and the
    rumor origins read once; the outputs (the rumor hits as bytes, the
    sources, the membership words, the count) written once; and one sender
    row (membership words, rumor words, infected-from lanes) per distinct
    valid sender (a row several slots name is read once: the bound)."""
    R = rumor_slots
    row_words = ym_words + yu_words + R
    return 4 * fanout * n + 4 * R + 4 * row_words * senders + n * (R + 4 * R + 4 * ym_words) + 4


def bound_seconds(nbytes: int) -> float:
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
