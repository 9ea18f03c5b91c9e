"""On-device metric rings: fixed-shape [ring_len, n_metrics] window series.

Every ``SimDriver.step`` of an armed driver appends one f32 row (the
engine's ``telemetry_window_vector`` and the sentinel columns) to a
circular buffer on the driver's device, written in place at row ``windows
% ring_len``: a host int picks the row, so an append is one device copy
and reads nothing back. The ring stays on the device until an explicit
sync point (:meth:`MetricRing.snapshot`, a ``/metrics`` scrape, a
flight-recorder dump) reads it in one transfer.

The port of the JAX package's ``telemetry/rings.py``; there the buffer is
replaced by a donated jitted update, here it is written in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def ring_tail(buf: torch.Tensor, appended: int, ring_len: int, k: Optional[int] = None) -> np.ndarray:
    """Oldest-first unroll of a circular buffer's newest ``k`` rows;
    ``appended`` is the total rows ever written (cursor = appended %
    ring_len). Reading ``buf`` is the caller's sync point."""
    have = min(appended, ring_len)
    k = have if k is None else min(int(k), have)
    if k <= 0:  # empty read: no device transfer
        return np.zeros((0,) + tuple(buf.shape[1:]), np.float32)
    host = buf.detach().cpu().numpy()
    if appended >= ring_len:  # wrapped: unroll from the cursor
        cursor = appended % ring_len
        ordered = np.concatenate([host[cursor:], host[:cursor]], axis=0)
    else:
        ordered = host[:have]
    return ordered[-k:]


class MetricRing:
    """Circular [ring_len, n_metrics] f32 device buffer of per-window rows.

    ``names`` fixes the column layout (the engine's ``TELEMETRY_SERIES``
    and the sentinel columns). :meth:`append` is the per-window device-only
    path; :meth:`snapshot` / :meth:`last` / :meth:`latest_values` are the
    host reads."""

    def __init__(self, names: Sequence[str], ring_len: int, device="cuda"):
        if ring_len <= 0:
            raise ValueError("ring_len must be > 0")
        self.names = tuple(names)
        self.ring_len = int(ring_len)
        self._buf = torch.zeros((self.ring_len, len(self.names)), dtype=torch.float32, device=device)
        self._windows = 0  # host-side append count (cursor = windows % len)
        # the newest appended row, kept: a scrape reads it without touching
        # the ring
        self._last_row = None

    @property
    def windows(self) -> int:
        """Total rows ever appended (>= ring_len means the ring wrapped)."""
        return self._windows

    def append(self, row: torch.Tensor) -> None:
        """Write one window row ([n_metrics] f32 device tensor) in place —
        no device-to-host transfer."""
        self._buf[self._windows % self.ring_len].copy_(row)
        self._last_row = row
        self._windows += 1

    def last(self, k: Optional[int] = None) -> np.ndarray:
        """The most recent ``k`` rows (default: all retained), oldest first —
        one device-to-host transfer."""
        return ring_tail(self._buf, self._windows, self.ring_len, k)

    def snapshot(self, k: Optional[int] = None) -> Dict[str, object]:
        """Host view of the ring: column names, the last ``k`` rows in time
        order and the append count. THE ring readback site."""
        return {
            "names": list(self.names),
            "ring_len": self.ring_len,
            "windows": self._windows,
            "rows": self.last(k),
        }

    def latest_values(self) -> Dict[str, float]:
        """name -> value of the newest row ({} before the first append): a
        read of the kept row, never of the ring."""
        if self._last_row is None:
            return {}
        vals = self._last_row.detach().cpu().numpy()
        return {n: float(v) for n, v in zip(self.names, vals)}

    def series(self, name: str, k: Optional[int] = None) -> List[float]:
        """One named column of the retained window series, oldest first."""
        col = self.names.index(name)
        return [float(v) for v in self.last(k)[:, col]]
