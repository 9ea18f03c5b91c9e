"""The device trace ring: a fixed-shape [ring_len, n_fields] int32 tensor.

The metric ring's discipline (``telemetry/rings.py``) at K rows per TICK
instead of one row per window: the buffer lives on the driver's device and
each traced tick appends its [K, F] record block in place at a HOST-int
cursor, split in two where it wraps. The host always knows where the ring
stands, so an append reads nothing back; :meth:`TraceRing.last` and
:meth:`TraceRing.snapshot` are the sync points.

The port of the JAX package's ``trace/rings.py``. There the buffer is
threaded through the donated window program and its cursor uploaded as a
device scalar (``device_cursor``); here the window writes the buffer in
place, so the port has no device cursor.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .schema import TraceSpec


class TraceRing:
    """The device trace buffer and its host cursor arithmetic."""

    def __init__(self, spec: TraceSpec, device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self.buf = torch.zeros((spec.ring_len, spec.n_fields), dtype=torch.int32, device=self.device)
        # records in the CURRENT timeline (cursor = records % ring_len)
        self.records = 0
        # lifetime append count: monotone (survives the restore-path
        # clear()) — the /metrics counter source
        self.records_total = 0

    @property
    def cursor(self) -> int:
        return self.records % self.spec.ring_len

    @property
    def wraps(self) -> int:
        """Times the current timeline's ring lapped itself."""
        return self.records // self.spec.ring_len

    @property
    def wraps_total(self) -> int:
        """Lifetime lap count (monotone — the /metrics counter source)."""
        return self.records_total // self.spec.ring_len

    def clear(self) -> None:
        """Drop every retained record (zeroed buffer, cursor 0) — the
        restore path: records of an abandoned timeline must not sew into
        the restored one. The lifetime totals keep counting."""
        self.buf.zero_()
        self.records = 0

    def append(self, rows: torch.Tensor) -> None:
        """Write one [K, n_fields] int32 block in place at the cursor (two
        slices where it wraps) and advance the host counters — no
        device-to-host transfer."""
        k = rows.shape[0]
        ring_len = self.spec.ring_len
        cur = self.cursor
        head = min(k, ring_len - cur)
        self.buf[cur:cur + head].copy_(rows[:head])
        if head < k:
            self.buf[: k - head].copy_(rows[head:])
        self.advance(k)

    def advance(self, n_records: int) -> None:
        self.records += int(n_records)
        self.records_total += int(n_records)

    def last(self, k: Optional[int] = None) -> np.ndarray:
        """The newest ``k`` records (default: all retained), oldest first —
        one device-to-host transfer through the shared
        ``telemetry.rings.ring_tail`` unroll. Callers hold the driver lock."""
        from ..telemetry.rings import ring_tail

        return np.asarray(ring_tail(self.buf, self.records, self.spec.ring_len, k), np.int32)

    def snapshot(self, k: Optional[int] = None) -> Dict[str, object]:
        return {
            "fields": self.spec.field_names(),
            "ring_len": self.spec.ring_len,
            "records": self.records,
            "records_total": self.records_total,
            "cursor": self.cursor,
            "wraps": self.wraps,
            "rows": self.last(k),
        }
