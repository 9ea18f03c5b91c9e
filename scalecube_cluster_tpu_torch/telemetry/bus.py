"""Unified event bus: one bounded, tick-stamped, subscribable event stream.

Before r8 the system's discrete events lived in three unrelated places —
membership events on per-watch ``EventStream``s, chaos scenario/sentinel
events inside the runner's report, and ``TransportEvent``s on each stream
transport's private listener — so correlating "the partition healed, then
the reconnect storm hit, then row 7 rejoined" meant scraping three logs.
The :class:`TelemetryBus` merges them into a single ordered record stream:

* every record carries a monotone ``seq`` (total order), the sim ``tick``
  it was observed at (the driver's host-side tick shadow — stamping NEVER
  reads the device), a wall-clock ``ts``, a ``source`` ("driver",
  "membership", "chaos", "transport", "checkpoint", ...), a ``kind``, and
  free-form ``fields``;
* retention is BOUNDED (``TelemetryConfig.bus_capacity``); evictions are
  counted, never silent;
* subscribers get records as they are published (the ``EventStream``
  fan-out semantics — one bad subscriber never breaks the rest), which is
  how the bus feeds :class:`..monitor.TickLogger` and the monitor's
  ``/events`` endpoint;
* ``attach_*`` helpers wire the three legacy streams in.

A copy of the JAX package's ``telemetry/bus.py`` (pure Python, over the
port's own :mod:`..utils.streams`): the port imports nothing of that
package.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.streams import EventStream


@dataclass(frozen=True)
class BusRecord:
    """One merged telemetry event (JSON-ready via :meth:`as_dict`)."""

    seq: int
    tick: int
    ts: float
    source: str
    kind: str
    fields: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "seq": self.seq,
            "tick": self.tick,
            "ts": self.ts,
            "source": self.source,
            "kind": self.kind,
            **self.fields,
        }


class TelemetryBus:
    """Bounded, ordered, subscribable merge of every event source."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("bus capacity must be > 0")
        self.capacity = int(capacity)
        self._records: deque = deque(maxlen=self.capacity)
        self._stream: EventStream = EventStream()
        self._seq = 0
        self._evicted = 0
        self._counts: Counter = Counter()  # (source, kind) -> published
        self._lock = threading.Lock()
        self._unsubs: List[Callable[[], None]] = []

    # -- publishing ----------------------------------------------------------
    def publish(
        self, source: str, kind: str, tick: int = -1, **fields
    ) -> BusRecord:
        """Append one record (thread-safe; called from the sim thread, the
        monitor thread, and asyncio transport callbacks alike)."""
        with self._lock:
            rec = BusRecord(
                seq=self._seq, tick=int(tick), ts=time.time(),
                source=source, kind=kind, fields=dict(fields),
            )
            self._seq += 1
            if len(self._records) == self.capacity:
                self._evicted += 1
            self._records.append(rec)
            self._counts[(source, kind)] += 1
        self._stream.emit(rec)
        return rec

    # -- consumption ---------------------------------------------------------
    def subscribe(self, handler: Callable[[BusRecord], None]) -> Callable[[], None]:
        return self._stream.subscribe(handler)

    def tail(self, n: Optional[int] = None) -> List[BusRecord]:
        """The newest ``n`` retained records (default: all), oldest first."""
        with self._lock:
            records = list(self._records)
        return records if n is None else records[-int(n):]

    def counts(self) -> Dict[Tuple[str, str], int]:
        """(source, kind) -> total records ever published (monotone — the
        OpenMetrics counter source, unaffected by ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "retained": len(self._records),
                "published": self._seq,
                "evicted": self._evicted,
            }

    # -- source adapters ------------------------------------------------------
    def attach_transport(
        self, transport, tick_fn: Optional[Callable[[], int]] = None
    ) -> Callable[[], None]:
        """Merge a stream transport's ``transport_events()`` (reconnect
        backoff / give-up, connection loss) into the bus."""
        tick_fn = tick_fn or (lambda: -1)

        def on_event(ev) -> None:
            self.publish(
                "transport", ev.kind, tick=tick_fn(), address=ev.address,
                attempts=ev.attempts, delay=ev.delay, error=ev.error,
            )

        unsub = transport.transport_events().subscribe(on_event)
        self._unsubs.append(unsub)
        return unsub

    def attach_membership(
        self,
        stream: EventStream,
        observer: str,
        tick_fn: Optional[Callable[[], int]] = None,
    ) -> Callable[[], None]:
        """Merge one observer's ``MembershipEvent`` stream (a driver watch
        or the scalar engine's ``listen_membership()``) into the bus."""
        tick_fn = tick_fn or (lambda: -1)

        def on_event(ev) -> None:
            self.publish(
                "membership", ev.type.name.lower(), tick=tick_fn(),
                observer=observer, member=ev.member.id,
                address=ev.member.address,
            )

        unsub = stream.subscribe(on_event)
        self._unsubs.append(unsub)
        return unsub

    def attach_cluster(
        self, cluster, tick_fn: Optional[Callable[[], int]] = None
    ) -> List[Callable[[], None]]:
        """Merge one scalar-engine Cluster node's membership events AND its
        transport lifecycle events (when the transport has any) into the
        bus; returns the unsubscribers."""
        unsubs = [
            self.attach_membership(
                cluster.listen_membership(), cluster.member().id, tick_fn
            )
        ]
        events = cluster.transport_events()
        if events is not None:
            tf = tick_fn or (lambda: -1)

            def on_event(ev) -> None:
                self.publish(
                    "transport", ev.kind, tick=tf(), address=ev.address,
                    attempts=ev.attempts, delay=ev.delay, error=ev.error,
                )

            unsub = events.subscribe(on_event)
            self._unsubs.append(unsub)
            unsubs.append(unsub)
        return unsubs

    def pipe_to_tick_logger(self, tick_logger) -> Callable[[], None]:
        """Forward every bus record into a :class:`..monitor.TickLogger` as a
        structured event line (the bus IS the logger's event source now)."""

        def on_record(rec: BusRecord) -> None:
            tick_logger.log_event(
                rec.tick, f"{rec.source}:{rec.kind}", seq=rec.seq, **rec.fields
            )

        unsub = self.subscribe(on_record)
        self._unsubs.append(unsub)
        return unsub

    def close(self) -> None:
        """Detach every adapter subscription this bus created."""
        for unsub in self._unsubs:
            unsub()
        self._unsubs.clear()
