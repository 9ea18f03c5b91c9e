"""Hot pub-sub event stream (the Reactor ``Flux``/``Sinks`` analogue).

Subscribers are sync callbacks invoked in subscription order; exceptions in
one subscriber don't affect others. ``stream()`` returns a queue-backed view
for async iteration in tests/user code.

A copy of the JAX package's ``utils/streams.py`` (which imports no JAX): the
port keeps its own, so it imports nothing of that package.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")
_log = logging.getLogger(__name__)


class EventStream(Generic[T]):
    def __init__(self) -> None:
        self._subs: Dict[int, Callable[[T], None]] = {}
        self._ids = itertools.count()

    def subscribe(self, handler: Callable[[T], None]) -> Callable[[], None]:
        sid = next(self._ids)
        self._subs[sid] = handler

        def unsubscribe() -> None:
            self._subs.pop(sid, None)

        return unsubscribe

    def emit(self, event: T) -> None:
        for handler in list(self._subs.values()):
            try:
                handler(event)
            except Exception:  # noqa: BLE001 - one bad subscriber must not break fan-out
                _log.exception("subscriber failed on %s", event)

    def stream(self) -> "asyncio.Queue[T]":
        q: asyncio.Queue[T] = asyncio.Queue()
        self.subscribe(q.put_nowait)
        return q
