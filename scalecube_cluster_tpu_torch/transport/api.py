"""Transport SPI — the seam every protocol component depends on.

Parity with reference ``Transport`` (transport-api ``Transport.java:11-79``):
the same 4-method contract (``start/stop``, fire-and-forget ``send``,
correlated ``request_response``, hot ``listen()`` stream) plus factory
discovery by config key (``TransportImpl.bind``, ``TransportImpl.java:135-141``
— config -> ServiceLoader -> TCP default; here: config -> registry ->
``memory`` default).

Everything above this boundary (failure detector, gossip, membership,
metadata, facade, testlib scenarios) is transport-agnostic — the invariant
that lets the TPU-simulated mesh (``sim/sim_transport.py``) replace real
sockets without protocol changes.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List

from ..config import TransportConfig
from ..models.message import HEADER_CORRELATION_ID, Message, new_correlation_id
from ..utils.streams import EventStream

MessageHandler = Callable[[Message], Any]

#: Hot fan-out of inbound messages (the ``listen()`` flux analogue).
Listeners = EventStream  # type: ignore[misc]


class TransportError(Exception):
    """Base transport failure (connect/send/decode errors)."""


class PeerUnavailableError(TransportError):
    """Destination address cannot be reached (no such peer / connect refused)."""


from dataclasses import dataclass as _dataclass, field as _field
import time as _time


@_dataclass(frozen=True)
class TransportEvent:
    """Structured transport lifecycle event, emitted on a transport's
    ``transport_events()`` stream (stream transports only today): reconnect
    backoff attempts, the bounded-retry give-up, and outbound connection
    losses. Gives operators/monitors the signal the old "dropping outbound
    connection" log line swallowed.

    kinds: ``reconnect_backoff`` (a retry is scheduled; ``attempts`` so
    far, ``delay`` seconds), ``reconnect_giveup`` (retry budget exhausted —
    the send raised), ``connection_lost`` (an established outbound channel
    died and was evicted from the cache)."""

    kind: str
    address: str
    attempts: int = 0
    delay: float = 0.0
    error: str = ""
    ts: float = _field(default_factory=_time.time)


class Transport(ABC):
    """The 4-method p2p messaging contract (reference Transport.java:11-79)."""

    @property
    @abstractmethod
    def address(self) -> str:
        """Bound listen address of this transport."""

    @abstractmethod
    async def start(self) -> "Transport":
        """Bind and start accepting; returns self (reference ``start()``)."""

    @abstractmethod
    async def stop(self) -> None:
        """Stop accepting, complete the listen stream, release resources."""

    @property
    @abstractmethod
    def is_stopped(self) -> bool: ...

    @abstractmethod
    async def send(self, address: str, message: Message) -> None:
        """Fire-and-forget delivery to ``address`` (at-most-once)."""

    @abstractmethod
    def listen(self) -> Listeners:
        """Hot stream of inbound messages; components filter by qualifier."""

    async def request_response(
        self, address: str, request: Message, timeout: float
    ) -> Message:
        """Correlated RPC: listen-filter-on-cid + send, first match wins
        (reference TransportImpl.java:214-238 — no server-side dispatch
        table; the correlation id in the request must be echoed in the
        response)."""
        cid = request.correlation_id
        if cid is None:
            cid = new_correlation_id()
            request = request.with_header(HEADER_CORRELATION_ID, cid)

        loop = asyncio.get_running_loop()
        fut: "asyncio.Future[Message]" = loop.create_future()

        def on_message(msg: Message) -> None:
            if msg.correlation_id == cid and not fut.done():
                fut.set_result(msg)

        unsubscribe = self.listen().subscribe(on_message)
        try:
            await self.send(address, request)
            return await asyncio.wait_for(fut, timeout)
        finally:
            unsubscribe()


# -- factory registry (ServiceLoader analogue, TransportFactory.java:5) -----

TransportFactoryFn = Callable[[TransportConfig], Transport]
_FACTORIES: Dict[str, TransportFactoryFn] = {}

DEFAULT_FACTORY = "memory"


def register_transport_factory(name: str, factory: TransportFactoryFn) -> None:
    _FACTORIES[name] = factory


def transport_factories() -> List[str]:
    return sorted(_FACTORIES)


def create_transport(config: TransportConfig) -> Transport:
    """Resolve factory from config (reference TransportImpl.bind:135-141)."""
    name = config.transport_factory or DEFAULT_FACTORY
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise TransportError(
            f"unknown transport factory {name!r}; registered: {transport_factories()}"
        ) from None
    return factory(config)


async def bind_transport(config: TransportConfig) -> Transport:
    """Create + start in one call (reference ``Transport.bind`` convenience)."""
    return await create_transport(config).start()
