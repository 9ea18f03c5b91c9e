"""Shared scaffolding for stream-socket transports (TCP, WebSocket).

Both real wire protocols share everything except framing and handshake: a
listening asyncio server, a lazily-connected cached client connection per
peer (the reference's connection cache, ``TransportImpl.java:54`` /
``connect0:262-278``), codec-pluggable serialization at the channel
boundary, and teardown that also reaps connections still mid-establishment
when ``stop()`` runs. Subclasses supply the scheme, the client-side
connection setup (handshake), the outbound frame encoding, and the inbound
read loop.
"""

from __future__ import annotations

import asyncio
import logging
from abc import abstractmethod
from typing import Dict, Optional, Tuple

import random

from ..config import TransportConfig
from ..models.message import Message
from .api import (
    Listeners,
    PeerUnavailableError,
    Transport,
    TransportError,
    TransportEvent,
)
from .codecs import message_codec

logger = logging.getLogger(__name__)


def parse_host_port(address: str, scheme: str) -> Tuple[str, int]:
    addr = address[len(scheme):] if address.startswith(scheme) else address
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise TransportError(f"bad {scheme} address: {address!r}")
    return host, int(port)


class CachedConnection:
    """One cached outbound connection with FIFO write ordering and an
    optional background reader task (protocols that must service inbound
    control frames on the outbound channel, e.g. WebSocket PING)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.lock = asyncio.Lock()
        self.reader_task: Optional[asyncio.Task] = None

    async def write_bytes(self, data: bytes) -> None:
        async with self.lock:
            self.writer.write(data)
            await self.writer.drain()

    def close(self) -> None:
        if self.reader_task is not None:
            self.reader_task.cancel()
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001
            pass


def _close_when_done(fut: "asyncio.Future[CachedConnection]") -> None:
    if not fut.cancelled() and fut.exception() is None:
        fut.result().close()


class StreamTransportBase(Transport):
    """Server + cached-lazy-client plumbing shared by TCP and WebSocket."""

    scheme: str = ""

    def __init__(self, config: TransportConfig):
        self._config = config
        self._codec = message_codec(config.message_codec)
        self._listeners = Listeners()
        self._server: Optional[asyncio.base_events.Server] = None
        self._address: Optional[str] = None
        self._stopped = False
        # peer address -> pending/established connection (TransportImpl.java:54)
        self._connections: Dict[str, "asyncio.Future[CachedConnection]"] = {}
        self._inbound_writers: set = set()
        # transport lifecycle events (reconnect backoff/giveup, connection
        # loss) — see api.TransportEvent; lazily consumed, never required
        self._events = Listeners()

    # -- subclass hooks ------------------------------------------------------
    @abstractmethod
    async def _setup_inbound(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Server-side channel setup (e.g. websocket upgrade); no-op for raw."""

    @abstractmethod
    async def _read_payload(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> Optional[bytes]:
        """Read one whole encoded message; None when the peer closed cleanly."""

    @abstractmethod
    async def _setup_outbound(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        host: str,
        port: int,
    ) -> None:
        """Client-side channel setup (e.g. websocket handshake)."""

    @abstractmethod
    def _frame(self, payload: bytes) -> bytes:
        """Wrap one encoded message for the wire (length prefix / ws frame)."""

    def _start_outbound_reader(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        conn: "CachedConnection",
        address: str,
    ) -> None:
        """Hook: service the outbound channel's inbound half (control frames
        / peer replies). Default: nothing to read on a raw stream."""

    # -- Transport contract --------------------------------------------------
    @property
    def address(self) -> str:
        if self._address is None:
            raise TransportError("transport not started")
        return self._address

    @property
    def is_stopped(self) -> bool:
        return self._stopped

    async def start(self) -> "StreamTransportBase":
        host, port = self._config.host, self._config.port
        self._server = await asyncio.start_server(self._accept, host=host, port=port)
        bound = self._server.sockets[0].getsockname()
        self._address = f"{self.scheme}{host}:{bound[1]}"
        return self

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._inbound_writers.add(writer)
        try:
            await self._setup_inbound(reader, writer)
            while not self._stopped:
                payload = await self._read_payload(reader, writer)
                if payload is None:
                    break
                self._listeners.emit(self._codec.decode(payload))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # peer went away: normal churn
        except TransportError as exc:
            # wire-protocol violation (oversized frame, bad upgrade, broken
            # fragmentation): tear the channel down, but leave a trace — a
            # silent close makes version-skewed peers undebuggable
            logger.warning("[%s] dropping inbound connection: %s", self._address, exc)
        finally:
            self._inbound_writers.discard(writer)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        for fut in self._connections.values():
            if fut.done():
                _close_when_done(fut)
            else:
                # a connect in flight when stop() runs must not leak its
                # socket once it completes
                fut.add_done_callback(_close_when_done)
        self._connections.clear()
        # Abort accepted connections so their handler coroutines finish —
        # Server.wait_closed() (py3.12+) blocks until all handlers complete.
        for writer in list(self._inbound_writers):
            try:
                writer.transport.abort()
            except Exception:  # noqa: BLE001
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _connect(self, address: str) -> CachedConnection:
        """Lazy cached connect (reference connect0, TransportImpl.java:262-278)."""
        fut = self._connections.get(address)
        if fut is not None:
            if not fut.done() or fut.exception() is None:
                return await asyncio.shield(fut)
            del self._connections[address]  # retry after failed connect
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._connections[address] = fut
        try:
            host, port = parse_host_port(address, self.scheme)
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), self._config.connect_timeout
            )
            await asyncio.wait_for(
                self._setup_outbound(reader, writer, host, port),
                self._config.connect_timeout,
            )
            conn = CachedConnection(writer)
            self._start_outbound_reader(reader, writer, conn, address)
            fut.set_result(conn)
            return conn
        except Exception as exc:  # noqa: BLE001
            err = PeerUnavailableError(f"connect to {address} failed: {exc}")
            fut.set_exception(err)
            # consume so the loop doesn't warn about unretrieved exceptions
            fut.exception()
            self._connections.pop(address, None)
            raise err from exc

    def _emit_event(self, kind: str, address: str, attempts: int = 0,
                    delay: float = 0.0, error: str = "") -> None:
        self._events.emit(TransportEvent(
            kind=kind, address=address, attempts=attempts, delay=delay,
            error=error,
        ))

    def _backoff_delay(self, attempt: int) -> float:
        """Exponential backoff with +-50% jitter, capped: attempt 1 waits
        ~base, attempt 2 ~2*base, ... A synchronized retry stampede against
        a rebooting peer is exactly what the jitter breaks up."""
        base = self._config.reconnect_base_delay * (2 ** (attempt - 1))
        return min(base, self._config.reconnect_max_delay) * (
            0.5 + random.random()
        )

    async def send(self, address: str, message: Message) -> None:
        """Fire-and-forget send over the cached connection, with BOUNDED
        reconnect: a failed connect or a connection that dies mid-send is
        retried up to ``config.reconnect_max_retries`` extra times with
        exponential backoff + jitter (the pre-r7 behavior silently dropped
        the cached connection and failed the send). Exhausting the budget
        raises ``PeerUnavailableError`` AND emits a ``reconnect_giveup``
        transport event — churn monitoring must be able to see give-ups
        without scraping logs. Retrying a write that may have partially
        left the socket keeps at-most-once per ATTEMPT, like the
        reference's reconnect-then-resend; SWIM tolerates duplicates by
        design (every merge is idempotent)."""
        if self._stopped:
            raise TransportError("transport is stopped")
        payload = self._codec.encode(message)
        if len(payload) > self._config.max_frame_length:
            raise TransportError(f"frame too large: {len(payload)}")
        attempt = 0
        while True:
            try:
                conn = await self._connect(address)
                await conn.write_bytes(self._frame(payload))
                return
            except (PeerUnavailableError, ConnectionResetError,
                    BrokenPipeError) as exc:
                self._connections.pop(address, None)
                attempt += 1
                if self._stopped or attempt > self._config.reconnect_max_retries:
                    self._emit_event(
                        "reconnect_giveup", address, attempts=attempt,
                        error=str(exc),
                    )
                    raise PeerUnavailableError(
                        f"send to {address} failed after {attempt} "
                        f"attempt(s): {exc}"
                    ) from exc
                delay = self._backoff_delay(attempt)
                self._emit_event(
                    "reconnect_backoff", address, attempts=attempt,
                    delay=delay, error=str(exc),
                )
                await asyncio.sleep(delay)

    def listen(self) -> Listeners:
        return self._listeners

    def transport_events(self) -> Listeners:
        """Hot stream of :class:`..transport.api.TransportEvent` (reconnect
        backoff / give-up, outbound connection loss)."""
        return self._events
