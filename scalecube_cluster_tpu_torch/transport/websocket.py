"""WebSocket transport — the second real wire protocol behind the SPI.

Parity with the reference's WebSocket transport (binary frames over an HTTP
upgrade: ``WebsocketTransportFactory.java:8``, ``WebsocketReceiver.java:52``,
``WebsocketSender.java:41``): one encoded message per binary frame (the
frame layer replaces TCP's explicit length prefix), lazily-connected cached
client connection per peer, codec-pluggable serialization at the channel
boundary. Server/client/cache scaffolding lives in :mod:`.stream_base`,
shared with the TCP transport. Addresses are ``ws://host:port``.

Self-contained RFC 6455 implementation over asyncio streams (no external
dependency): HTTP/1.1 upgrade handshake with ``Sec-WebSocket-Accept``
validation, client-to-server frame masking as the RFC requires, 7/16/64-bit
payload lengths, PING→PONG replies, CLOSE handling. Fragmented messages
(continuation frames) are reassembled under the max-frame cap; a data frame
arriving mid-fragmentation fails the connection (RFC 6455 §5.4).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
import os
import struct
from typing import Optional, Tuple

from ..config import TransportConfig
from .api import TransportError, register_transport_factory
from .stream_base import StreamTransportBase, parse_host_port

logger = logging.getLogger(__name__)

_SCHEME = "ws://"
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 §1.3

_OP_CONT = 0x0
_OP_BINARY = 0x2
_OP_CLOSE = 0x8
_OP_PING = 0x9
_OP_PONG = 0xA


def parse_ws_address(address: str) -> Tuple[str, int]:
    return parse_host_port(address, _SCHEME)


def _accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _mask_payload(mask: bytes, payload: bytes) -> bytes:
    # XOR with the repeating 4-byte mask — int-wide XOR beats a byte loop
    reps = (len(payload) + 3) // 4
    key = int.from_bytes(mask * reps, "little")
    data = int.from_bytes(payload.ljust(reps * 4, b"\0"), "little")
    return (data ^ key).to_bytes(reps * 4, "little")[: len(payload)]


def _encode_frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    head = bytes([0x80 | opcode])  # FIN + opcode
    mask_bit = 0x80 if mask else 0
    n = len(payload)
    if n < 126:
        head += bytes([mask_bit | n])
    elif n < (1 << 16):
        head += bytes([mask_bit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        return head + key + _mask_payload(key, payload)
    return head + payload


async def _read_frame(reader: asyncio.StreamReader, max_len: int) -> Tuple[int, bool, bytes]:
    """Returns (opcode, fin, payload) of one frame, unmasking if needed."""
    b0, b1 = await reader.readexactly(2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    if n > max_len:
        raise TransportError(f"frame too large: {n}")
    key = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if key:
        payload = _mask_payload(key, payload)
    return opcode, fin, payload


async def _read_message(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    max_len: int,
    server_side: bool,
) -> Optional[bytes]:
    """One complete binary message (reassembling continuations, capped at
    ``max_len`` TOTAL), or None on CLOSE. PINGs are answered inline
    (RFC 6455 §5.5.2)."""
    buf = b""
    expecting_cont = False
    while True:
        opcode, fin, payload = await _read_frame(reader, max_len)
        if opcode == _OP_CLOSE:
            return None
        if opcode == _OP_PING:
            writer.write(_encode_frame(_OP_PONG, payload, mask=not server_side))
            await writer.drain()
            continue
        if opcode == _OP_PONG:
            continue
        if opcode == _OP_BINARY:
            if expecting_cont:  # RFC 6455 §5.4: fail the connection
                raise TransportError("new data frame arrived mid-fragmentation")
            buf = payload
        elif opcode == _OP_CONT:
            if not expecting_cont:
                raise TransportError("continuation frame without a start frame")
            if len(buf) + len(payload) > max_len:
                raise TransportError("reassembled message too large")
            buf += payload
        else:
            raise TransportError(f"unexpected ws opcode {opcode:#x}")
        if fin:
            return buf
        expecting_cont = True


async def _server_handshake(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter
) -> None:
    request = await reader.readuntil(b"\r\n\r\n")
    headers = {}
    for line in request.split(b"\r\n")[1:]:
        if b":" in line:
            k, v = line.split(b":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get(b"sec-websocket-key")
    if key is None or b"websocket" not in headers.get(b"upgrade", b"").lower():
        writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        await writer.drain()
        raise TransportError("not a websocket upgrade request")
    writer.write(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\n"
        b"Connection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: " + _accept_key(key.decode("ascii")).encode("ascii")
        + b"\r\n\r\n"
    )
    await writer.drain()


async def _client_handshake(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter, host: str, port: int
) -> None:
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    writer.write(
        (
            f"GET / HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Upgrade: websocket\r\n"
            f"Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode("ascii")
    )
    await writer.drain()
    response = await reader.readuntil(b"\r\n\r\n")
    status = response.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise TransportError(f"websocket upgrade refused: {status!r}")
    for line in response.split(b"\r\n")[1:]:
        if line.lower().startswith(b"sec-websocket-accept:"):
            got = line.split(b":", 1)[1].strip().decode("ascii")
            if got != _accept_key(key):
                raise TransportError("bad Sec-WebSocket-Accept")
            return
    raise TransportError("missing Sec-WebSocket-Accept")


class WebsocketTransport(StreamTransportBase):
    """RFC 6455 transport: one encoded message per binary frame."""

    scheme = _SCHEME

    def __init__(self, config: TransportConfig):
        super().__init__(config)

    async def _setup_inbound(self, reader, writer) -> None:
        await _server_handshake(reader, writer)

    async def _setup_outbound(self, reader, writer, host, port) -> None:
        await _client_handshake(reader, writer, host, port)

    def _frame(self, payload: bytes) -> bytes:
        # client side of the connection: RFC requires masking
        return _encode_frame(_OP_BINARY, payload, mask=True)

    async def _read_payload(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> Optional[bytes]:
        return await _read_message(
            reader, writer, self._config.max_frame_length, server_side=True
        )

    def _start_outbound_reader(self, reader, writer, conn, address) -> None:
        """The outbound channel's inbound half must be serviced: RFC 6455
        peers send PINGs (answered inside ``_read_message``) and may CLOSE;
        unread frames would otherwise rot in the stream buffer until TCP
        backpressure. Data frames a peer chooses to send back over this
        channel feed the same listen() stream as server-side ones."""

        async def _drain() -> None:
            drop_error = ""
            try:
                while not self._stopped:
                    payload = await _read_message(
                        reader, writer, self._config.max_frame_length,
                        server_side=False,
                    )
                    if payload is None:  # peer CLOSE
                        break
                    self._listeners.emit(self._codec.decode(payload))
            except (asyncio.IncompleteReadError, ConnectionResetError) as exc:
                drop_error = str(exc)
            except TransportError as exc:
                drop_error = str(exc)
                logger.warning(
                    "[%s] dropping outbound connection to %s: %s",
                    self._address, address, exc,
                )
            finally:
                # evict ONLY if the cache still points at THIS connection — a
                # stale drain racing a reconnect must not pop (and orphan)
                # its successor
                fut = self._connections.get(address)
                if (
                    fut is not None
                    and fut.done()
                    and not fut.cancelled()
                    and fut.exception() is None
                    and fut.result() is conn
                ):
                    self._connections.pop(address, None)
                    # surfaced as a transport event so churn monitors see
                    # channel loss without scraping logs; the next send()
                    # runs the bounded-backoff reconnect
                    if not self._stopped:
                        self._emit_event(
                            "connection_lost", address, error=drop_error,
                        )
                conn.close()

        conn.reader_task = asyncio.get_running_loop().create_task(_drain())


register_transport_factory("websocket", lambda cfg: WebsocketTransport(cfg))
