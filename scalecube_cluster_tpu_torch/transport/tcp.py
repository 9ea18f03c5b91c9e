"""Real TCP transport over asyncio streams.

Parity with the reference Netty TCP transport (``TransportImpl.java``,
``TcpReceiver.java:22-49``, ``TcpSender.java:24-57``): a listening server, a
lazily-connected cached client connection per peer
(``TransportImpl.connect0``, ``TransportImpl.java:262-278``), 4-byte
big-endian length-prefixed framing (``TcpChannelInitializer.java:28-33``) with
a max-frame guard, and codec-pluggable message serialization at the channel
boundary (``TransportImpl.java:240-260``). Server/client/cache scaffolding
lives in :mod:`.stream_base`, shared with the WebSocket transport.

This is the DCN-facing path for genuine multi-process clusters; addresses are
``tcp://host:port``.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional, Tuple

from ..config import TransportConfig
from .api import TransportError, register_transport_factory
from .stream_base import StreamTransportBase, parse_host_port

_SCHEME = "tcp://"
_LEN = struct.Struct(">I")


def parse_tcp_address(address: str) -> Tuple[str, int]:
    return parse_host_port(address, _SCHEME)


class TcpTransport(StreamTransportBase):
    """Length-prefixed TCP transport with cached lazy connections."""

    scheme = _SCHEME

    def __init__(self, config: TransportConfig):
        super().__init__(config)

    async def _setup_inbound(self, reader, writer) -> None:
        pass  # raw stream: no handshake

    async def _setup_outbound(self, reader, writer, host, port) -> None:
        pass

    def _frame(self, payload: bytes) -> bytes:
        return _LEN.pack(len(payload)) + payload

    async def _read_payload(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> Optional[bytes]:
        header = await reader.readexactly(_LEN.size)
        (length,) = _LEN.unpack(header)
        if length > self._config.max_frame_length:
            raise TransportError(f"frame too large: {length}")
        return await reader.readexactly(length)


register_transport_factory("tcp", lambda cfg: TcpTransport(cfg))
