"""In-process loopback transport.

The testlib workhorse (role of the reference's loopback TCP in single-JVM
tests): every ``MemoryTransport`` registers in a process-wide address table;
``send`` enqueues onto the destination's listen stream via the event loop,
preserving per-sender FIFO order (the reference's in-order channel guarantee,
``TcpTransportSendOrderTest``).

Addresses look like ``mem://<n>`` and are allocated sequentially; a fixed
"port" can be requested for restart-on-same-address scenarios
(reference ClusterTest start/stop on fixed port).
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Dict, Optional

from ..config import TransportConfig
from ..models.message import Message
from .api import (
    Listeners,
    PeerUnavailableError,
    Transport,
    TransportError,
    register_transport_factory,
)

_SCHEME = "mem://"


class MemoryTransportRegistry:
    """Process-wide address -> transport table (one per test/world if desired)."""

    _default: Optional["MemoryTransportRegistry"] = None

    def __init__(self) -> None:
        self._table: Dict[str, "MemoryTransport"] = {}
        self._ports = itertools.count(1)

    @classmethod
    def default(cls) -> "MemoryTransportRegistry":
        if cls._default is None:
            cls._default = MemoryTransportRegistry()
        return cls._default

    @classmethod
    def reset_default(cls) -> None:
        cls._default = None

    def allocate_address(self, port: int) -> str:
        if port == 0:
            port = next(self._ports)
        addr = f"{_SCHEME}{port}"
        if addr in self._table:
            raise TransportError(f"address already bound: {addr}")
        return addr

    def bind(self, addr: str, transport: "MemoryTransport") -> None:
        self._table[addr] = transport

    def unbind(self, addr: str) -> None:
        self._table.pop(addr, None)

    def lookup(self, addr: str) -> Optional["MemoryTransport"]:
        return self._table.get(addr)


class MemoryTransport(Transport):
    """Loopback transport over an in-process registry."""

    def __init__(self, config: TransportConfig, registry: Optional[MemoryTransportRegistry] = None):
        self._config = config
        self._registry = registry or MemoryTransportRegistry.default()
        self._address: Optional[str] = None
        self._listeners = Listeners()
        self._stopped = False

    @property
    def address(self) -> str:
        if self._address is None:
            raise TransportError("transport not started")
        return self._address

    @property
    def is_stopped(self) -> bool:
        return self._stopped

    async def start(self) -> "MemoryTransport":
        self._address = self._registry.allocate_address(self._config.port)
        self._registry.bind(self._address, self)
        return self

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self._address is not None:
            self._registry.unbind(self._address)

    async def send(self, address: str, message: Message) -> None:
        if self._stopped:
            raise TransportError("transport is stopped")
        peer = self._registry.lookup(address)
        if peer is None or peer.is_stopped:
            raise PeerUnavailableError(f"no transport bound at {address}")
        # call_soon keeps per-sender FIFO order and breaks reentrancy, the
        # analogue of the reference's channel write -> remote event loop hop.
        asyncio.get_running_loop().call_soon(peer._deliver, message)

    def _deliver(self, message: Message) -> None:
        if not self._stopped:
            self._listeners.emit(message)

    def listen(self) -> Listeners:
        return self._listeners


def _memory_factory(config: TransportConfig) -> MemoryTransport:
    return MemoryTransport(config)


register_transport_factory("memory", _memory_factory)
