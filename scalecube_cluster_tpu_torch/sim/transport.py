"""The Transport SPI over the simulated mesh.

Implements the same 4-method contract as the memory/TCP transports
(``Transport.java:11-79``: send / request_response / listen / start·stop) for
addresses ``sim://<row>``, so user-messaging code and the testlib scenario
helpers run unmodified against simulated members (SURVEY.md §7 stage 5).

Delivery honors the sim's directed link-loss matrix with draws from the
driver's host RNG — the same emulation semantics the kernel applies to
protocol traffic (loss 1.0 = blocked link ⇒ PeerUnavailableError surfaces as
a timeout for request_response, silent drop for send, exactly like the
NetworkEmulatorTransport decorator, ``NetworkEmulatorTransport.java:50-75``).
Messages are stamped with the sender header like SenderAwareTransport
(``ClusterImpl.java:587-603``).
"""

from __future__ import annotations

import asyncio

from ..models.message import HEADER_SENDER, Message
from ..transport.api import Listeners, Transport, TransportError
from .driver import SimDriver, row_address


def _parse_row(address: str) -> int:
    if not address.startswith("sim://"):
        raise TransportError(f"not a sim address: {address}")
    return int(address[len("sim://") :])


class SimTransport(Transport):
    """Messaging endpoint of one simulated member."""

    def __init__(self, driver: SimDriver, row: int):
        self._d = driver
        self.row = row
        self._listeners = Listeners()
        self._stopped = False

    # -- Transport contract --------------------------------------------------
    @property
    def address(self) -> str:
        return row_address(self.row)

    @property
    def is_stopped(self) -> bool:
        return self._stopped or not self._d.is_up(self.row)

    async def start(self) -> "SimTransport":
        self._stopped = False
        return self

    async def stop(self) -> None:
        self._stopped = True

    def listen(self) -> Listeners:
        return self._listeners

    async def send(self, address: str, message: Message) -> None:
        if self.is_stopped:
            raise TransportError("transport is stopped")
        dst = _parse_row(address)
        peer = self._d._transports.get(dst)
        if peer is None or peer.is_stopped or not self._d.is_up(dst):
            # fire-and-forget against a gone peer: silently dropped on the
            # wire (connection failure surfaces only for request_response)
            return
        loss = self._d.link_loss(self.row, dst)
        if loss > 0.0 and self._d._rng.random() < loss:
            return  # dropped by the emulated link
        stamped = message.with_header(HEADER_SENDER, self.address)
        loop = asyncio.get_running_loop()
        loop.call_soon(peer._listeners.emit, stamped)

    # request_response: inherited cid-filtered implementation (Transport base)
