"""Network fault injection at the transport seam.

Parity with reference ``NetworkEmulator`` (cluster-testlib
``NetworkEmulator.java:26-417``): per-destination outbound settings (loss
percent + exponentially-distributed delay with given mean), per-source inbound
pass/block flag, defaults for unconfigured links, block/unblock for one or
all peers, and sent/lost counters — plus the ``NetworkEmulatorTransport``
decorator (``NetworkEmulatorTransport.java:9-89``) that applies outbound
fail -> delay before send and filters inbound on the listen stream.

The vectorized sim applies the same model on-device: loss/delay become
Bernoulli/exponential draws against an N×N link matrix inside the tick kernel
(``ops/kernel.py`` — the FD and gossip phases); this module is the scalar-engine and
real-transport version, and the oracle for those kernel draws.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from ..models.message import HEADER_SENDER, Message
from .api import Listeners, Transport, TransportError


class NetworkEmulatorError(TransportError):
    """Raised when the emulator drops an outbound message."""


@dataclass(frozen=True)
class OutboundSettings:
    """Loss %% and mean delay (seconds) for one directed link
    (reference NetworkEmulator.OutboundSettings:310-386)."""

    loss_percent: float = 0.0
    mean_delay: float = 0.0

    def evaluate_loss(self, rng: random.Random) -> bool:
        """True if the message should be dropped."""
        return self.loss_percent > 0 and (
            self.loss_percent >= 100 or rng.uniform(0, 100) < self.loss_percent
        )

    def evaluate_delay(self, rng: random.Random) -> float:
        """Exponential delay sample with the configured mean
        (reference NetworkEmulator.java:349-369)."""
        if self.mean_delay <= 0:
            return 0.0
        return rng.expovariate(1.0 / self.mean_delay)


@dataclass(frozen=True)
class InboundSettings:
    """Pass/block flag for one inbound peer (reference InboundSettings:388-417)."""

    shall_pass: bool = True


class NetworkEmulator:
    """Mutable per-link fault model, safe to reconfigure while running."""

    def __init__(self, address: str = "", seed: Optional[int] = None) -> None:
        self._address = address
        self._rng = random.Random(seed)
        self._outbound: Dict[str, OutboundSettings] = {}
        self._inbound: Dict[str, InboundSettings] = {}
        self._default_outbound = OutboundSettings()
        self._default_inbound = InboundSettings()
        self.total_message_sent_count = 0
        self.total_message_lost_count = 0

    # -- outbound ----------------------------------------------------------
    def outbound_settings(self, destination: str) -> OutboundSettings:
        return self._outbound.get(destination, self._default_outbound)

    def set_outbound_settings(
        self, destination: str, loss_percent: float, mean_delay: float = 0.0
    ) -> None:
        self._outbound[destination] = OutboundSettings(loss_percent, mean_delay)

    def set_default_outbound_settings(self, loss_percent: float, mean_delay: float = 0.0) -> None:
        self._default_outbound = OutboundSettings(loss_percent, mean_delay)

    def block_outbound(self, destinations: Iterable[str]) -> None:
        for d in destinations:
            self._outbound[d] = OutboundSettings(100.0, 0.0)

    def unblock_outbound(self, destinations: Iterable[str]) -> None:
        for d in destinations:
            self._outbound.pop(d, None)

    def block_all_outbound(self) -> None:
        self._outbound.clear()
        self._default_outbound = OutboundSettings(100.0, 0.0)

    def unblock_all_outbound(self) -> None:
        self._outbound.clear()
        self._default_outbound = OutboundSettings()

    async def try_fail_and_delay(self, destination: str) -> None:
        """Apply loss then delay for one outbound message; raises on drop
        (reference NetworkEmulatorTransport outbound pipeline :50-75)."""
        settings = self.outbound_settings(destination)
        self.total_message_sent_count += 1
        if settings.evaluate_loss(self._rng):
            self.total_message_lost_count += 1
            raise NetworkEmulatorError(f"emulator dropped message {self._address} -> {destination}")
        delay = settings.evaluate_delay(self._rng)
        if delay > 0:
            await asyncio.sleep(delay)

    # -- inbound -----------------------------------------------------------
    def inbound_settings(self, source: str) -> InboundSettings:
        return self._inbound.get(source, self._default_inbound)

    def set_inbound_settings(self, source: str, shall_pass: bool) -> None:
        self._inbound[source] = InboundSettings(shall_pass)

    def set_default_inbound_settings(self, shall_pass: bool) -> None:
        self._default_inbound = InboundSettings(shall_pass)

    def block_inbound(self, sources: Iterable[str]) -> None:
        for s in sources:
            self._inbound[s] = InboundSettings(False)

    def unblock_inbound(self, sources: Iterable[str]) -> None:
        for s in sources:
            self._inbound.pop(s, None)

    def block_all_inbound(self) -> None:
        self._inbound.clear()
        self._default_inbound = InboundSettings(False)

    def unblock_all_inbound(self) -> None:
        self._inbound.clear()
        self._default_inbound = InboundSettings(True)


class NetworkEmulatorTransport(Transport):
    """Decorator applying the emulator around any transport
    (reference NetworkEmulatorTransport.java:9-89); also stamps the sender
    header on outbound messages (:85-87)."""

    def __init__(self, delegate: Transport, emulator: Optional[NetworkEmulator] = None):
        self._delegate = delegate
        self._emulator = emulator or NetworkEmulator()
        self._listeners = Listeners()
        self._wired = False

    @property
    def network_emulator(self) -> NetworkEmulator:
        return self._emulator

    @property
    def address(self) -> str:
        return self._delegate.address

    @property
    def is_stopped(self) -> bool:
        return self._delegate.is_stopped

    async def start(self) -> "NetworkEmulatorTransport":
        await self._delegate.start()
        self._wire()
        return self

    def _wire(self) -> None:
        if not self._wired:
            self._emulator._address = self._delegate.address
            self._delegate.listen().subscribe(self._on_inbound)
            self._wired = True

    def _on_inbound(self, message: Message) -> None:
        sender = message.sender
        if sender is not None and not self._emulator.inbound_settings(sender).shall_pass:
            return
        self._listeners.emit(message)

    async def stop(self) -> None:
        await self._delegate.stop()

    async def send(self, address: str, message: Message) -> None:
        message = message.with_header(HEADER_SENDER, self.address)
        await self._emulator.try_fail_and_delay(address)
        await self._delegate.send(address, message)

    def listen(self) -> Listeners:
        self._wire()
        return self._listeners
