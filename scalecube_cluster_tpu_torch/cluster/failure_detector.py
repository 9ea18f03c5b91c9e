"""SWIM failure detector: periodic random probe + indirect probes via relays.

Behavioral parity with reference ``FailureDetectorImpl``
(``cluster/fdetector/FailureDetectorImpl.java:29-427``):

* every ``ping_interval`` pick the next member from a shuffled round-robin
  list (``selectPingMember`` :352-361 — reshuffle when the cursor wraps) and
  direct-PING it with ``ping_timeout`` (``doPing`` :126-171);
* on timeout pick ``ping_req_members`` random relays (``selectPingReqMembers``
  :363-375) and send PING_REQ with the remaining ``interval - timeout`` budget
  (``doPingReq`` :173-210);
* relays forward a transit PING carrying the original issuer (``onPingReq``
  :262-285) and route the transit ACK back (``onTransitPingAck`` :291-315);
* ACKs carry ``DEST_OK``/``DEST_GONE``; GONE (id mismatch at the probed
  address — a restarted member) yields DEAD, OK yields ALIVE, total silence
  yields SUSPECT (``computeMemberStatus`` :382-404, ``onPing`` :227-259);
* the ping list follows membership ADDED (insert at random position) /
  REMOVED events (``onMemberEvent`` :321-346).

The vectorized analogue is ``ops/kernel.py``'s FD phase — one FD round per tick with the
same verdict function expressed as Bernoulli draws on the link matrix.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import random
from dataclasses import dataclass, replace
from typing import List, Optional, Set

from ..config import FailureDetectorConfig
from ..models.events import FailureDetectorEvent, MembershipEvent
from ..models.member import Member, MemberStatus
from ..models.message import (
    HEADER_CORRELATION_ID,
    Message,
    Q_PING,
    Q_PING_ACK,
    Q_PING_REQ,
    new_correlation_id,
)
from ..transport.api import Transport
from ..utils.streams import EventStream

_log = logging.getLogger(__name__)


class AckType(enum.Enum):
    """PingData.AckType (reference PingData.java:15-29)."""

    DEST_OK = "DEST_OK"
    DEST_GONE = "DEST_GONE"


@dataclass(frozen=True)
class PingData:
    """Probe payload (reference PingData.java:11-37): issuer, target, and —
    for transit pings routed through a relay — the original issuer."""

    from_member: Member
    to_member: Member
    original_issuer: Optional[Member] = None
    ack_type: Optional[AckType] = None

    def with_ack_type(self, ack_type: AckType) -> "PingData":
        return replace(self, ack_type=ack_type)


class FailureDetector:
    """One node's failure detector component."""

    def __init__(
        self,
        local_member: Member,
        transport: Transport,
        membership_events: EventStream,
        config: FailureDetectorConfig,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._local = local_member
        self._transport = transport
        self._config = config
        self._rng = rng or random.Random()
        self._events: EventStream = EventStream()
        self._ping_members: List[Member] = []
        self._ping_member_index = 0
        self._current_period = 0
        self._loop_task: Optional[asyncio.Task] = None
        self._inflight: Set[asyncio.Task] = set()
        self._unsubs = [
            transport.listen().subscribe(self._on_message),
            membership_events.subscribe(self._on_member_event),
        ]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._loop_task = asyncio.ensure_future(self._run())

    def stop(self) -> None:
        for unsub in self._unsubs:
            unsub()
        if self._loop_task is not None:
            self._loop_task.cancel()
        for task in list(self._inflight):
            task.cancel()

    def listen(self) -> EventStream:
        """Stream of :class:`FailureDetectorEvent` verdicts."""
        return self._events

    @property
    def current_period(self) -> int:
        return self._current_period

    # -- periodic probe loop (reference start :101-106) --------------------
    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self._config.ping_interval)
            self._do_ping()

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    def _do_ping(self) -> None:
        period = self._current_period
        self._current_period += 1
        ping_member = self._select_ping_member()
        if ping_member is None:
            return
        self._spawn(self._ping(period, ping_member))

    async def _ping(self, period: int, ping_member: Member) -> None:
        cid = new_correlation_id(self._local.id)
        ping_msg = Message.with_data(
            PingData(self._local, ping_member), qualifier=Q_PING, cid=cid
        )
        _log.debug("[%s][%s] send ping to %s", self._local, period, ping_member)
        try:
            ack = await self._transport.request_response(
                ping_member.address, ping_msg, timeout=self._config.ping_timeout
            )
        except Exception:  # noqa: BLE001 - timeout or send failure -> indirect probe
            time_left = self._config.ping_interval - self._config.ping_timeout
            relays = self._select_ping_req_members(ping_member)
            if time_left <= 0 or not relays:
                self._publish(period, ping_member, MemberStatus.SUSPECT)
            else:
                await self._ping_req(period, ping_member, relays, cid, time_left)
            return
        self._publish(period, ping_member, self._compute_status(ack))

    async def _ping_req(
        self, period: int, ping_member: Member, relays: List[Member], cid: str, timeout: float
    ) -> None:
        """Indirect probe via each relay in parallel (doPingReq :173-210);
        each relay path publishes its own verdict, as in the reference."""
        data = PingData(self._local, ping_member)
        msg = Message.with_data(data, qualifier=Q_PING_REQ, cid=cid)

        async def one(relay: Member) -> None:
            try:
                ack = await self._transport.request_response(relay.address, msg, timeout=timeout)
                self._publish(period, ping_member, self._compute_status(ack))
            except Exception:  # noqa: BLE001
                self._publish(period, ping_member, MemberStatus.SUSPECT)

        await asyncio.gather(*(one(r) for r in relays))

    # -- message handlers --------------------------------------------------
    def _on_message(self, message: Message) -> None:
        q = message.qualifier
        if q == Q_PING:
            self._on_ping(message)
        elif q == Q_PING_REQ:
            self._on_ping_req(message)
        elif q == Q_PING_ACK and isinstance(message.data, PingData) and message.data.original_issuer is not None:
            self._on_transit_ping_ack(message)

    def _on_ping(self, message: Message) -> None:
        """Answer PING with ACK; DEST_GONE if the probed id isn't us
        (restarted member on the same address, onPing :227-259)."""
        data: PingData = message.data
        data = data.with_ack_type(AckType.DEST_OK)
        if data.to_member.id != self._local.id:
            data = data.with_ack_type(AckType.DEST_GONE)
        ack = Message.with_data(data, qualifier=Q_PING_ACK)
        if message.correlation_id is not None:
            ack = ack.with_header(HEADER_CORRELATION_ID, message.correlation_id)
        self._spawn(self._send_quietly(data.from_member.address, ack))

    def _on_ping_req(self, message: Message) -> None:
        """Relay: forward transit PING to the target (onPingReq :262-285)."""
        data: PingData = message.data
        transit = PingData(self._local, data.to_member, original_issuer=data.from_member)
        ping = Message.with_data(transit, qualifier=Q_PING)
        if message.correlation_id is not None:
            ping = ping.with_header(HEADER_CORRELATION_ID, message.correlation_id)
        self._spawn(self._send_quietly(data.to_member.address, ping))

    def _on_transit_ping_ack(self, message: Message) -> None:
        """Relay: route the transit ACK back to the original issuer as a plain
        ACK (onTransitPingAck :291-315)."""
        data: PingData = message.data
        issuer = data.original_issuer
        plain = PingData(issuer, data.to_member, ack_type=data.ack_type)
        ack = Message.with_data(plain, qualifier=Q_PING_ACK)
        if message.correlation_id is not None:
            ack = ack.with_header(HEADER_CORRELATION_ID, message.correlation_id)
        self._spawn(self._send_quietly(issuer.address, ack))

    async def _send_quietly(self, address: str, message: Message) -> None:
        try:
            await self._transport.send(address, message)
        except Exception as exc:  # noqa: BLE001
            _log.debug("[%s] failed to send %s to %s: %s", self._local, message.qualifier, address, exc)

    # -- membership feed (onMemberEvent :321-346) --------------------------
    def on_membership_event(self, event: MembershipEvent) -> None:
        self._on_member_event(event)

    def _on_member_event(self, event: MembershipEvent) -> None:
        member = event.member
        if event.is_removed and member in self._ping_members:
            self._ping_members.remove(member)
        if event.is_added and member.id != self._local.id:
            index = self._rng.randrange(len(self._ping_members)) if self._ping_members else 0
            self._ping_members.insert(index, member)

    # -- selection ---------------------------------------------------------
    def _select_ping_member(self) -> Optional[Member]:
        if not self._ping_members:
            return None
        if self._ping_member_index >= len(self._ping_members):
            self._ping_member_index = 0
            self._rng.shuffle(self._ping_members)
        member = self._ping_members[self._ping_member_index]
        self._ping_member_index += 1
        return member

    def _select_ping_req_members(self, ping_member: Member) -> List[Member]:
        k = self._config.ping_req_members
        if k <= 0:
            return []
        candidates = [m for m in self._ping_members if m != ping_member]
        self._rng.shuffle(candidates)
        return candidates[:k]

    # -- verdicts ----------------------------------------------------------
    def _publish(self, period: int, member: Member, status: MemberStatus) -> None:
        _log.debug("[%s][%s] member %s detected as %s", self._local, period, member, status.name)
        self._events.emit(FailureDetectorEvent(member, status, period=period))

    @staticmethod
    def _compute_status(ack: Message) -> MemberStatus:
        data: PingData = ack.data
        if data.ack_type is None:
            return MemberStatus.ALIVE
        if data.ack_type == AckType.DEST_OK:
            return MemberStatus.ALIVE
        if data.ack_type == AckType.DEST_GONE:
            return MemberStatus.DEAD
        return MemberStatus.SUSPECT
