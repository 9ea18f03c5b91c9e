"""Infection-style gossip dissemination.

Behavioral parity with reference ``GossipProtocolImpl``
(``cluster/gossip/GossipProtocolImpl.java:32-387``):

* ``spread()`` enqueues a rumor with a local monotone ``sequence_id``
  (``createAndPutGossip`` :190-199) and resolves once the rumor has most
  likely disseminated (``:360-368``);
* every ``gossip_interval`` pick ``gossip_fanout`` members via a shuffled
  sliding window (``selectGossipMembers`` :322-343) and send every rumor not
  yet known-infected at the peer and younger than
  ``repeat_mult * ceil_log2(N)`` periods (``selectGossipsToSend`` :311-320);
* receivers dedup by ``(gossiper_id, sequence_id)`` via
  :class:`SequenceIdCollector` and mark the sender infected
  (``onGossipReq`` :201-215);
* rumors are swept after ``2*(spread+1)`` periods (``getGossipsToRemove``
  :350-358); too many dedup gaps triggers the segmentation warning
  (``checkGossipSegmentation`` :217-236).

Vectorized analogue: ``ops/kernel.py``'s gossip phase — rumor state as (slots × N)
infection bitmaps, fanout-sample + scatter per tick, dedup as bitmap OR.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..config import GossipConfig
from ..models.events import MembershipEvent
from ..models.member import Member
from ..models.message import Message, Q_GOSSIP_REQ
from ..transport.api import Transport
from ..utils.cluster_math import gossip_periods_to_spread, gossip_periods_to_sweep
from ..utils.intervals import SequenceIdCollector
from ..utils.streams import EventStream

_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Gossip:
    """One rumor (reference Gossip.java:12-29): origin id, per-origin sequence
    id, and the user message payload."""

    gossiper_id: str
    sequence_id: int
    message: Message

    @property
    def gossip_id(self) -> str:
        return f"{self.gossiper_id}-{self.sequence_id}"


@dataclass
class GossipState:
    """Local bookkeeping for one rumor (reference GossipState.java:18):
    period at which this node got infected + peers known infected."""

    gossip: Gossip
    infection_period: int
    infected: Set[str] = field(default_factory=set)


@dataclass(frozen=True)
class GossipRequest:
    """Wire payload of one GOSSIP_REQ (reference GossipRequest.java:14)."""

    gossips: List[Gossip]
    from_id: str


class GossipProtocol:
    """One node's gossip component."""

    def __init__(
        self,
        local_member: Member,
        transport: Transport,
        membership_events: EventStream,
        config: GossipConfig,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._local = local_member
        self._transport = transport
        self._config = config
        self._rng = rng or random.Random()
        self._messages: EventStream = EventStream()  # delivered rumor payloads
        self._remote_members: List[Member] = []
        self._remote_members_index = -1
        self._current_period = 0
        self._sequence_id = 0
        self._gossips: Dict[str, GossipState] = {}
        self._futures: Dict[str, asyncio.Future] = {}
        self._collectors: Dict[str, SequenceIdCollector] = {}
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
        for fut in self._futures.values():
            if not fut.done():
                fut.cancel()

    def listen(self) -> EventStream:
        """Stream of delivered rumor payload messages."""
        return self._messages

    @property
    def current_period(self) -> int:
        return self._current_period

    # -- spread API --------------------------------------------------------
    def spread(self, message: Message) -> "asyncio.Future[str]":
        """Enqueue a rumor; the future resolves to the gossip id once it has
        most likely disseminated (reference spread :126-130)."""
        gossip = Gossip(self._local.id, self._sequence_id, message)
        self._sequence_id += 1
        state = GossipState(gossip, self._current_period)
        self._gossips[gossip.gossip_id] = state
        self._ensure_collector(self._local.id).add(gossip.sequence_id)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._futures[gossip.gossip_id] = fut
        return fut

    # -- periodic spread loop (doSpreadGossip :141-184) --------------------
    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self._config.gossip_interval)
            self._do_spread_gossip()

    def _do_spread_gossip(self) -> None:
        period = self._current_period
        self._current_period += 1
        self._check_segmentation()
        if not self._gossips:
            return
        for member in self._select_gossip_members():
            self._spread_gossips_to(period, member)
        # sweep
        for gossip_id in self._gossips_to_remove(period):
            del self._gossips[gossip_id]
        # complete spread futures
        for gossip_id in self._gossips_that_most_likely_disseminated(period):
            fut = self._futures.pop(gossip_id, None)
            if fut is not None and not fut.done():
                fut.set_result(gossip_id)

    def _spread_gossips_to(self, period: int, member: Member) -> None:
        gossips = self._select_gossips_to_send(period, member)
        if not gossips:
            return
        request = GossipRequest(gossips, self._local.id)
        msg = Message.with_data(request, qualifier=Q_GOSSIP_REQ)
        task = asyncio.ensure_future(self._send_quietly(member.address, msg))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _send_quietly(self, address: str, message: Message) -> None:
        try:
            await self._transport.send(address, message)
        except Exception as exc:  # noqa: BLE001
            _log.debug("[%s] failed to send gossip to %s: %s", self._local, address, exc)

    # -- receive (onGossipReq :201-215) ------------------------------------
    def _on_message(self, message: Message) -> None:
        if message.qualifier != Q_GOSSIP_REQ:
            return
        period = self._current_period
        request: GossipRequest = message.data
        for gossip in request.gossips:
            if self._ensure_collector(gossip.gossiper_id).add(gossip.sequence_id):
                state = self._gossips.get(gossip.gossip_id)
                if state is None:  # new rumor: store + deliver
                    state = GossipState(gossip, period)
                    self._gossips[gossip.gossip_id] = state
                    self._messages.emit(gossip.message)
                state.infected.add(request.from_id)

    def _check_segmentation(self) -> None:
        threshold = self._config.gossip_segmentation_threshold
        for origin, collector in self._collectors.items():
            if collector.size() > threshold:
                _log.warning(
                    "[%s][%s] too many missed gossips from %s — node was suspected "
                    "for a long time or has connectivity problems; resetting dedup",
                    self._local,
                    self._current_period,
                    origin,
                )
                collector.clear()

    # -- membership feed (onMemberEvent :238-261) --------------------------
    def on_membership_event(self, event: MembershipEvent) -> None:
        self._on_member_event(event)

    def _on_member_event(self, event: MembershipEvent) -> None:
        member = event.member
        if event.is_removed:
            if member in self._remote_members:
                self._remote_members.remove(member)
            self._collectors.pop(member.id, None)
        if event.is_added and member.id != self._local.id:
            self._remote_members.append(member)

    # -- selection ---------------------------------------------------------
    def _select_gossip_members(self) -> List[Member]:
        fanout = self._config.gossip_fanout
        members = self._remote_members
        if len(members) < fanout:
            return list(members)
        if self._remote_members_index < 0 or self._remote_members_index + fanout > len(members):
            self._rng.shuffle(members)
            self._remote_members_index = 0
        selected = members[self._remote_members_index : self._remote_members_index + fanout]
        self._remote_members_index += fanout
        return selected

    def _select_gossips_to_send(self, period: int, member: Member) -> List[Gossip]:
        periods_to_spread = gossip_periods_to_spread(
            self._config.gossip_repeat_mult, len(self._remote_members) + 1
        )
        return [
            s.gossip
            for s in self._gossips.values()
            if s.infection_period + periods_to_spread >= period and member.id not in s.infected
        ]

    def _gossips_to_remove(self, period: int) -> List[str]:
        periods_to_sweep = gossip_periods_to_sweep(
            self._config.gossip_repeat_mult, len(self._remote_members) + 1
        )
        return [
            gid for gid, s in self._gossips.items() if period > s.infection_period + periods_to_sweep
        ]

    def _gossips_that_most_likely_disseminated(self, period: int) -> List[str]:
        periods_to_spread = gossip_periods_to_spread(
            self._config.gossip_repeat_mult, len(self._remote_members) + 1
        )
        return [
            gid
            for gid, s in self._gossips.items()
            if period > s.infection_period + periods_to_spread
        ]

    def _ensure_collector(self, origin_id: str) -> SequenceIdCollector:
        return self._collectors.setdefault(origin_id, SequenceIdCollector())

    # -- introspection (tests) ---------------------------------------------
    def gossip_segmentation(self, origin_id: str) -> int:
        collector = self._collectors.get(origin_id)
        return collector.size() if collector is not None else 0
