"""SWIM membership protocol: suspicion, incarnation refutation, SYNC anti-entropy.

Behavioral parity with reference ``MembershipProtocolImpl``
(``cluster/membership/MembershipProtocolImpl.java:54-944``):

* startup: initial SYNC to all seeds, merge answers arriving within
  ``sync_timeout``, then periodic SYNC to one random seed-or-member every
  ``sync_interval`` (``start0`` :250-291, ``doSync`` :339-357,
  ``selectSyncAddress`` :461-472);
* core merge ``update_membership`` (:569-664): namespace relatedness gate
  (:511-536), precedence lattice (``MembershipRecord.overrides``) with the
  LEAVING exception (a LEAVING r0 is always re-processed), self-rumor
  refutation bumping own incarnation (``onSelfMemberDetected`` :686-708),
  SUSPECT scheduling the ``suspicion_mult*ceil_log2(N)*ping_interval`` timer
  (:805-823) that declares DEAD (:825-834), DEAD removing member + metadata
  and emitting REMOVED (:740-767), ALIVE accepted only after a successful
  metadata fetch (:636-658), LEAVING flow (:233-242, :710-733) including
  late-ALIVE-after-LEAVING (:666-684);
* every accepted non-gossip update is re-gossiped
  (``spreadMembershipGossipUnlessGossiped`` :836-843);
* FD verdicts merge in via ``onFailureDetectorEvent`` (:418-449) — note
  ALIVE-after-SUSPECT triggers a SYNC to the member instead of a direct
  override; membership rumors via ``onMembershipGossip`` (:452-459).

Vectorized analogue: ``ops/kernel.py``'s merge/suspicion phases — an elementwise
lattice join over N×N (status, incarnation) tensors, suspicion timers a
deadline matrix compared against the tick counter.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from ..config import ClusterConfig
from ..models.events import FailureDetectorEvent, MembershipEvent
from ..models.member import Member, MemberStatus
from ..models.message import (
    HEADER_CORRELATION_ID,
    Message,
    Q_MEMBERSHIP_GOSSIP,
    Q_MEMBERSHIP_SYNC,
    Q_MEMBERSHIP_SYNC_ACK,
    new_correlation_id,
)
from ..models.record import MembershipRecord
from ..transport.api import Transport
from ..utils.cluster_math import suspicion_timeout
from ..utils.namespaces import are_namespaces_related
from ..utils.streams import EventStream
from .gossip import GossipProtocol
from .metadata import MetadataStore

_log = logging.getLogger(__name__)


class MembershipUpdateReason(enum.Enum):
    """Reference MembershipProtocolImpl update reasons enum (:58-64)."""

    FAILURE_DETECTOR_EVENT = "fd"
    MEMBERSHIP_GOSSIP = "gossip"
    SYNC = "sync"
    INITIAL_SYNC = "initial-sync"
    SUSPICION_TIMEOUT = "suspicion-timeout"


@dataclass(frozen=True)
class SyncData:
    """Full-table SYNC payload (reference SyncData.java:18)."""

    membership: List[MembershipRecord]


class MembershipProtocol:
    """One node's membership component."""

    def __init__(
        self,
        local_member: Member,
        transport: Transport,
        config: ClusterConfig,
        seed_members: Sequence[str],
        failure_detector_events: EventStream,
        gossip: GossipProtocol,
        metadata_store: MetadataStore,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._local = local_member
        self._transport = transport
        self._config = config
        self._m_config = config.membership
        self._rng = rng or random.Random()
        self._gossip = gossip
        self._metadata_store = metadata_store

        # Protocol state (reference :88-91)
        self._membership_table: Dict[str, MembershipRecord] = {
            local_member.id: MembershipRecord(local_member, MemberStatus.ALIVE, 0)
        }
        self._members: Dict[str, Member] = {local_member.id: local_member}
        self._alive_emitted: Set[str] = set()
        self._removed_history: List[MembershipEvent] = []
        self._suspicion_tasks: Dict[str, asyncio.TimerHandle] = {}

        # Exclude own address from seeds (reference cleanup of self-seed)
        self._seed_members = [a for a in seed_members if a != local_member.address]

        self._events: EventStream = EventStream()
        self._events.subscribe(self._on_member_removed)
        self._sync_task: Optional[asyncio.Task] = None
        self._inflight: Set[asyncio.Task] = set()
        self._stopped = False
        self._unsubs = [
            transport.listen().subscribe(self._on_message),
            failure_detector_events.subscribe(self._on_failure_detector_event),
            gossip.listen().subscribe(self._on_gossip_message),
        ]

    # -- accessors ---------------------------------------------------------
    def listen(self) -> EventStream:
        """Stream of :class:`MembershipEvent`."""
        return self._events

    def members(self) -> List[Member]:
        return list(self._members.values())

    def other_members(self) -> List[Member]:
        return [m for m in self._members.values() if m.id != self._local.id]

    def member(self, member_id: str) -> Optional[Member]:
        return self._members.get(member_id)

    def member_by_address(self, address: str) -> Optional[Member]:
        for m in self._members.values():
            if m.address == address:
                return m
        return None

    def membership_records(self) -> List[MembershipRecord]:
        return list(self._membership_table.values())

    @property
    def incarnation(self) -> int:
        return self._membership_table[self._local.id].incarnation

    def alive_members(self) -> List[Member]:
        return [r.member for r in self._membership_table.values() if r.is_alive]

    def suspected_members(self) -> List[Member]:
        return [r.member for r in self._membership_table.values() if r.is_suspect]

    def removed_members(self) -> List[Member]:
        return [e.member for e in self._removed_history]

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Initial sync with all seeds, then periodic sync (start0 :250-291)."""
        if not self._seed_members:
            self._schedule_periodic_sync()
            return
        _log.info("[%s] initial sync to seeds: %s", self._local, self._seed_members)
        msg = self._prepare_sync_message(Q_MEMBERSHIP_SYNC, new_correlation_id(self._local.id))
        tasks = [
            asyncio.ensure_future(
                self._transport.request_response(seed, msg, timeout=self._m_config.sync_timeout)
            )
            for seed in self._seed_members
        ]
        done, pending = await asyncio.wait(tasks, timeout=self._m_config.sync_timeout)
        for task in pending:
            task.cancel()
        for task in done:
            if task.cancelled() or task.exception() is not None:
                continue
            ack = task.result()
            sync_data: SyncData = ack.data
            await self._sync_membership(sync_data, on_start=True)
        self._schedule_periodic_sync()

    def stop(self) -> None:
        self._stopped = True
        for unsub in self._unsubs:
            unsub()
        if self._sync_task is not None:
            self._sync_task.cancel()
        for handle in self._suspicion_tasks.values():
            handle.cancel()
        self._suspicion_tasks.clear()
        for task in list(self._inflight):
            task.cancel()

    async def leave(self) -> None:
        """Graceful leave: bump incarnation, gossip LEAVING (leaveCluster :233-242)."""
        r0 = self._membership_table[self._local.id]
        r1 = MembershipRecord(self._local, MemberStatus.LEAVING, r0.incarnation + 1)
        self._membership_table[self._local.id] = r1
        await self._spread_membership_gossip(r1)

    async def update_incarnation(self) -> None:
        """Bump own incarnation and gossip it — carries metadata updates to
        peers (reference MembershipProtocol.updateIncarnation)."""
        r0 = self._membership_table[self._local.id]
        r1 = MembershipRecord(self._local, r0.status, r0.incarnation + 1)
        self._membership_table[self._local.id] = r1
        await self._spread_membership_gossip(r1)

    # -- periodic sync (doSync :339-357) -----------------------------------
    def _schedule_periodic_sync(self) -> None:
        if not self._stopped:
            self._sync_task = asyncio.ensure_future(self._sync_loop())

    async def _sync_loop(self) -> None:
        while True:
            await asyncio.sleep(self._m_config.sync_interval)
            address = self._select_sync_address()
            if address is None:
                continue
            msg = self._prepare_sync_message(Q_MEMBERSHIP_SYNC, None)
            await self._send_quietly(address, msg)

    def _select_sync_address(self) -> Optional[str]:
        addresses = list(
            {*self._seed_members, *(m.address for m in self.other_members())}
        )
        if not addresses:
            return None
        return self._rng.choice(addresses)

    def _prepare_sync_message(self, qualifier: str, cid: Optional[str]) -> Message:
        data = SyncData(self.membership_records())
        msg = Message.with_data(data, qualifier=qualifier)
        if cid is not None:
            msg = msg.with_header(HEADER_CORRELATION_ID, cid)
        return msg

    # -- message handlers --------------------------------------------------
    def _on_message(self, message: Message) -> None:
        q = message.qualifier
        if q == Q_MEMBERSHIP_SYNC:
            self._spawn(self._on_sync(message))
        elif q == Q_MEMBERSHIP_SYNC_ACK and message.correlation_id is None:
            # cid-carrying SYNC_ACKs are consumed by request_response futures
            self._spawn(self._sync_membership(message.data, on_start=False))

    async def _on_sync(self, message: Message) -> None:
        """Merge incoming table, reply with own table (onSync :394-415)."""
        sender = message.sender
        await self._sync_membership(message.data, on_start=False)
        if sender is None:
            return
        reply = self._prepare_sync_message(Q_MEMBERSHIP_SYNC_ACK, message.correlation_id)
        await self._send_quietly(sender, reply)

    async def _sync_membership(self, sync_data: SyncData, on_start: bool) -> None:
        reason = (
            MembershipUpdateReason.INITIAL_SYNC if on_start else MembershipUpdateReason.SYNC
        )
        for record in sync_data.membership:
            try:
                await self.update_membership(record, reason)
            except Exception as exc:  # noqa: BLE001
                _log.debug("[%s][syncMembership][%s] error: %s", self._local, reason, exc)

    def _on_failure_detector_event(self, event: FailureDetectorEvent) -> None:
        """(onFailureDetectorEvent :418-449)"""
        r0 = self._membership_table.get(event.member.id)
        if r0 is None or r0.status == event.status:
            return
        _log.debug("[%s] fd status change: %s", self._local, event)
        if event.status == MemberStatus.ALIVE:
            # ALIVE won't override SUSPECT; send SYNC to force the member to
            # re-spread ALIVE with a bumped incarnation (reference :427-442).
            msg = self._prepare_sync_message(Q_MEMBERSHIP_SYNC, None)
            self._spawn(self._send_quietly(event.member.address, msg))
        else:
            record = MembershipRecord(r0.member, event.status, r0.incarnation)
            self._spawn(
                self.update_membership(record, MembershipUpdateReason.FAILURE_DETECTOR_EVENT)
            )

    def _on_gossip_message(self, message: Message) -> None:
        """(onMembershipGossip :452-459)"""
        if message.qualifier == Q_MEMBERSHIP_GOSSIP:
            record: MembershipRecord = message.data
            self._spawn(self.update_membership(record, MembershipUpdateReason.MEMBERSHIP_GOSSIP))

    # -- the core merge (updateMembership :569-664) ------------------------
    async def update_membership(
        self, r1: MembershipRecord, reason: MembershipUpdateReason
    ) -> None:
        if r1 is None:
            raise ValueError("membership record can't be None")
        # Namespace gate
        if not are_namespaces_related(self._m_config.namespace, r1.member.namespace):
            _log.debug(
                "[%s][updateMembership][%s] skipping, namespace mismatch: %s vs %s",
                self._local, reason, self._m_config.namespace, r1.member.namespace,
            )
            return

        r0 = self._membership_table.get(r1.member.id)

        # If r0 is LEAVING we process the update regardless of precedence
        if (r0 is None or not r0.is_leaving) and not r1.overrides(r0):
            return

        # Update about the local member: refute by incarnation bump
        if r1.member.address == self._local.address:
            if r1.member.id == self._local.id:
                self._on_self_member_detected(r0, r1, reason)
            return

        if r1.is_leaving:
            await self._on_leaving_detected(r0, r1)
            return

        if r1.is_dead:
            self._on_dead_member_detected(r1)
            return

        if r1.is_suspect:
            if r0 is None or not r0.is_leaving:
                self._membership_table[r1.member.id] = r1
            self._schedule_suspicion_timeout(r1)
            self._spread_gossip_unless_gossiped(r1, reason)
            return

        if r1.is_alive:
            if r0 is not None and r0.is_leaving:
                self._on_alive_after_leaving(r1)
                return
            if r0 is None or r0.incarnation < r1.incarnation:
                try:
                    metadata1 = await self._metadata_store.fetch_metadata(r1.member)
                except Exception as exc:  # noqa: BLE001
                    _log.warning(
                        "[%s][updateMembership][%s] skipping add/update of %s: "
                        "metadata fetch failed (%s)",
                        self._local, reason, r1, exc,
                    )
                    return
                # Metadata received -> member is genuinely alive
                self._cancel_suspicion_timeout(r1.member.id)
                self._spread_gossip_unless_gossiped(r1, reason)
                metadata0 = self._metadata_store.update_metadata(r1.member, metadata1)
                self._on_alive_member_detected(r1, metadata0, metadata1)

    # -- state-machine tails -----------------------------------------------
    def _on_self_member_detected(
        self, r0: MembershipRecord, r1: MembershipRecord, reason: MembershipUpdateReason
    ) -> None:
        """Refutation: bump incarnation, re-gossip own record
        (onSelfMemberDetected :686-708)."""
        incarnation = max(r0.incarnation, r1.incarnation)
        r2 = MembershipRecord(self._local, r0.status, incarnation + 1)
        self._membership_table[self._local.id] = r2
        _log.debug(
            "[%s][updateMembership][%s] refuting %s with %s", self._local, reason, r1, r2
        )
        self._spawn(self._spread_membership_gossip(r2))

    def _on_alive_after_leaving(self, r1: MembershipRecord) -> None:
        """Late ALIVE when LEAVING already known (onAliveAfterLeaving :666-684)."""
        member = r1.member
        self._members[member.id] = member
        if member.id not in self._alive_emitted:
            self._alive_emitted.add(member.id)
            self._publish(MembershipEvent.added(member, None))
            self._publish(MembershipEvent.leaving(member, None))

    async def _on_leaving_detected(
        self, r0: Optional[MembershipRecord], r1: MembershipRecord
    ) -> None:
        """(onLeavingDetected :710-733)"""
        member = r1.member
        self._membership_table[member.id] = r1
        if r0 is not None and (
            r0.is_alive or (r0.is_suspect and member.id in self._alive_emitted)
        ):
            metadata = self._metadata_store.member_metadata(member)
            self._publish(MembershipEvent.leaving(member, metadata))
        if r0 is None or not r0.is_leaving:
            self._schedule_suspicion_timeout(r1)
            await self._spread_membership_gossip(r1)

    def _on_dead_member_detected(self, r1: MembershipRecord) -> None:
        """(onDeadMemberDetected :740-767)"""
        member = r1.member
        self._cancel_suspicion_timeout(member.id)
        if member.id not in self._members:
            return
        del self._members[member.id]
        r0 = self._membership_table.pop(member.id)
        metadata = self._metadata_store.remove_metadata(member)
        self._alive_emitted.discard(member.id)
        if r0.is_leaving:
            _log.info("[%s] member left gracefully: %s", self._local, member)
        else:
            _log.info("[%s] member left without notification: %s", self._local, member)
        self._publish(MembershipEvent.removed(member, metadata))

    def _on_alive_member_detected(
        self, r1: MembershipRecord, metadata0: Optional[bytes], metadata1: bytes
    ) -> None:
        """(onAliveMemberDetected :769-795)"""
        member = r1.member
        exists = member.id in self._members
        event: Optional[MembershipEvent] = None
        if not exists:
            event = MembershipEvent.added(member, metadata1)
        elif metadata1 != metadata0:
            event = MembershipEvent.updated(member, metadata0, metadata1)
        self._members[member.id] = member
        self._membership_table[member.id] = r1
        if event is not None:
            self._publish(event)
            if event.is_added:
                self._alive_emitted.add(member.id)

    # -- suspicion timers (scheduleSuspicionTimeoutTask :805-823) ----------
    def _schedule_suspicion_timeout(self, record: MembershipRecord) -> None:
        member_id = record.member.id
        if member_id in self._suspicion_tasks:
            return
        timeout = suspicion_timeout(
            self._m_config.suspicion_mult,
            len(self._membership_table),
            self._config.failure_detector.ping_interval,
        )
        _log.debug("[%s] scheduled suspicion timeout %.3fs for %s", self._local, timeout, member_id)
        loop = asyncio.get_event_loop()
        self._suspicion_tasks[member_id] = loop.call_later(
            timeout, self._on_suspicion_timeout, member_id
        )

    def _cancel_suspicion_timeout(self, member_id: str) -> None:
        handle = self._suspicion_tasks.pop(member_id, None)
        if handle is not None:
            handle.cancel()

    def _on_suspicion_timeout(self, member_id: str) -> None:
        """(onSuspicionTimeout :825-834)"""
        self._suspicion_tasks.pop(member_id, None)
        record = self._membership_table.get(member_id)
        if record is not None:
            _log.debug("[%s] declaring suspected member %s DEAD", self._local, record)
            dead = MembershipRecord(record.member, MemberStatus.DEAD, record.incarnation)
            self._spawn(self.update_membership(dead, MembershipUpdateReason.SUSPICION_TIMEOUT))

    # -- gossip spread -----------------------------------------------------
    def _spread_gossip_unless_gossiped(
        self, record: MembershipRecord, reason: MembershipUpdateReason
    ) -> None:
        """(spreadMembershipGossipUnlessGossiped :836-843)"""
        if reason not in (
            MembershipUpdateReason.MEMBERSHIP_GOSSIP,
            MembershipUpdateReason.INITIAL_SYNC,
        ):
            self._spawn(self._spread_membership_gossip(record))

    async def _spread_membership_gossip(self, record: MembershipRecord) -> None:
        msg = Message.with_data(record, qualifier=Q_MEMBERSHIP_GOSSIP)
        self._gossip.spread(msg)  # future resolution not awaited, as in reference

    # -- misc --------------------------------------------------------------
    def _publish(self, event: MembershipEvent) -> None:
        _log.info("[%s][publishEvent] %s", self._local, event)
        self._events.emit(event)

    def _on_member_removed(self, event: MembershipEvent) -> None:
        """Removed-members ring (onMemberRemoved :934-943)."""
        if not event.is_removed:
            return
        size = self._m_config.removed_members_history_size
        if size <= 0:
            return
        self._removed_history.append(event)
        if len(self._removed_history) > size:
            self._removed_history.pop(0)

    def _spawn(self, coro) -> None:
        task = asyncio.ensure_future(coro)
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _send_quietly(self, address: str, message: Message) -> None:
        try:
            await self._transport.send(address, message)
        except Exception as exc:  # noqa: BLE001
            _log.debug("[%s] failed to send %s to %s: %s", self._local, message.qualifier, address, exc)
