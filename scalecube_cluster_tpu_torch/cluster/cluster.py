"""The ``Cluster`` facade: builds and wires transport + 4 protocol components.

Behavioral parity with reference ``ClusterImpl`` (``cluster/ClusterImpl.java``)
and the ``Cluster`` interface (``cluster-api/Cluster.java:10-151``):

* fluent copy-on-write configuration (``config/membership/gossip/
  failure_detector/transport`` lenses, ClusterImpl.java:143-226);
* start: validate config -> bind transport -> wrap SenderAwareTransport
  (stamps sender header, :556-604) -> create local member (with external
  host/port NAT mapping, :403-417) -> construct FD/gossip/metadata/membership
  -> start FD, gossip, metadata, handler, membership (order :301-307);
* user ``listen`` filtered from protocol traffic (SYSTEM_MESSAGES :62-76,
  filters :381-394);
* graceful shutdown: LEAVING gossip -> dispose components -> stop transport
  (``doShutdown`` :508-544);
* ``update_metadata`` = store update + incarnation bump (:497-501).

API surface: ``address, member(), members(), other_members(), member(id),
member_by_address(), metadata(), metadata_of(), update_metadata(), send(),
request_response(), spread_gossip(), listen_messages(), listen_gossip(),
listen_membership(), shutdown(), on_shutdown``.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, Callable, List, Optional, Sequence

from ..config import ClusterConfig, Lens
from ..models.events import MembershipEvent
from ..models.member import Member
from ..models.message import (
    HEADER_SENDER,
    Message,
    SYSTEM_GOSSIP_QUALIFIERS,
    SYSTEM_QUALIFIERS,
)
from ..transport.api import Listeners, Transport, create_transport
from ..transport.codecs import metadata_codec
from ..utils.streams import EventStream
from .failure_detector import FailureDetector
from .gossip import GossipProtocol
from .membership import MembershipProtocol
from .metadata import MetadataStore

_log = logging.getLogger(__name__)


class ClusterMessageHandler:
    """User callback surface (reference ClusterMessageHandler.java:6-18).
    Subclass or pass plain callables to :meth:`Cluster.handler`."""

    def on_message(self, message: Message) -> None: ...

    def on_gossip(self, gossip: Message) -> None: ...

    def on_membership_event(self, event: MembershipEvent) -> None: ...


class SenderAwareTransport(Transport):
    """Stamps the sender header on every outbound message
    (reference ClusterImpl.SenderAwareTransport :556-604)."""

    def __init__(self, delegate: Transport):
        self._delegate = delegate

    @property
    def address(self) -> str:
        return self._delegate.address

    @property
    def is_stopped(self) -> bool:
        return self._delegate.is_stopped

    async def start(self) -> "SenderAwareTransport":
        await self._delegate.start()
        return self

    async def stop(self) -> None:
        await self._delegate.stop()

    async def send(self, address: str, message: Message) -> None:
        await self._delegate.send(address, message.with_header(HEADER_SENDER, self.address))

    def listen(self) -> Listeners:
        return self._delegate.listen()


class Cluster:
    """Facade over one cluster node (reference Cluster.java + ClusterImpl)."""

    def __init__(self, config: Optional[ClusterConfig] = None):
        self._config = config or ClusterConfig.default_lan()
        self._handler_factory: Optional[Callable[["Cluster"], ClusterMessageHandler]] = None
        self._transport_factory_fn: Optional[Callable[[], Transport]] = None
        self._started = False
        self._shutdown_event: Optional[asyncio.Event] = None
        # wired at start()
        self._transport: Optional[Transport] = None
        self._local_member: Optional[Member] = None
        self._failure_detector: Optional[FailureDetector] = None
        self._gossip: Optional[GossipProtocol] = None
        self._metadata_store: Optional[MetadataStore] = None
        self._membership: Optional[MembershipProtocol] = None
        self._unsubs: List[Callable[[], None]] = []

    # -- fluent config (copy-on-write, ClusterImpl.java:143-226) -----------
    def _with_config(self, config: ClusterConfig) -> "Cluster":
        clone = Cluster(config)
        clone._handler_factory = self._handler_factory
        clone._transport_factory_fn = self._transport_factory_fn
        return clone

    def config(self, op: Lens) -> "Cluster":
        return self._with_config(op(self._config))

    def membership(self, op: Lens) -> "Cluster":
        return self._with_config(self._config.with_membership(op))

    def gossip(self, op: Lens) -> "Cluster":
        return self._with_config(self._config.with_gossip(op))

    def failure_detector(self, op: Lens) -> "Cluster":
        return self._with_config(self._config.with_failure_detector(op))

    def transport(self, op: Lens) -> "Cluster":
        return self._with_config(self._config.with_transport(op))

    def transport_factory(self, factory: Callable[[], Transport]) -> "Cluster":
        """Inject a custom transport instance factory (testlib uses this to
        wrap transports in NetworkEmulatorTransport, reference BaseTest)."""
        clone = self._with_config(self._config)
        clone._transport_factory_fn = factory
        return clone

    def handler(self, factory: Callable[["Cluster"], ClusterMessageHandler]) -> "Cluster":
        clone = self._with_config(self._config)
        clone._handler_factory = factory
        return clone

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "Cluster":
        """Validate, bind, wire, join (doStart0 :249-312)."""
        if self._started:
            raise RuntimeError("cluster already started")
        config = self._config.validate()
        self._shutdown_event = asyncio.Event()

        raw = (
            self._transport_factory_fn()
            if self._transport_factory_fn is not None
            else create_transport(config.transport)
        )
        if raw.is_stopped:
            raise RuntimeError("injected transport is stopped")
        try:
            raw.address
            started = True
        except Exception:  # noqa: BLE001 - not yet started
            started = False
        if not started:
            await raw.start()
        transport = SenderAwareTransport(raw)
        self._transport = transport

        self._local_member = self._create_local_member(transport.address, config)
        rng = random.Random()

        fd_events: EventStream = EventStream()
        self._metadata_store = MetadataStore(
            self._local_member,
            transport,
            metadata_codec(config.metadata_codec),
            config.metadata,
            config.metadata_timeout,
        )
        self._failure_detector = FailureDetector(
            self._local_member, transport, EventStream(), config.failure_detector, rng
        )
        self._gossip = GossipProtocol(
            self._local_member, transport, EventStream(), config.gossip, rng
        )
        self._membership = MembershipProtocol(
            self._local_member,
            transport,
            config,
            config.membership.seed_members,
            self._failure_detector.listen(),
            self._gossip,
            self._metadata_store,
            rng,
        )
        # FD and gossip follow membership events (constructor wiring in
        # reference ClusterImpl.java:260-291)
        self._unsubs.append(
            self._membership.listen().subscribe(self._failure_detector.on_membership_event)
        )
        self._unsubs.append(
            self._membership.listen().subscribe(self._gossip.on_membership_event)
        )

        # Start order (reference :301-307): FD, gossip, metadata, handler, membership
        self._failure_detector.start()
        self._gossip.start()
        self._metadata_store.start()
        self._wire_handler()
        await self._membership.start()
        self._started = True
        return self

    def start_await(self) -> "Cluster":
        """Blocking start (reference startAwait :241-243)."""
        return asyncio.get_event_loop().run_until_complete(self.start())

    def _create_local_member(self, address: str, config: ClusterConfig) -> Member:
        """(createLocalMember :403-417 incl. external host/port NAT)"""
        member_id = config.member_id_generator()
        if config.external_host is not None or config.external_port is not None:
            scheme, _, rest = address.partition("://")
            host, _, port = rest.rpartition(":")
            host = config.external_host or host
            port = str(config.external_port) if config.external_port is not None else port
            address = f"{scheme}://{host}:{port}"
        return Member(
            id=member_id,
            address=address,
            namespace=config.membership.namespace,
            alias=config.member_alias,
        )

    def _wire_handler(self) -> None:
        """System-message filtering so user streams never see protocol traffic
        (SYSTEM_MESSAGES :62-76, listen filters :381-394)."""
        handler = self._handler_factory(self) if self._handler_factory else None

        def on_message(msg: Message) -> None:
            if msg.qualifier in SYSTEM_QUALIFIERS:
                return
            self._user_messages.emit(msg)
            if handler is not None:
                try:
                    handler.on_message(msg)
                except Exception:  # noqa: BLE001
                    _log.exception("user on_message failed")

        def on_gossip(msg: Message) -> None:
            if msg.qualifier in SYSTEM_GOSSIP_QUALIFIERS:
                return
            self._user_gossip.emit(msg)
            if handler is not None:
                try:
                    handler.on_gossip(msg)
                except Exception:  # noqa: BLE001
                    _log.exception("user on_gossip failed")

        def on_membership(event: MembershipEvent) -> None:
            if handler is not None:
                try:
                    handler.on_membership_event(event)
                except Exception:  # noqa: BLE001
                    _log.exception("user on_membership_event failed")

        self._user_messages = EventStream()
        self._user_gossip = EventStream()
        self._unsubs.append(self._transport.listen().subscribe(on_message))
        self._unsubs.append(self._gossip.listen().subscribe(on_gossip))
        self._unsubs.append(self._membership.listen().subscribe(on_membership))

    async def shutdown(self) -> None:
        """Graceful: LEAVING gossip -> brief grace for dissemination ->
        dispose components -> stop transport (doShutdown :508-544)."""
        if not self._started:
            return
        self._started = False
        _log.info("[%s] shutting down", self._local_member)
        try:
            await self._membership.leave()
            # Give the LEAVING rumor a couple of gossip periods to spread
            await asyncio.sleep(2 * self._config.gossip.gossip_interval)
        except Exception as exc:  # noqa: BLE001
            _log.warning("[%s] leave failed: %s", self._local_member, exc)
        for unsub in self._unsubs:
            unsub()
        self._metadata_store.stop()
        self._membership.stop()
        self._gossip.stop()
        self._failure_detector.stop()
        await self._transport.stop()
        self._shutdown_event.set()
        _log.info("[%s] shutdown complete", self._local_member)

    @property
    def on_shutdown(self) -> asyncio.Event:
        return self._shutdown_event

    # -- introspection -----------------------------------------------------
    def _require_started(self):
        if self._membership is None:
            raise RuntimeError("cluster is not started")

    @property
    def address(self) -> str:
        self._require_started()
        return self._local_member.address

    def member(self) -> Member:
        self._require_started()
        return self._local_member

    def members(self) -> List[Member]:
        self._require_started()
        return self._membership.members()

    def other_members(self) -> List[Member]:
        self._require_started()
        return self._membership.other_members()

    def member_by_id(self, member_id: str) -> Optional[Member]:
        self._require_started()
        return self._membership.member(member_id)

    def member_by_address(self, address: str) -> Optional[Member]:
        self._require_started()
        return self._membership.member_by_address(address)

    # -- metadata ----------------------------------------------------------
    def metadata(self) -> Optional[Any]:
        self._require_started()
        return self._metadata_store.metadata()

    def metadata_of(self, member: Member) -> Optional[Any]:
        self._require_started()
        if member.id == self._local_member.id:
            return self.metadata()
        blob = self._metadata_store.member_metadata(member)
        return None if blob is None else self._metadata_store.deserialize(blob)

    async def update_metadata(self, metadata: Any) -> None:
        """(ClusterImpl.updateMetadata :497-501)"""
        self._require_started()
        self._metadata_store.update_local_metadata(metadata)
        await self._membership.update_incarnation()

    # -- messaging ---------------------------------------------------------
    async def send(self, target: "Member | str", message: Message) -> None:
        self._require_started()
        address = target.address if isinstance(target, Member) else target
        await self._transport.send(address, message)

    async def request_response(
        self, target: "Member | str", request: Message, timeout: float = 3.0
    ) -> Message:
        self._require_started()
        address = target.address if isinstance(target, Member) else target
        return await self._transport.request_response(address, request, timeout)

    def spread_gossip(self, message: Message) -> "asyncio.Future[str]":
        self._require_started()
        return self._gossip.spread(message)

    # -- streams -----------------------------------------------------------
    def listen_messages(self) -> EventStream:
        self._require_started()
        return self._user_messages

    def listen_gossip(self) -> EventStream:
        self._require_started()
        return self._user_gossip

    def listen_membership(self) -> EventStream:
        self._require_started()
        return self._membership.listen()

    # -- test/monitor hooks (reference getMembershipRecords etc.) ----------
    @property
    def membership_protocol(self) -> MembershipProtocol:
        self._require_started()
        return self._membership

    @property
    def gossip_protocol(self) -> GossipProtocol:
        self._require_started()
        return self._gossip

    @property
    def failure_detector_component(self) -> FailureDetector:
        self._require_started()
        return self._failure_detector

    @property
    def metadata_store(self) -> MetadataStore:
        self._require_started()
        return self._metadata_store

    @property
    def transport_instance(self) -> Transport:
        self._require_started()
        return self._transport

    def transport_events(self) -> Optional[Listeners]:
        """The underlying transport's lifecycle-event stream (reconnect
        backoff / give-up, connection loss — stream transports only; None
        for transports without one). The r8 telemetry bus attaches here:
        ``bus.attach_cluster(cluster)`` merges these with membership events
        into the unified tick-stamped record stream."""
        self._require_started()
        # unwrap the decorator chain (SenderAwareTransport, and e.g. a
        # NetworkEmulator wrapper under it) until some layer carries the
        # event stream — the real wire transport may sit several deep
        transport = self._transport
        while transport is not None:
            fn = getattr(transport, "transport_events", None)
            if fn is not None:
                return fn()
            transport = getattr(transport, "_delegate", None)
        return None


def new_cluster(config: Optional[ClusterConfig] = None) -> Cluster:
    """Entry point mirroring ``new ClusterImpl()``."""
    return Cluster(config)
