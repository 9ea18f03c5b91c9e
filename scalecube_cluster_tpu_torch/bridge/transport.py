"""Hybrid bridge: real ``Cluster`` processes inside a simulated membership.

``TpuSimTransport`` implements the same ``Transport`` contract as
``TcpTransport`` / ``WebsocketTransport`` (``transport/api.py:65``), but its
"network" is a :class:`SimBridge` that splices the endpoint into a live
:class:`~scalecube_cluster_tpu_torch.sim.driver.SimDriver`: the bridged process
occupies one simulated row, every addressed sim row is materialized as a
host-side proxy endpoint, and the two protocol planes meet at the window
boundary (PAPER.md §1's pluggable-transport promise — "small real
configurations and huge simulated configurations run the same protocol
logic").

Direction real → sim (the proxy plane, all host-side, all OUTSIDE the jit):

* ``Q_PING`` / ``Q_PING_REQ`` — answered from the driver's host-visible
  truth: an up row whose occupant id matches acks ``DEST_OK``, an id
  mismatch (row re-occupied after restart) acks ``DEST_GONE`` exactly like
  the reference (``FailureDetectorImpl.onPing:300-320``), and a down row
  stays silent so the caller's timeout drives SUSPECT.
* ``Q_MEMBERSHIP_SYNC`` / ``SYNC_ACK`` — the sender's own record is folded
  into the driver as host mutations on the existing ``spread_rumor`` /
  ``crash_rows`` seam (incarnation bump → ``update_metadata``, LEAVING →
  ``leave``); a SYNC against an up row is answered with a full-table
  ``SyncData`` synthesized from ``view_of`` (one coalesced readback).
* ``Q_METADATA_REQ`` — answered for the row's current occupant (the
  reference answers only for its own id, ``MetadataStoreImpl:146-185``);
  this is the gate real membership requires before accepting ALIVE.
* ``Q_GOSSIP_REQ`` — deduplicated by gossip id; membership gossip about the
  sender folds like SYNC, user gossip folds into ``driver.spread_rumor``.

Direction sim → real (the window-boundary fold): each bridged row is a
watched row, so its per-window view diffs ride the ONE stacked
``[n_ticks, W, N]`` readback the r10 watch plane already pays — no new
in-scan consumers, the r12 audit matrix stays green (``tools/audit_programs
--variants bridge`` proves it). Events accumulated during a window are
coalesced into a single ``Q_MEMBERSHIP_SYNC`` message per endpoint whose
records take status + incarnation straight from the post-window key
snapshot (``_Watch.prev_key``), then merged by the real member's ordinary
serial ``_sync_membership`` path — one message per window instead of a
per-event gossip storm.

Deviations vs the reference netty transport are catalogued in
``docs/SERVING.md`` (§ deviations): bridged-member liveness toward the sim
is authored by the bridge link state (``fail_link`` / ``heal_link``), never
by third-party gossip, and sim-side user rumors are not surfaced to bridged
members (the rumor payload plane is host-tracked per driver, not per row).
"""

from __future__ import annotations

import asyncio
import random
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from ..cluster.failure_detector import AckType, PingData
from ..cluster.membership import SyncData
from ..cluster.metadata import GetMetadataRequest, GetMetadataResponse
from ..models.member import Member, MemberStatus
from ..models.message import (
    HEADER_CORRELATION_ID,
    HEADER_SENDER,
    Message,
    Q_GOSSIP_REQ,
    Q_MEMBERSHIP_GOSSIP,
    Q_MEMBERSHIP_SYNC,
    Q_MEMBERSHIP_SYNC_ACK,
    Q_METADATA_REQ,
    Q_METADATA_RESP,
    Q_PING,
    Q_PING_ACK,
    Q_PING_REQ,
)
from ..models.record import MembershipRecord
from ..transport.api import (
    Listeners,
    PeerUnavailableError,
    Transport,
    TransportError,
    TransportEvent,
    register_transport_factory,
)
from ..transport.codecs import PickleMetadataCodec
from ..config import TransportConfig
from ..sim.driver import SimDriver, _status_of_key, row_address

BRIDGE_SCHEME = "tpusim://"

#: DEAD in the packed key maps through MemberStatus; UNKNOWN (no record /
#: forgotten row) folds to DEAD for record synthesis — to a real member a
#: forgotten row is simply gone.
_GONE = MemberStatus.DEAD


def _parse_sim_row(address: str) -> int:
    return int(address[len("sim://"):])


class BridgeError(TransportError):
    """Misuse of the bridge plane (bad address scheme, double attach...)."""


class SimBridge:
    """Hub joining a handful of real processes to one simulated membership.

    Owns the proxy plane for ``sim://`` addresses and the window-boundary
    fold for each bridged endpoint. All mutations of the driver go through
    its public host-mutation seam (``join`` / ``leave`` / ``crash`` /
    ``update_metadata`` / ``spread_rumor``) under the driver lock, so they
    land in the next stepped window like any other scripted churn.
    """

    _default: "Optional[SimBridge]" = None

    def __init__(
        self,
        driver: SimDriver,
        *,
        seed_rows=(0,),
        config: Optional[TransportConfig] = None,
    ) -> None:
        self._d = driver
        self._seed_rows = tuple(seed_rows)
        self._config = config or TransportConfig()
        self._endpoints: Dict[str, TpuSimTransport] = {}
        self._codec = PickleMetadataCodec()
        # bridge-wide gossip dedup: every proxy row a GossipRequest fans out
        # to would otherwise fold the same rumor again (bounded LRU)
        self._seen_gossip: "OrderedDict[str, bool]" = OrderedDict()
        self._seq = 0
        self._lock = threading.Lock()

    # -- endpoint factory ---------------------------------------------------
    def transport(
        self, name: Optional[str] = None, config: Optional[TransportConfig] = None
    ) -> "TpuSimTransport":
        """Create an (unstarted) endpoint; ``Cluster.start`` will start it."""
        with self._lock:
            if name is None:
                name = f"node-{self._seq}"
                self._seq += 1
            if name in self._endpoints and not self._endpoints[name].is_stopped:
                raise BridgeError(f"bridged endpoint {name!r} already attached")
        return TpuSimTransport(self, name, config or self._config)

    def transport_factory(
        self, name: Optional[str] = None
    ) -> Callable[[], "TpuSimTransport"]:
        """Zero-arg factory for ``Cluster.transport_factory(...)`` injection."""
        return lambda: self.transport(name)

    def set_default(self) -> None:
        """Make this bridge the target of the registered ``"tpusim"``
        transport factory, so a plain ``ClusterConfig`` with
        ``transport_factory="tpusim"`` resolves here like the tcp/websocket
        siblings resolve from their registries."""
        SimBridge._default = self

    # -- attach / detach (called by the endpoint lifecycle) ------------------
    def _attach(self, ep: "TpuSimTransport") -> None:
        row = self._d.join(self._seed_rows)
        ep.row = row
        ep._left = False
        ep._folded_inc = -1
        self._endpoints[ep.name] = ep
        # the endpoint IS the row's transport: sim-side user messaging to
        # this row (SimTransport.send peer lookup) reaches the real process
        self._d._transports[row] = ep
        if ep._identity is not None:
            # re-join after heal: the sim-side handle keeps the REAL identity
            self._d.members[row] = ep._identity
        stream = self._d.watch(row)
        ep._watch_unsub = stream.subscribe(
            lambda ev, _ep=ep: self._on_sim_event(_ep, ev)
        )

    def _detach(self, ep: "TpuSimTransport", crash: bool) -> None:
        if ep._watch_unsub is not None:
            ep._watch_unsub()
            ep._watch_unsub = None
        if ep.row is not None:
            if self._d._transports.get(ep.row) is ep:
                del self._d._transports[ep.row]
            if crash and not ep._left and self._d.is_up(ep.row):
                self._d.crash(ep.row)
        self._endpoints.pop(ep.name, None)

    # -- link chaos (the reconnect/backoff surface) --------------------------
    def link_up(self, ep: "TpuSimTransport") -> bool:
        return ep._link_up

    def fail_link(self, ep: "TpuSimTransport") -> None:
        """Sever a bridged process from the mesh mid-window: its sends start
        backing off, its window folds stop, and its row is crashed (the host
        mutation the next window realizes — to the sim it died)."""
        if not ep._link_up:
            return
        ep._link_up = False
        ep._emit_event("connection_lost", ep.address)
        if ep.row is not None and not ep._left and self._d.is_up(ep.row):
            self._d.crash(ep.row)

    def heal_link(self, ep: "TpuSimTransport") -> None:
        """Restore the link: the process re-joins on a fresh row (a restart
        is a new sim-side occupancy — the reference's rejoin-after-restart)
        and is handed the forced initial SYNC so its table catches up."""
        if ep._link_up:
            return
        if ep._watch_unsub is not None:
            ep._watch_unsub()
            ep._watch_unsub = None
        if ep.row is not None and self._d._transports.get(ep.row) is ep:
            del self._d._transports[ep.row]
        ep._link_up = True
        self._attach(ep)
        ep._emit_event("reconnected", ep.address)
        self.force_sync(ep)

    def force_sync(self, ep: "TpuSimTransport") -> None:
        """Push a full-table SYNC (seed row's view) into the endpoint — the
        same forced initial SYNC a fresh ``Cluster.start`` performs, minus
        the round trip."""
        records = self._sync_records(self._seed_rows[0], exclude=ep.address)
        msg = Message.with_data(
            SyncData(records),
            qualifier=Q_MEMBERSHIP_SYNC,
            sender=row_address(ep.row),
        )
        ep._deliver(msg)

    # -- real -> sim: routing ------------------------------------------------
    def deliver(self, src: "TpuSimTransport", address: str, message: Message) -> None:
        stamped = message.with_header(HEADER_SENDER, src.address)
        if address.startswith(BRIDGE_SCHEME):
            peer = self._endpoints.get(address[len(BRIDGE_SCHEME):])
            if (
                peer is None
                or peer.is_stopped
                or not peer._link_up
                or peer.row is None
                or not self._d.is_up(peer.row)
            ):
                return  # fire-and-forget drop, like a lost datagram
            peer._deliver(stamped)
        elif address.startswith("sim://"):
            self._proxy(src, _parse_sim_row(address), stamped)
        else:
            raise TransportError(f"not a bridged address: {address}")

    # -- real -> sim: the proxy plane ---------------------------------------
    def _proxy(self, src: "TpuSimTransport", row: int, msg: Message) -> None:
        q = msg.qualifier
        if q == Q_PING:
            self._on_ping(src, row, msg)
        elif q == Q_PING_REQ:
            self._on_ping_req(src, row, msg)
        elif q == Q_MEMBERSHIP_SYNC:
            self._on_sync(src, row, msg)
        elif q == Q_MEMBERSHIP_SYNC_ACK:
            self._fold_records(src, msg.data.membership)
        elif q == Q_METADATA_REQ:
            self._on_metadata(src, row, msg)
        elif q == Q_GOSSIP_REQ:
            self._on_gossip(src, row, msg)
        # anything else (user messages to a plain sim row) is consumed by the
        # simulated member — which has no user-level handler — silently, the
        # same as SimTransport delivery to a row nobody listens on.

    def _reply(self, src: "TpuSimTransport", row: int, msg: Message,
               reply: Message) -> None:
        reply = reply.with_header(HEADER_SENDER, row_address(row))
        if msg.correlation_id is not None:
            reply = reply.with_header(HEADER_CORRELATION_ID, msg.correlation_id)
        src._deliver(reply)

    def _on_ping(self, src: "TpuSimTransport", row: int, msg: Message) -> None:
        if not self._d.is_up(row):
            return  # silence -> caller's timeout -> SUSPECT
        data: PingData = msg.data
        occupant = self._d._member_handle(row)
        ack_type = (
            AckType.DEST_OK if occupant.id == data.to_member.id
            else AckType.DEST_GONE
        )
        self._reply(src, row, msg, Message.with_data(
            data.with_ack_type(ack_type), qualifier=Q_PING_ACK,
        ))

    def _on_ping_req(self, src: "TpuSimTransport", row: int, msg: Message) -> None:
        if not self._d.is_up(row):
            return  # the relay itself is down
        data: PingData = msg.data
        # the proxy relay short-circuits the transit PING: the target's
        # reachability is host-visible truth, so answer what the reference
        # relay would have forwarded (FailureDetectorImpl.onPingReq /
        # onTransitPingAck:330-360)
        verdict = self._member_reachable(data.to_member)
        if verdict is None:
            return  # target silent -> issuer times out -> SUSPECT
        plain = PingData(data.from_member, data.to_member, ack_type=verdict)
        self._reply(src, row, msg, Message.with_data(plain, qualifier=Q_PING_ACK))

    def _member_reachable(self, member: Member) -> Optional[AckType]:
        """None = silence; DEST_OK / DEST_GONE mirror the reference acks."""
        addr = member.address
        if addr.startswith("sim://"):
            row = _parse_sim_row(addr)
            if not self._d.is_up(row):
                return None
            occupant = self._d._member_handle(row)
            return AckType.DEST_OK if occupant.id == member.id else AckType.DEST_GONE
        if addr.startswith(BRIDGE_SCHEME):
            ep = self._endpoints.get(addr[len(BRIDGE_SCHEME):])
            if ep is None or ep.is_stopped or not ep._link_up:
                return None
            ident = ep._identity
            if ident is not None and ident.id != member.id:
                return AckType.DEST_GONE
            return AckType.DEST_OK
        return None

    def _on_sync(self, src: "TpuSimTransport", row: int, msg: Message) -> None:
        # fold FIRST: the initial SYNC is where the endpoint's real identity
        # is adopted, and the reply below must already carry it
        self._fold_records(src, msg.data.membership)
        if not self._d.is_up(row):
            return
        records = self._sync_records(row)
        self._reply(src, row, msg, Message.with_data(
            SyncData(records), qualifier=Q_MEMBERSHIP_SYNC_ACK,
        ))

    def _on_metadata(self, src: "TpuSimTransport", row: int, msg: Message) -> None:
        if not self._d.is_up(row):
            return
        request: GetMetadataRequest = msg.data
        occupant = self._d._member_handle(row)
        if request.member.id != occupant.id:
            return  # reference answers only for its own id
        blob = self._codec.serialize({"sim_row": row, "member": occupant.id})
        self._reply(src, row, msg, Message.with_data(
            GetMetadataResponse(occupant, blob), qualifier=Q_METADATA_RESP,
        ))

    def _on_gossip(self, src: "TpuSimTransport", row: int, msg: Message) -> None:
        if not self._d.is_up(row) or src.row is None:
            return
        for g in msg.data.gossips:
            if g.gossip_id in self._seen_gossip:
                continue
            self._seen_gossip[g.gossip_id] = True
            while len(self._seen_gossip) > 4096:
                self._seen_gossip.popitem(last=False)
            inner: Message = g.message
            if inner.qualifier == Q_MEMBERSHIP_GOSSIP:
                self._fold_records(src, [inner.data])
            elif self._d.is_up(src.row):
                # user gossip enters the simulated rumor plane at the
                # bridged row — the same spreadGossip seam scripted chaos uses
                self._d.spread_rumor(src.row, inner)

    # -- folding real-member state into the sim ------------------------------
    def _fold_records(self, src: "TpuSimTransport",
                      records: List[MembershipRecord]) -> None:
        """Fold the SENDER's own record into the driver. Records about sim
        members echo the sim's own state back (ignored — the device planes
        are authoritative), and records about OTHER bridged members are
        ignored too: bridged liveness is authored by the bridge link state,
        not by third-party gossip (SERVING.md § deviations)."""
        if src.row is None:
            return
        for rec in records:
            if rec.member.address != src.address:
                continue
            if src._identity is None or src._identity.id != rec.member.id:
                src._identity = rec.member
                self._d.members[src.row] = rec.member
            if rec.is_leaving and not src._left:
                src._left = True
                self._d.leave(src.row)
            elif rec.incarnation > src._folded_inc >= 0 and not src._left:
                # incarnation bump (refutation / metadata update) becomes a
                # sim-side inc bump so the mega-membership re-disseminates it
                self._d.update_metadata(src.row)
            src._folded_inc = max(src._folded_inc, rec.incarnation)

    # -- sim view -> records -------------------------------------------------
    def _sync_records(self, row: int, exclude: Optional[str] = None
                      ) -> List[MembershipRecord]:
        """Synthesize a full SyncData table from ``view_of(row)`` — one
        coalesced readback, same cost class as a /metrics scrape."""
        status, inc = self._d.view_of(row)
        records: List[MembershipRecord] = []
        # live-ish records only (reference SYNC tables drop DEAD); status can
        # also be the kernel's UNKNOWN sentinel (> DEAD) for forgotten rows
        for j in np.nonzero((status >= 0) & (status < MemberStatus.DEAD))[0]:
            j = int(j)
            st = MemberStatus(int(status[j]))
            member = self._d._member_handle(j)
            if exclude is not None and member.address == exclude:
                continue
            records.append(MembershipRecord(member, st, int(inc[j])))
        return records

    # -- sim -> real: window-boundary fold -----------------------------------
    def _on_sim_event(self, ep: "TpuSimTransport", ev) -> None:
        """Runs inside the driver step (possibly another thread, driver lock
        held): never touch the driver here — just stage the event and poke
        the endpoint's loop once per burst."""
        if not ep._link_up or ep.is_stopped:
            return
        if ev.member.address == ep.address:
            return  # the endpoint's own row: the real process owns its record
        ep._pending_events.append(ev)
        if ep._loop is not None and not ep._flush_scheduled:
            ep._flush_scheduled = True
            try:
                ep._loop.call_soon_threadsafe(self._flush_events, ep)
            except RuntimeError:
                ep._flush_scheduled = False  # loop closed mid-shutdown

    def _flush_events(self, ep: "TpuSimTransport") -> None:
        ep._flush_scheduled = False
        pending, ep._pending_events = ep._pending_events, []
        if not pending or ep.is_stopped or not ep._link_up or ep.row is None:
            return
        watch = self._d._watches.get(ep.row)
        key = watch.prev_key if watch is not None else None
        records: "OrderedDict[str, MembershipRecord]" = OrderedDict()
        for ev in pending:
            rec = self._event_record(ev, key)
            if rec is not None:
                records[rec.member.id] = rec  # last write per member wins
        if not records:
            return
        # ONE SyncData per window burst: merged by the ordinary serial
        # _sync_membership path, whose per-record fetch_metadata gate and
        # overrides lattice do the rest
        msg = Message.with_data(
            SyncData(list(records.values())),
            qualifier=Q_MEMBERSHIP_SYNC,
            sender=row_address(ep.row),
        )
        ep._deliver(msg)

    def _event_record(self, ev, key) -> Optional[MembershipRecord]:
        """Record for a watch event, status + incarnation lifted from the
        post-window key snapshot (no extra device readback)."""
        if ev.is_removed:
            return MembershipRecord(ev.member, MemberStatus.DEAD, 0)
        addr = ev.member.address
        if addr.startswith("sim://"):
            row = _parse_sim_row(addr)
        elif addr.startswith(BRIDGE_SCHEME):
            peer = self._endpoints.get(addr[len(BRIDGE_SCHEME):])
            if peer is None or peer.row is None:
                return None
            row = peer.row
        else:
            return None
        if key is None or row >= len(key):
            return None
        k = int(key[row])
        st = _status_of_key(k)
        if st not in (
            MemberStatus.ALIVE, MemberStatus.SUSPECT, MemberStatus.LEAVING,
        ):
            return MembershipRecord(ev.member, _GONE, 0)
        inc = (k >> 2) & self._d._lay.inc_mask
        return MembershipRecord(ev.member, MemberStatus(st), int(inc))


class TpuSimTransport(Transport):
    """One real process's endpoint on the bridge (``tpusim://<name>``).

    Same 4-method contract as the tcp/websocket siblings, including their
    bounded reconnect/backoff envelope: while the bridge link is severed,
    ``send`` retries with exponential backoff + jitter up to
    ``config.reconnect_max_retries``, emitting ``reconnect_backoff`` /
    ``reconnect_giveup`` on :meth:`transport_events` exactly like
    ``stream_base`` — churn monitoring sees bridge give-ups without
    scraping logs.
    """

    def __init__(self, bridge: SimBridge, name: str,
                 config: Optional[TransportConfig] = None) -> None:
        self._bridge = bridge
        self.name = name
        self._config = config or TransportConfig()
        self._listeners = Listeners()
        self._events: Listeners = Listeners()
        # fresh endpoints are NOT stopped (Cluster.start refuses a stopped
        # injected transport); "unstarted" is signaled by the address probe
        self._stopped = False
        self._started = False
        self.row: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._link_up = True
        self._identity: Optional[Member] = None
        self._folded_inc = -1
        self._left = False
        self._watch_unsub: Optional[Callable[[], None]] = None
        self._pending_events: list = []
        self._flush_scheduled = False

    # -- Transport contract --------------------------------------------------
    @property
    def address(self) -> str:
        if not self._started:
            raise TransportError("transport is not started")
        return f"{BRIDGE_SCHEME}{self.name}"

    @property
    def is_stopped(self) -> bool:
        return self._stopped

    async def start(self) -> "TpuSimTransport":
        if self._started and not self._stopped:
            return self
        self._loop = asyncio.get_running_loop()
        self._bridge._attach(self)
        self._started = True
        self._stopped = False
        self._link_up = True
        return self

    async def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        # graceful LEAVING was folded already (if the cluster left); an
        # abrupt stop crashes the row — to the sim the process died
        self._bridge._detach(self, crash=True)

    def listen(self) -> Listeners:
        return self._listeners

    def transport_events(self) -> Listeners:
        return self._events

    async def send(self, address: str, message: Message) -> None:
        if self._stopped:
            raise TransportError("transport is stopped")
        attempt = 0
        while True:
            if self._bridge.link_up(self):
                self._bridge.deliver(self, address, message)
                return
            attempt += 1
            if self._stopped or attempt > self._config.reconnect_max_retries:
                self._emit_event(
                    "reconnect_giveup", address, attempts=attempt,
                    error="bridge link down",
                )
                raise PeerUnavailableError(
                    f"send to {address} failed after {attempt} attempt(s): "
                    "bridge link down"
                )
            delay = self._backoff_delay(attempt)
            self._emit_event(
                "reconnect_backoff", address, attempts=attempt, delay=delay,
            )
            await asyncio.sleep(delay)

    # -- internals -----------------------------------------------------------
    def _backoff_delay(self, attempt: int) -> float:
        base = self._config.reconnect_base_delay * (2 ** (attempt - 1))
        return min(base, self._config.reconnect_max_delay) * (
            0.5 + random.random()
        )

    def _emit_event(self, kind: str, address: str, **fields) -> None:
        self._events.emit(TransportEvent(kind=kind, address=address, **fields))

    def _deliver(self, message: Message) -> None:
        """Inject a message into this endpoint's listen stream on its loop
        (thread-safe: window folds may originate in a stepping thread)."""
        if self._stopped or self._loop is None:
            return
        try:
            if self._loop is _running_loop():
                self._loop.call_soon(self._listeners.emit, message)
            else:
                self._loop.call_soon_threadsafe(self._listeners.emit, message)
        except RuntimeError:
            pass  # loop closed during shutdown


def _running_loop() -> Optional[asyncio.AbstractEventLoop]:
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        return None


def _tpusim_factory(config: TransportConfig) -> TpuSimTransport:
    bridge = SimBridge._default
    if bridge is None:
        raise TransportError(
            "transport_factory='tpusim' needs a default bridge: build a "
            "SimBridge(driver) and call bridge.set_default() first (or "
            "inject with Cluster.transport_factory(bridge.transport_factory()))"
        )
    return bridge.transport(config=config)


register_transport_factory("tpusim", _tpusim_factory)
