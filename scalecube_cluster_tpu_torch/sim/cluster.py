"""Cluster-facade-shaped handles over simulated members.

A port of the JAX package's ``sim/cluster.py``: ``SimCluster`` drives the
members of one :class:`.SimDriver` from one object, and ``SimNode`` mirrors
the reference ``Cluster`` surface (member/members/otherMembers/
member(id|addr)/updateMetadata/spreadGossip/listenMembership/shutdown) for
one row. Messaging (``send``/``request_response``) is provided by
:class:`.transport.SimTransport`, reachable via :meth:`SimNode.transport`.
"""

from __future__ import annotations

from typing import List, Optional

from ..models.events import MembershipEvent
from ..models.member import Member, MemberStatus
from ..ops.lattice import ALIVE, LEAVING, SUSPECT
from ..utils.streams import EventStream
from .driver import SimDriver, row_address


class SimNode:
    """One simulated member, presented through the Cluster facade surface."""

    def __init__(self, driver: SimDriver, row: int):
        self._d = driver
        self.row = row

    # -- identity -----------------------------------------------------------
    @property
    def member(self) -> Member:
        return self._d._member_handle(self.row)

    @property
    def address(self) -> str:
        return row_address(self.row)

    # -- membership views (reference Cluster.members/otherMembers) ----------
    def members(self) -> List[Member]:
        status, _ = self._d.view_of(self.row)
        return [
            self._d._member_handle(int(j))
            for j in range(len(status))
            if status[j] in (ALIVE, SUSPECT, LEAVING)
        ]

    def other_members(self) -> List[Member]:
        return [m for m in self.members() if m.id != self.member.id]

    def member_by_id(self, member_id: str) -> Optional[Member]:
        return next((m for m in self.members() if m.id == member_id), None)

    def member_by_address(self, address: str) -> Optional[Member]:
        return next((m for m in self.members() if m.address == address), None)

    def status_of(self, other: "SimNode | int") -> Optional[MemberStatus]:
        row = other.row if isinstance(other, SimNode) else other
        return self._d.status_of(self.row, row)

    # -- metadata -----------------------------------------------------------
    def update_metadata(self) -> None:
        """Bump + re-announce (peers observe an UPDATED event)."""
        self._d.update_metadata(self.row)

    def incarnation_of(self, other: "SimNode | int") -> int:
        row = other.row if isinstance(other, SimNode) else other
        key = int(self._d._eng.view_row(self._d.state, self.row)[row])
        # the layout follows the driver's key dtype (narrow i16 keys decode
        # with the narrow incarnation mask)
        return (key >> 2) & self._d._lay.inc_mask if key >= 0 else 0

    # -- gossip -------------------------------------------------------------
    def spread_gossip(self, payload: object) -> int:
        """Start a rumor from this node; returns the rumor slot (track
        coverage via ``SimCluster.rumor_coverage``)."""
        return self._d.spread_rumor(self.row, payload)

    # -- events -------------------------------------------------------------
    def listen_membership(self) -> EventStream:
        return self._d.watch(self.row)

    def membership_events(self) -> List[MembershipEvent]:
        return self._d.events_of(self.row)

    # -- messaging ----------------------------------------------------------
    def transport(self):
        """The 4-method Transport SPI bound to this row (lazy singleton)."""
        from .transport import SimTransport

        if self.row not in self._d._transports:
            self._d._transports[self.row] = SimTransport(self._d, self.row)
        return self._d._transports[self.row]

    # -- lifecycle ----------------------------------------------------------
    @property
    def is_up(self) -> bool:
        return self._d.is_up(self.row)

    def leave(self, crash_after_ticks: int = 2) -> None:
        """Graceful shutdown: LEAVING gossip, then stop (reference
        doShutdown: LEAVING → dispose → stop transport)."""
        self._d.leave(self.row, crash_after_ticks=crash_after_ticks)

    def crash(self) -> None:
        self._d.crash(self.row)


class SimCluster:
    """All simulated members of one driver, plus cluster-level helpers."""

    def __init__(self, driver: SimDriver):
        self.driver = driver

    def node(self, row: int) -> SimNode:
        return SimNode(self.driver, row)

    def nodes(self) -> List[SimNode]:
        up = self.driver.state.up.cpu().numpy()
        return [SimNode(self.driver, int(r)) for r in up.nonzero()[0]]

    def join(self, seed_rows=(0,)) -> SimNode:
        return SimNode(self.driver, self.driver.join(seed_rows))

    def step(self, n_ticks: int = 1) -> dict:
        return self.driver.step(n_ticks)

    def rumor_coverage(self, slot: int) -> float:
        return self.driver.rumor_coverage(slot)
