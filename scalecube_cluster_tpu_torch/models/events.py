"""Cluster event model.

Parity with reference ``MembershipEvent`` (cluster-api
``MembershipEvent.java:13-91``: ADDED/REMOVED/LEAVING/UPDATED with old/new
metadata and timestamp) and ``FailureDetectorEvent``
(``fdetector/FailureDetectorEvent.java:8``).

A copy of the JAX package's ``models/events.py`` (which imports no JAX): the
port keeps its own, so it imports nothing of that package.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Optional

from .member import Member, MemberStatus


class MembershipEventType(enum.Enum):
    ADDED = "added"
    REMOVED = "removed"
    LEAVING = "leaving"
    UPDATED = "updated"


@dataclass(frozen=True)
class MembershipEvent:
    """Membership change notification with optional old/new metadata blobs."""

    type: MembershipEventType
    member: Member
    old_metadata: Optional[bytes] = None
    new_metadata: Optional[bytes] = None
    timestamp: float = field(default_factory=time.time)

    # -- factories (reference MembershipEvent.java:42-78) ------------------
    @staticmethod
    def added(member: Member, metadata: Optional[bytes] = None, ts: Optional[float] = None) -> "MembershipEvent":
        return MembershipEvent(
            MembershipEventType.ADDED, member, None, metadata,
            ts if ts is not None else time.time(),
        )

    @staticmethod
    def removed(member: Member, metadata: Optional[bytes] = None, ts: Optional[float] = None) -> "MembershipEvent":
        return MembershipEvent(
            MembershipEventType.REMOVED, member, metadata, None,
            ts if ts is not None else time.time(),
        )

    @staticmethod
    def leaving(member: Member, metadata: Optional[bytes] = None, ts: Optional[float] = None) -> "MembershipEvent":
        return MembershipEvent(
            MembershipEventType.LEAVING, member, metadata, metadata,
            ts if ts is not None else time.time(),
        )

    @staticmethod
    def updated(member: Member, old_metadata: Optional[bytes], new_metadata: Optional[bytes],
                ts: Optional[float] = None) -> "MembershipEvent":
        return MembershipEvent(
            MembershipEventType.UPDATED, member, old_metadata, new_metadata,
            ts if ts is not None else time.time(),
        )

    # -- predicates --------------------------------------------------------
    @property
    def is_added(self) -> bool:
        return self.type is MembershipEventType.ADDED

    @property
    def is_removed(self) -> bool:
        return self.type is MembershipEventType.REMOVED

    @property
    def is_leaving(self) -> bool:
        return self.type is MembershipEventType.LEAVING

    @property
    def is_updated(self) -> bool:
        return self.type is MembershipEventType.UPDATED

    def __str__(self) -> str:
        return f"MembershipEvent({self.type.value}, {self.member})"


@dataclass(frozen=True)
class FailureDetectorEvent:
    """Per-probe verdict emitted by the failure detector toward membership.

    ``period`` is the FD round that produced the verdict (an indirect probe
    publishes one verdict per relay path, all for the same period — group by
    it to reason about whole rounds)."""

    member: Member
    status: MemberStatus
    period: Optional[int] = None

    def __str__(self) -> str:
        return f"FailureDetectorEvent({self.member}, {self.status.name})"
