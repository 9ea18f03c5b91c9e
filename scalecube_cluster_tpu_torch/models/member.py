"""Member identity and status model.

Capability parity with the reference's ``Member`` (cluster-api
``io/scalecube/cluster/Member.java:16``) and ``MemberStatus``
(``cluster/membership/MemberStatus.java:3-18``): a member is identified by
``(id, address, namespace)``; ``alias`` is display-only and excluded from
equality, exactly as the reference excludes it (``Member.java:88-102``).

In simulation mode members are integer rows of state tensors; ``Member`` is
the host-side handle with an ``id <-> row`` mapping kept by the sim bridge.

A copy of the JAX package's ``models/member.py`` (which imports no JAX): the
port keeps its own, so it imports nothing of that package.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from typing import Optional


class MemberStatus(enum.IntEnum):
    """Lifecycle states of a member in the SWIM state machine.

    Integer codes are the on-device encoding used by the vectorized kernel
    (``ops/lattice.py``); the ordering is chosen so DEAD is the lattice top.
    """

    ALIVE = 0
    SUSPECT = 1
    LEAVING = 2
    DEAD = 3


def new_member_id() -> str:
    """Default member-id generator (UUID4 string, reference ClusterConfig.java:36)."""
    return str(uuid.uuid4())


@dataclass(frozen=True)
class Member:
    """Cluster member: id + optional alias + address + namespace.

    Equality and hashing use ``(id, address, namespace)`` only — the alias is
    cosmetic (reference ``Member.java:88-111``).
    """

    id: str
    address: str
    namespace: str = "default"
    alias: Optional[str] = field(default=None, compare=False)

    def __post_init__(self) -> None:
        if not self.id:
            raise ValueError("member id must be non-empty")
        if not self.address:
            raise ValueError("member address must be non-empty")
        if not self.namespace:
            raise ValueError("member namespace must be non-empty")

    def __str__(self) -> str:
        name = self.alias if self.alias is not None else self.id
        return f"{self.namespace}:{name}@{self.address}"
