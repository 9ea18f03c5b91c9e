"""Membership record + the precedence ("overrides") lattice.

Behavioral parity with reference ``MembershipRecord.isOverrides``
(``cluster/membership/MembershipRecord.java:67-90``):

* against no existing record, only ALIVE / LEAVING are accepted;
* an identical record never overrides (idempotence);
* DEAD is absorbing: nothing overrides DEAD, DEAD overrides everything else;
* otherwise higher incarnation wins;
* at equal incarnation, SUSPECT overrides ALIVE / LEAVING (and nothing else).

This scalar implementation is the oracle for the vectorized lattice join in
``ops/lattice.py`` (property tests assert elementwise agreement).
"""

from __future__ import annotations

from dataclasses import dataclass

from .member import Member, MemberStatus


@dataclass(frozen=True)
class MembershipRecord:
    """A (member, status, incarnation) triple — one row of a membership table."""

    member: Member
    status: MemberStatus
    incarnation: int = 0

    @property
    def is_alive(self) -> bool:
        return self.status == MemberStatus.ALIVE

    @property
    def is_suspect(self) -> bool:
        return self.status == MemberStatus.SUSPECT

    @property
    def is_leaving(self) -> bool:
        return self.status == MemberStatus.LEAVING

    @property
    def is_dead(self) -> bool:
        return self.status == MemberStatus.DEAD

    def overrides(self, existing: "MembershipRecord | None") -> bool:
        """True if this record should replace ``existing`` in a membership table."""
        if existing is None:
            return self.is_alive or self.is_leaving
        if existing.member.id != self.member.id:
            raise ValueError("can't compare records for different members")
        if self == existing:
            return False
        if existing.is_dead:
            return False
        if self.is_dead:
            return True
        if self.incarnation == existing.incarnation:
            return self.is_suspect and (existing.is_alive or existing.is_leaving)
        return self.incarnation > existing.incarnation

    def __str__(self) -> str:
        return f"{{m: {self.member}, s: {self.status.name}, inc: {self.incarnation}}}"


def overrides_codes(
    new_status: int, new_inc: int, old_status: int, old_inc: int
) -> bool:
    """Pure-integer form of the overrides lattice (same truth table as
    :meth:`MembershipRecord.overrides` against a present record).

    This is the exact scalar function the vectorized kernel implements; kept
    here so tests can compare kernel output against it elementwise.
    """
    dead = MemberStatus.DEAD
    suspect = MemberStatus.SUSPECT
    if new_status == old_status and new_inc == old_inc:
        return False
    if old_status == dead:
        return False
    if new_status == dead:
        return True
    if new_inc == old_inc:
        return new_status == suspect and old_status in (
            MemberStatus.ALIVE,
            MemberStatus.LEAVING,
        )
    return new_inc > old_inc
