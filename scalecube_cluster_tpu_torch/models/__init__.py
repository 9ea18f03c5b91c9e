"""Host-side member and event models (copies of the JAX package's)."""

from .events import FailureDetectorEvent, MembershipEvent, MembershipEventType
from .member import Member, MemberStatus, new_member_id

__all__ = [
    "Member",
    "MemberStatus",
    "MembershipEvent",
    "MembershipEventType",
    "FailureDetectorEvent",
    "new_member_id",
]
