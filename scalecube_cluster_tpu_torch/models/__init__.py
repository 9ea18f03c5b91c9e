from .events import FailureDetectorEvent, MembershipEvent, MembershipEventType
from .member import Member, MemberStatus, new_member_id
from .message import Message
from .record import MembershipRecord

__all__ = [
    "Member",
    "MemberStatus",
    "MembershipRecord",
    "MembershipEvent",
    "MembershipEventType",
    "FailureDetectorEvent",
    "Message",
    "new_member_id",
]
