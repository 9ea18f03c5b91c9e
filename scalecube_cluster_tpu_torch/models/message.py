"""Message model: qualifier-routed headers + opaque payload.

Parity with reference ``Message`` (transport-api ``Message.java:19-230``):
reserved headers ``qualifier`` (``q``), ``correlation_id`` (``cid``) and
``sender`` with the same routing semantics (every protocol component filters
``listen()`` by qualifier; request/response correlates on ``cid``).

The wire form is codec-pluggable (see ``transport/codecs.py``). For the
simulated path messages are packed columnar (qualifier -> int enum, payload ->
fixed-width tensor slots) by ``sim/sim_transport.py``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional

# Reserved header names (reference Message.java:27-39).
HEADER_QUALIFIER = "q"
HEADER_CORRELATION_ID = "cid"
HEADER_SENDER = "sender"

# Protocol qualifiers (reference FailureDetectorImpl.java:35-37,
# GossipProtocolImpl.java:38, MembershipProtocolImpl.java:68-70,
# MetadataStoreImpl.java:28-29).
Q_PING = "sc/fdetector/ping"
Q_PING_REQ = "sc/fdetector/pingReq"
Q_PING_ACK = "sc/fdetector/pingAck"
Q_GOSSIP_REQ = "sc/gossip/req"
Q_MEMBERSHIP_SYNC = "sc/membership/sync"
Q_MEMBERSHIP_SYNC_ACK = "sc/membership/syncAck"
Q_MEMBERSHIP_GOSSIP = "sc/membership/gossip"
Q_METADATA_REQ = "sc/metadata/req"
Q_METADATA_RESP = "sc/metadata/resp"

#: Qualifiers hidden from user-level ``listen()`` (reference
#: ClusterImpl.SYSTEM_MESSAGES, ClusterImpl.java:62-76).
SYSTEM_QUALIFIERS = frozenset(
    {
        Q_PING,
        Q_PING_REQ,
        Q_PING_ACK,
        Q_GOSSIP_REQ,
        Q_MEMBERSHIP_SYNC,
        Q_MEMBERSHIP_SYNC_ACK,
        Q_METADATA_REQ,
        Q_METADATA_RESP,
    }
)

#: Gossip qualifiers hidden from user gossip listeners (ClusterImpl.java:386-389).
SYSTEM_GOSSIP_QUALIFIERS = frozenset({Q_MEMBERSHIP_GOSSIP})

_cid_counter = itertools.count()


def new_correlation_id(prefix: str = "") -> str:
    """Monotone correlation id (reference CorrelationIdGenerator.java:6)."""
    return f"{prefix}-{next(_cid_counter):x}" if prefix else f"{next(_cid_counter):x}"


@dataclass(frozen=True)
class Message:
    """Immutable header-map + data message.

    ``data`` is an arbitrary (codec-serializable) payload. Use
    :meth:`with_data` / builder-style ``replace`` helpers to derive messages.
    """

    headers: Dict[str, str] = field(default_factory=dict)
    data: Any = None

    # -- builders ----------------------------------------------------------
    @staticmethod
    def with_data(data: Any, qualifier: Optional[str] = None, **headers: str) -> "Message":
        hdrs = dict(headers)
        if qualifier is not None:
            hdrs[HEADER_QUALIFIER] = qualifier
        return Message(headers=hdrs, data=data)

    @staticmethod
    def from_message(msg: "Message", **overrides: Any) -> "Message":
        return replace(msg, **overrides)

    def with_header(self, name: str, value: str) -> "Message":
        hdrs = dict(self.headers)
        hdrs[name] = value
        return Message(headers=hdrs, data=self.data)

    # -- reserved header accessors ----------------------------------------
    @property
    def qualifier(self) -> Optional[str]:
        return self.headers.get(HEADER_QUALIFIER)

    @property
    def correlation_id(self) -> Optional[str]:
        return self.headers.get(HEADER_CORRELATION_ID)

    @property
    def sender(self) -> Optional[str]:
        return self.headers.get(HEADER_SENDER)

    def header(self, name: str) -> Optional[str]:
        return self.headers.get(name)

    def __str__(self) -> str:
        return f"Message(q={self.qualifier}, cid={self.correlation_id}, data={self.data!r})"
