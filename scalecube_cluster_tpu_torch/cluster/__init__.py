from .cluster import Cluster, ClusterMessageHandler, SenderAwareTransport, new_cluster
from .failure_detector import AckType, FailureDetector, PingData
from .gossip import Gossip, GossipProtocol, GossipRequest, GossipState
from .membership import MembershipProtocol, MembershipUpdateReason, SyncData
from .metadata import GetMetadataRequest, GetMetadataResponse, MetadataStore

__all__ = [
    "Cluster",
    "ClusterMessageHandler",
    "SenderAwareTransport",
    "new_cluster",
    "FailureDetector",
    "PingData",
    "AckType",
    "GossipProtocol",
    "Gossip",
    "GossipState",
    "GossipRequest",
    "MembershipProtocol",
    "MembershipUpdateReason",
    "SyncData",
    "MetadataStore",
    "GetMetadataRequest",
    "GetMetadataResponse",
]
