"""scalecube_cluster_tpu_torch — the SWIM tick engines in PyTorch and CUDA.

The PyTorch/CUDA counterpart of the JAX package ``scalecube_cluster_tpu``,
module for module (``ops/lattice.py``, ``ops/rand.py``, ``ops/bitplane.py``,
``ops/pview.py``, ``sim/driver.py``, ...). It imports ``torch`` and numpy
only: nothing of JAX and nothing of the JAX package, whose semantics it
copies and is held against bit for bit by ``tests/test_torch_*.py``.

The engines: dense (every member's full [N, N] view, :mod:`.ops.kernel`,
with its link-delay rings), sparse ("record-queue", :mod:`.ops.sparse`)
and partial-view ("pview", :mod:`.ops.pview`, to a million members on one
card), each the JAX package's fused tick, which gives the same state as
its unfused one, with the sparse and pview gossip delivery combine as a
hand-written CUDA kernel (``csrc/delivery_combine.cu``, bound in
:mod:`.ops.delivery`). Over them: the dissemination strategies and their
certifier (:mod:`.dissemination`), the adaptive failure-detection plane
(:mod:`.adaptive`), the chaos scenarios and sentinels (:mod:`.chaos`), the
fleet engine (:mod:`.ops.fleet`), the telemetry, trace, control and replay
planes, :class:`.sim.SimDriver` / :class:`.sim.SimCluster`, the serving
path (:mod:`.cluster`, :mod:`.transport`, :mod:`.bridge`, :mod:`.monitor`)
and the program audit (:mod:`.audit`). The member mesh
(:mod:`.ops.sharding`, :mod:`.ops.dcn`) runs the pview engine (its fleet
on a scenarios x members mesh too) and the dense engine over a process
group; the sparse engine runs on one device.
Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the host.

The public names are the JAX package's, one for one.
"""

from .compile_cache import (
    compile_cache_report,
    enable_persistent_compile_cache,
)
from .config import (
    ChaosConfig,
    ClusterConfig,
    ControlConfig,
    DisseminationConfig,
    FailureDetectorConfig,
    GossipConfig,
    MembershipConfig,
    SimConfig,
    TelemetryConfig,
    TraceConfig,
    TransportConfig,
)
from .models.events import FailureDetectorEvent, MembershipEvent, MembershipEventType
from .models.member import Member, MemberStatus, new_member_id
from .models.message import Message
from .models.record import MembershipRecord
from .version import __version__

__all__ = [
    "ChaosConfig",
    "ClusterConfig",
    "ControlConfig",
    "DisseminationConfig",
    "FailureDetectorConfig",
    "GossipConfig",
    "MembershipConfig",
    "TransportConfig",
    "SimConfig",
    "TelemetryConfig",
    "TraceConfig",
    "Member",
    "MemberStatus",
    "MembershipRecord",
    "MembershipEvent",
    "MembershipEventType",
    "FailureDetectorEvent",
    "Message",
    "new_member_id",
    "enable_persistent_compile_cache",
    "compile_cache_report",
    "__version__",
]
