"""Host-side driver over the simulation (a port of the JAX package's
``sim/``):

* :class:`SimDriver` — owns the device state, the window and its generator;
  id↔row mapping, per-observer membership-event extraction, churn helpers,
  metrics history, checkpoint/resume.
* :class:`SimCluster` / :class:`SimNode` — ``Cluster``-facade-shaped handles
  over individual simulated members.
* :class:`SimTransport` — the 4-method Transport SPI (send/request_response/
  listen/stop) between simulated members, honoring the sim's link-loss
  plane.
"""

from .cluster import SimCluster, SimNode
from .driver import CheckpointError, SimDriver
from .transport import SimTransport

__all__ = ["SimDriver", "SimCluster", "SimNode", "CheckpointError", "SimTransport"]
