"""Host-side driver over the simulation (a port of the JAX package's
``sim/``):

* :class:`SimDriver` — owns the device state, the window and its generator;
  id↔row mapping, per-observer membership-event extraction, churn helpers,
  metrics history, checkpoint/resume.
* :class:`SimCluster` / :class:`SimNode` — ``Cluster``-facade-shaped handles
  over individual simulated members.

The sim transport (``SimTransport``) is not ported yet (ROADMAP A13).
"""

from .cluster import SimCluster, SimNode
from .driver import CheckpointError, SimDriver

__all__ = ["SimDriver", "SimCluster", "SimNode", "CheckpointError"]
