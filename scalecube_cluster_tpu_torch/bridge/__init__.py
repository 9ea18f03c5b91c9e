"""Hybrid serving bridge (r19): real processes inside the simulated mesh.

``SimBridge`` splices real ``Cluster`` processes into a live ``SimDriver``
membership over ``TpuSimTransport`` (a registered ``"tpusim"`` sibling of
the tcp/websocket transports); ``LoadGenerator`` drives member-facing churn
and monitor scrape traffic against the hybrid. See ``docs/SERVING.md``.
"""

from .transport import BRIDGE_SCHEME, BridgeError, SimBridge, TpuSimTransport
from .loadgen import LoadGenerator, LoadReport

__all__ = [
    "BRIDGE_SCHEME",
    "BridgeError",
    "SimBridge",
    "TpuSimTransport",
    "LoadGenerator",
    "LoadReport",
]
