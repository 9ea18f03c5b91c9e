"""The telemetry plane: on-device metric rings, the unified event bus, the
OpenMetrics exporter and the crash flight recorder.

Per-window time series recorded ON DEVICE with no added device-to-host
transfer (:mod:`.rings`), every discrete event (membership, chaos,
lifecycle) merged into one bounded tick-stamped stream (:mod:`.bus`),
Prometheus/OpenMetrics export (:mod:`.openmetrics`), and an atomic
post-mortem artifact when a sentinel fires (:mod:`.flight`).
``SimDriver.arm_telemetry()`` returns the armed :class:`TelemetryPlane`.

The port of the JAX package's ``telemetry/`` package; ``bus`` and
``openmetrics`` are copies of its pure-Python modules.
"""

from .bus import BusRecord, TelemetryBus
from .flight import FlightRecorderError, load_flight_dump, replay_timeline, write_flight_dump
from .openmetrics import CONTENT_TYPE, Histogram, cluster_families, driver_families, render
from .plane import SENTINEL_SERIES, TelemetryPlane
from .rings import MetricRing

__all__ = [
    "BusRecord",
    "TelemetryBus",
    "FlightRecorderError",
    "load_flight_dump",
    "replay_timeline",
    "write_flight_dump",
    "CONTENT_TYPE",
    "Histogram",
    "cluster_families",
    "driver_families",
    "render",
    "SENTINEL_SERIES",
    "TelemetryPlane",
    "MetricRing",
]
