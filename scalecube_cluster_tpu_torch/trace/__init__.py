"""The causal trace plane in the PyTorch port: on-device protocol span
capture, tick-phase profiling, and Perfetto/OTel export for the three
engines. A port of the JAX package's ``trace/`` package.

The import surface is kept light: the engine ticks import :mod:`.capture`
when a trace is armed, so this ``__init__`` does not load the
driver-facing modules (plane, profile); :class:`TracePlane` loads lazily.

* :mod:`.schema`  — ``TraceSpec``, the ring record layout, host decode
  (a copy of the JAX module).
* :mod:`.capture` — the per-tick [K, F] record builder the engines call.
* :mod:`.rings`   — the device trace ring (host cursor).
* :mod:`.spans`   — records sewn into detection lineages and rumor trees
  (a copy).
* :mod:`.export`  — Chrome-trace/Perfetto JSON and OTel-style span dicts
  (a copy).
* :mod:`.plane`   — ``TracePlane``: the armed state of one driver.
* :mod:`.profile` — the phase-split window profiler.
"""

from .schema import TraceSpec, decode_record, decode_records

__all__ = [
    "TraceSpec",
    "decode_record",
    "decode_records",
    "TracePlane",
]


def __getattr__(name):
    if name == "TracePlane":
        from .plane import TracePlane

        return TracePlane
    raise AttributeError(name)
