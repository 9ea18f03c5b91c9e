"""TelemetryPlane: the metric ring, the event bus, the exporter and the
flight recorder wired onto one :class:`..sim.SimDriver`.

Arming (``SimDriver.arm_telemetry``) is a pure consumer: per window the
plane folds the window's stacked metrics and the post-window state into one
f32 row (the engine's ``telemetry_window_vector`` and the armed chaos
runner's two sentinel accumulators, read from their device tensors) and
appends it to the device metric ring — tensor ops only, no device-to-host
transfer, and nothing the tick reads back. Host transfers happen only at
the explicit sync points: a ``/metrics`` scrape, :meth:`collect`, a
flight-recorder dump.

The port of the JAX package's ``telemetry/plane.py``. On a member mesh the
row is reduced from the sharded window's metrics, which every rank holds
whole, and pinned the same on every rank
(:func:`..ops.sharding.make_sharded_telemetry_row`); each rank appends it
to its own copy of the ring, and ``shard_peak_mem_mb`` is the footprint of
the rank's own rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from ..config import TelemetryConfig
from .bus import TelemetryBus
from .flight import default_dump_path, write_flight_dump
from .openmetrics import Histogram, driver_families, render
from .rings import MetricRing

#: ring columns appended after the engine series: the armed chaos runner's
#: latching sentinel accumulators, sampled per window (0 when unarmed)
SENTINEL_SERIES = ("sentinel_false_dead_max", "sentinel_key_regressions")

#: default bucket boundaries for the tick-count histograms (detection
#: latency, rumor spread) — powers of two up to a long suspicion window
TICK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def window_row(vector_fn, ms, state, false_dead, key_regr) -> torch.Tensor:
    """One window's ring row: the engine's ``vector_fn(ms, state)`` and the
    two sentinel columns, as f32."""
    sent = torch.stack([false_dead.to(torch.int32), key_regr.to(torch.int32)]).to(torch.float32)
    return torch.cat([vector_fn(ms, state), sent])


def state_footprint_mb(state) -> float:
    """Bytes of every leaf of an engine state, in MiB, from shapes and
    dtypes alone (never a device read); the host-int ``tick`` counts as the
    4-byte scalar it is in the JAX package's state."""
    total = 0
    for f in dataclasses.fields(state):
        leaf = getattr(state, f.name)
        total += leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor) else 4
    return total / (1024.0 * 1024.0)


class TelemetryPlane:
    """The armed telemetry state of one driver (``driver._telemetry``)."""

    def __init__(self, driver, config: Optional[TelemetryConfig] = None,
                 bus: Optional[TelemetryBus] = None):
        cfg = config or TelemetryConfig()
        self.config = cfg
        self.driver = driver
        eng = driver._eng
        self.names = tuple(eng.telemetry_series) + SENTINEL_SERIES
        self.ring = MetricRing(self.names, cfg.ring_len, device=driver.device)
        self.bus = bus or TelemetryBus(cfg.bus_capacity)
        self.hist_dispatch = Histogram(cfg.latency_buckets)
        self.hist_tick = Histogram(cfg.latency_buckets)
        self.hist_detection = Histogram(TICK_BUCKETS)
        self.hist_spread = Histogram(TICK_BUCKETS)
        self.flight_dumps: List[str] = []
        # one device zero for the sentinel columns of an unarmed runner (a
        # fresh scalar per window would be a host-to-device copy each time)
        self._zero = torch.zeros((), dtype=torch.int32, device=driver.device)
        vector_fn = eng.telemetry_window_vector
        if "shard_peak_mem_mb" in self.names:
            # the state's footprint, reckoned once here from shapes and
            # dtypes: a per-window value would be a host-to-device copy
            vector_fn = functools.partial(vector_fn, shard_mem_mb=state_footprint_mb(driver.state))
        self._append = MetricRing.append
        if getattr(driver, "mesh", None) is not None:
            from ..ops.sharding import make_sharded_metric_append, make_sharded_telemetry_row

            vector_fn = make_sharded_telemetry_row(driver.mesh, vector_fn)
            self._append = make_sharded_metric_append(driver.mesh)
        self._vector_fn = vector_fn

    def _row(self, ms, state, false_dead, key_regr) -> torch.Tensor:
        return window_row(self._vector_fn, ms, state, false_dead, key_regr)

    # -- the per-window device path (called under the driver lock) -----------
    def on_window(self, ms, state, n_ticks: int, dispatch_s: float) -> None:
        """Fold one window into the ring (device ops only) and the host-side
        latency histograms (wall clock only)."""
        runner = self.driver._chaos
        sent = getattr(runner, "_sent", None) if runner is not None else None
        false_dead = sent["false_dead_max"] if sent else self._zero
        key_regr = sent["key_regressions"] if sent else self._zero
        self._append(self.ring, self._row(ms, state, false_dead, key_regr))
        self.hist_dispatch.observe(dispatch_s)
        self.hist_tick.observe(dispatch_s / max(n_ticks, 1))

    # -- sync points (each ring read holds the driver lock) --------------------
    def collect(self, k: Optional[int] = None) -> dict:
        """Ring snapshot and bus stats (one device-to-host transfer)."""
        with self.driver._lock:
            snap = self.ring.snapshot(k)
        self.driver._note_readback(1)
        return {
            "ring": {
                "names": snap["names"],
                "windows": snap["windows"],
                "rows": [[float(v) for v in row] for row in snap["rows"]],
            },
            "bus": self.bus.stats(),
            "flight_dumps": list(self.flight_dumps),
        }

    def families(self) -> list:
        """This driver's OpenMetrics families — THE scrape path
        (:meth:`metrics_text` routes here)."""
        fams = driver_families(self.driver, self)
        self.driver._note_readback(1)  # the ring's newest-row read
        return fams

    def metrics_text(self) -> str:
        """The ``GET /metrics`` body — rendering IS the scrape sync point."""
        return render(self.families())

    # -- chaos ingestion -------------------------------------------------------
    def ingest_chaos_report(self, report: dict) -> Optional[str]:
        """Feed one FINAL scenario report: detection latencies into the
        histogram, the outcome onto the bus, and on any violation a
        flight-recorder dump. Returns the dump path if one was written."""
        sent = report.get("sentinels") or {}
        for det in sent.get("detections", ()):
            if det.get("detected_at") is not None:
                self.hist_detection.observe(det["detected_at"] - det["crashed_at"])
        self.bus.publish(
            "chaos", "scenario_complete", tick=self.driver._host_tick,
            scenario=report.get("scenario", "?"),
            violations=report.get("violations", 0),
            ok=report.get("ok", True),
        )
        if report.get("violations"):
            return self.flight_record(
                "sentinel_violation",
                context={
                    "scenario": report.get("scenario"),
                    "violations": report.get("violations"),
                    "sentinels": sent,
                },
            )
        return None

    # -- flight recorder -------------------------------------------------------
    def _reconstruction_section(self) -> Optional[dict]:
        """The schema-2 reconstruction block (engine, params, seed, the armed
        scenario's timeline, the verdict), written as the JAX package
        writes it; None without an armed chaos runner (the loader then marks
        the dump ``reconstruction: "partial"``)."""
        runner = getattr(self.driver, "_chaos", None)
        if runner is None:
            return None
        from ..chaos.events import scenario_to_dict
        from ..ops.sharding import mesh_axes

        d = self.driver
        last = runner.last_report
        verdict = None
        if last is not None and last.get("sentinels") is not None:
            verdict = {
                "ok": bool(last.get("ok", True)),
                "violations": int(last.get("violations", 0)),
                "ticks_run": int(last.get("ticks_run", runner.rel_tick)),
            }
        return {
            "engine": d.engine,
            "n_initial": int(d.n_initial),
            "capacity": int(d.params.capacity),
            "seed": getattr(d, "seed", None),
            "warm": bool(getattr(d, "_init_warm", True)),
            "dense_links": bool(d._dense_links),
            "params": dataclasses.asdict(d.params),
            "scenario": scenario_to_dict(runner.scenario),
            "t0": int(runner.t0),
            "max_window": int(runner.max_window),
            "ticks_run": int(runner.rel_tick),
            "sentinels_armed": runner._sent is not None,
            "verdict": verdict,
            # a sibling of params, never a field of it; replay rebuilds the
            # incident unsharded (the sharded trajectory is the unsharded one)
            "mesh_axes": None if d.mesh is None else mesh_axes(d.mesh),
        }

    def flight_record(self, reason: str, context: Optional[dict] = None,
                      path: Optional[str] = None) -> str:
        """Dump the last K ring windows and the bus tail atomically; returns
        the artifact path. Reading the ring here is a sync point — by
        design: the flight is recorded when something already went wrong."""
        self.bus.publish("flight", "dump", tick=self.driver._host_tick, reason=reason)
        with self.driver._lock:
            snap = self.ring.snapshot(self.config.flight_windows)
        self.driver._note_readback(1)
        # an armed trace plane contributes the causal section: the trace
        # ring's tail and the sewn span trees of the violating members (the
        # rows of failed detection obligations in the context, else the
        # tracers)
        trace_doc = None
        tplane = getattr(self.driver, "_trace", None)
        if tplane is not None:
            sent = (context or {}).get("sentinels") or {}
            bad = [
                det["row"] for det in sent.get("detections", ()) if not det.get("ok", True)
            ] or list(tplane.spec.tracer_rows)
            trace_doc = tplane.flight_section(bad)
        target = path or default_dump_path(self.config.flight_dir, reason)
        recon = self._reconstruction_section()
        tick_hi = int(self.driver._host_tick)
        tick_lo = int(recon["t0"]) if recon is not None else 0
        out = write_flight_dump(
            target,
            reason=reason,
            engine=self.driver.engine,
            ring_snapshot=snap,
            bus_tail=[r.as_dict() for r in self.bus.tail()],
            context=context,
            trace=trace_doc,
            reconstruction=recon,
            tick_range=[tick_lo, tick_hi],
            backend=self.driver.device.type,
        )
        self.flight_dumps.append(out)
        return out

    # -- timestamping hook for bus adapters -----------------------------------
    def tick_now(self) -> int:
        """The driver's host-side tick (never a device read)."""
        return self.driver._host_tick
