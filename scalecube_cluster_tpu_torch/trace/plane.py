"""TracePlane: the armed causal-trace state of one :class:`..sim.SimDriver`.

Arming (``SimDriver.arm_trace``) swaps the driver's window for the engine's
traced window (``make_traced_run``): the state trajectory stays bit-identical
and ``step()`` stays transfer-free — each tick appends its record block to
the device ring in place, and :meth:`TracePlane.on_window` appends the
window-boundary summary block the same way. Everything host-facing happens
at sync points under the driver lock.

Host surfaces:

* :meth:`snapshot` / :meth:`events` / :meth:`sew` — ring readback, decode,
  span sewing.
* :meth:`detection_tree` — one subject's probe-miss → suspect → DEAD
  lineage (what chaos sentinel outcomes resolve to).
* :meth:`rumor_provenance` / :meth:`rumor_trees` — the full per-rumor
  infection trees from the persistent ``infected_at`` / ``infected_from``
  planes (one gather at the sync point).
* :meth:`perfetto` — the Chrome-trace/Perfetto document.
* :meth:`flight_section` — what a flight dump carries.

The port of the JAX package's ``trace/plane.py``; the summary programs are
plain tensor calls on the driver's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import TraceConfig
from . import capture as _capture
from . import export as _export
from . import spans as _spans
from .rings import TraceRing
from .schema import TraceSpec, decode_records


class TracePlane:
    """The armed trace state of one driver (``driver._trace``)."""

    def __init__(
        self,
        driver,
        config: Optional[TraceConfig] = None,
        tracer_rows: Optional[Sequence[int]] = None,
        rumor_slots: Optional[Sequence[int]] = None,
    ):
        cfg = config or TraceConfig()
        cap = driver.params.capacity
        if tracer_rows is None:
            tracer_rows = tuple(cfg.tracer_rows) or tuple(range(min(cfg.tracers, cap)))
        if rumor_slots is None:
            rumor_slots = tuple(cfg.rumor_slots)
        tracer_rows = tuple(int(r) for r in tracer_rows)
        rumor_slots = tuple(int(s) for s in rumor_slots)
        if any(not 0 <= r < cap for r in tracer_rows):
            raise ValueError(f"tracer_rows out of range [0, {cap})")
        if any(not 0 <= s < driver.params.rumor_slots for s in rumor_slots):
            raise ValueError(f"rumor_slots out of range [0, {driver.params.rumor_slots})")
        self.config = cfg
        self.driver = driver
        self.spec = TraceSpec(
            tracer_rows=tracer_rows,
            rumor_slots=rumor_slots,
            ring_len=cfg.ring_len,
            ping_req_k=driver.params.ping_req_k,
        )
        self.ring = TraceRing(self.spec, device=driver.device)
        # the window-boundary view-column mirror: dense and sparse gather
        # real view-key columns, pview synthesizes them from its tables
        self._eng = driver._eng
        # the tracer rows on the device, made here and not in a window
        _capture.tracer_index(self.spec, driver.device)
        self._cols = self._gather_cols(driver.state)
        # per-k snapshot cache keyed by the append counters: between window
        # boundaries the ring cannot change, so a scrape serves the host copy
        self._snap_cache: Dict[object, tuple] = {}

    def _gather_cols(self, state):
        # on a mesh: the tracers' columns of every rank's rows
        with self.driver._mesh_ctx():
            return self._eng.tracer_view_cols(state, self.spec.tracer_rows)

    # -- the per-window device path (called under the driver lock) -----------
    def on_window(self, state) -> None:
        """Fold one window boundary into the ring: the view-column diff
        since the previous boundary as a FLAG_SUMMARY record block. Tensor
        ops on the device only — no device-to-host transfer."""
        now = self._gather_cols(state)
        rows = _capture.build_summary_rows(self.spec, state.tick, self.driver._whole(state.up), self._cols, now)
        self._cols = now
        self.ring.append(rows)

    def reset_cols(self, state) -> None:
        """Re-baseline the window-boundary mirror (driver restore: the old
        columns belong to the abandoned timeline)."""
        self._cols = self._gather_cols(state)

    def on_restore(self, state) -> None:
        """Driver restore: clear the ring AND re-baseline the mirror — a
        restored driver's tick rewinds, and decode orders records by tick,
        so retained records of the abandoned timeline would sew into the
        restored one as phantom lineage."""
        self.ring.clear()
        self.reset_cols(state)

    # -- stats (host-only; no device touch) -----------------------------------
    def stats(self) -> Dict:
        return {
            "tracer_rows": list(self.spec.tracer_rows),
            "rumor_slots": list(self.spec.rumor_slots),
            "ring_len": self.spec.ring_len,
            "n_fields": self.spec.n_fields,
            "records": self.ring.records,
            "records_total": self.ring.records_total,
            "cursor": self.ring.cursor,
            "wraps": self.ring.wraps,
            "ticks_retained": self.spec.ring_len // self.spec.n_tracers,
        }

    # -- sync points (driver lock + readback bookkeeping) ---------------------
    def snapshot(self, k: Optional[int] = None) -> Dict:
        """Raw ring readback, oldest first — THE trace-ring sync point.
        Cached per (append counts, k): only the first read after a window
        boundary pays the lock and the transfer."""
        key = (self.ring.records_total, self.ring.records, k)
        hit = self._snap_cache.get(k)
        if hit is not None and hit[0] == key:
            return hit[1]
        with self.driver._lock:
            snap = self.ring.snapshot(k)
        self.driver._note_readback(1)
        self._snap_cache[k] = (key, snap)
        return snap

    def events(self, k: Optional[int] = None) -> List[Dict]:
        """Decoded protocol events from the newest ``k`` records."""
        return decode_records(self.snapshot(k)["rows"], self.spec)

    def sew(self, k: Optional[int] = None) -> Dict:
        """Events and every detection lineage the ring substantiates."""
        return _spans.sew_trees(self.snapshot(k)["rows"], self.spec)

    def detection_tree(self, subject: int, k: Optional[int] = None):
        """The probe-miss → suspect → DEAD span tree of one tracer subject
        (None when the ring holds no detection activity about it)."""
        return _spans.detection_tree(self.events(k), subject)

    # -- rumor provenance (persistent planes, one gather) ---------------------
    def rumor_provenance(self, slot: int) -> Dict:
        """The complete infection record of one traced slot from the
        persistent planes: rows, arrival ticks, infecting edges."""
        if slot not in self.spec.rumor_slots:
            raise ValueError(f"slot {slot} is not traced ({self.spec.rumor_slots})")
        d = self.driver
        with d._lock:
            st = d.state
            inf_plane = getattr(st, "infected_bool", st.infected)
            inf = inf_plane[:, slot].cpu().numpy()
            at = st.infected_at[:, slot].cpu().numpy()
            frm = st.infected_from[:, slot].cpu().numpy()
            origin = int(st.rumor_origin[slot])
        d._note_readback(1)
        rows = np.nonzero(inf)[0]
        return {
            "slot": int(slot),
            "origin": origin,
            "rows": [int(r) for r in rows],
            "at": [int(a) for a in at[rows]],
            "from": [int(f) for f in frm[rows]],
        }

    def rumor_trees(self) -> List[Dict]:
        """Infection trees for every traced slot (empty slots excluded)."""
        trees = []
        for slot in self.spec.rumor_slots:
            prov = self.rumor_provenance(slot)
            if prov["rows"]:
                trees.append(_spans.rumor_tree(prov["slot"], prov["origin"], prov["rows"], prov["at"],
                                               prov["from"]))
        return trees

    # -- monitor surfaces ------------------------------------------------------
    def trace_snapshot(self, k: int = 256) -> Dict:
        """``GET /trace``: stats, the newest ``k`` records decoded, and the
        sewn detection lineages (JSON-ready)."""
        sewn = self.sew(k)
        return {
            "armed": True,
            **self.stats(),
            "engine": self.driver.engine,
            "events": sewn["events"],
            "detections": sewn["detections"],
        }

    def perfetto(self, k: Optional[int] = None, profile: Optional[Dict] = None) -> Dict:
        """The combined Chrome-trace document — protocol span trees, rumor
        infection trees, and an optional phase-profiler timeline."""
        sewn = self.sew(k)
        return _export.chrome_trace(
            span_trees=list(sewn["detections"].values()),
            rumor_trees=self.rumor_trees(),
            profile=profile,
            tick_us=self.config.tick_us,
        )

    def otel_spans(self, k: Optional[int] = None) -> List[Dict]:
        """OpenTelemetry-style span dicts for every sewn lineage."""
        sewn = self.sew(k)
        return _export.to_otel_spans(list(sewn["detections"].values()))

    # -- flight-recorder section ----------------------------------------------
    def flight_section(self, violating_rows: Sequence[int] = (), tail: int = 256) -> Dict:
        """What a flight dump carries: the trace-ring tail (raw rows,
        replayable through :func:`.schema.decode_records`) and the sewn
        span tree of each violating member that is a tracer."""
        snap = self.snapshot(tail)
        events = decode_records(snap["rows"], self.spec)
        trees = {}
        for row in violating_rows:
            if row in self.spec.tracer_rows:
                tree = _spans.detection_tree(events, int(row))
                if tree is not None:
                    trees[int(row)] = tree
        return {
            "fields": snap["fields"],
            "records_total": snap["records"],
            "rows": [[int(v) for v in r] for r in snap["rows"]],
            "tracer_rows": list(self.spec.tracer_rows),
            "rumor_slots": list(self.spec.rumor_slots),
            "span_trees": trees,
        }
