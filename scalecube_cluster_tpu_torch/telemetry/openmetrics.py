"""OpenMetrics / Prometheus text exposition for both engines.

``GET /metrics`` on :class:`..monitor.MonitorServer` renders metric
families — counters, gauges, histograms — in the Prometheus text format
(version 0.0.4, with a trailing ``# EOF`` so OpenMetrics parsers accept it
too). Families come from provider callables registered on the server:

* :func:`driver_families` — a :class:`SimDriver` + its armed
  :class:`.plane.TelemetryPlane`: dispatch counters, announce-drop
  counters by reason, the newest metric-ring row as gauges, the
  window-dispatch / tick-latency / detection-latency / rumor-spread
  histograms, and event-bus counters. Rendering is a SCRAPE SYNC POINT —
  it flushes the driver's deferred reductions and reads the ring's newest
  row, exactly like ``/health`` (poll cadence, never window cadence).
* :func:`cluster_families` — the scalar/real-transport engine's
  :class:`..cluster.Cluster`: cluster size, incarnation, per-status member
  counts, plus transport-event counters when a bus is attached.

Everything here is dependency-free host code (stdlib only — the repo rule).
A copy of the JAX package's ``telemetry/openmetrics.py``: the port imports
nothing of that package.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "scalecube"

#: content type of the rendered exposition
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class Histogram:
    """Fixed-bucket cumulative histogram (the Prometheus model): host-side
    observations only (wall-clock timings, report-derived latencies), so it
    never touches the device."""

    def __init__(self, buckets: Sequence[float]):
        if list(buckets) != sorted(buckets) or not buckets:
            raise ValueError("histogram buckets must be non-empty ascending")
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf bucket last
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.buckets, value)] += 1
        self.total += 1
        self.sum += float(value)

    def samples(self, name: str, labels: Optional[dict] = None) -> List[tuple]:
        """Cumulative ``_bucket``/``_sum``/``_count`` sample tuples."""
        labels = labels or {}
        out, acc = [], 0
        for le, c in zip(self.buckets, self.counts):
            acc += c
            out.append((f"{name}_bucket", {**labels, "le": _fmt(le)}, acc))
        out.append((f"{name}_bucket", {**labels, "le": "+Inf"}, self.total))
        out.append((f"{name}_sum", labels, self.sum))
        out.append((f"{name}_count", labels, self.total))
        return out


def family(name: str, ftype: str, help_: str, samples: Iterable[tuple]) -> dict:
    """One metric family: ``samples`` is an iterable of
    ``(sample_name, labels_dict, value)`` tuples."""
    return {"name": name, "type": ftype, "help": help_, "samples": list(samples)}


def _fmt(v) -> str:
    """Prometheus sample-value / le-label formatting."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(value: str) -> str:
    return (
        str(value).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')
    )


def render(families: Iterable[dict]) -> str:
    """Prometheus text exposition of the given families (stable order as
    given; duplicate family names are the caller's bug)."""
    lines: List[str] = []
    for fam in families:
        lines.append(f"# HELP {fam['name']} {fam['help']}")
        lines.append(f"# TYPE {fam['name']} {fam['type']}")
        for sample in fam["samples"]:
            sname, labels, value = sample
            if labels:
                lab = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
                )
                lines.append(f"{sname}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{sname} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _bus_families(bus) -> List[dict]:
    stats = bus.stats()
    return [
        family(
            f"{PREFIX}_bus_events_total", "counter",
            "Telemetry-bus records published, by source and kind.",
            [
                (f"{PREFIX}_bus_events_total",
                 {"source": src, "kind": kind}, n)
                for (src, kind), n in sorted(bus.counts().items())
            ],
        ),
        family(
            f"{PREFIX}_bus_evicted_total", "counter",
            "Telemetry-bus records evicted by the bounded retention.",
            [(f"{PREFIX}_bus_evicted_total", {}, stats["evicted"])],
        ),
        # r10 satellite: the bus's bounded-retention state as GAUGES — the
        # eviction counter alone can't tell "about to drop" from "idle"
        family(
            f"{PREFIX}_bus_retained", "gauge",
            "Telemetry-bus records currently retained.",
            [(f"{PREFIX}_bus_retained", {}, stats["retained"])],
        ),
        family(
            f"{PREFIX}_bus_capacity", "gauge",
            "Telemetry-bus bounded retention capacity.",
            [(f"{PREFIX}_bus_capacity", {}, stats["capacity"])],
        ),
    ]


def driver_families(driver, plane) -> List[dict]:
    """Metric families for one SimDriver + armed TelemetryPlane. Calling
    this IS the scrape sync point: it flushes the deferred reductions and
    reads the metric ring's newest row back (one coalesced transfer)."""
    counters = dict(driver.health_counters)  # property read = the flush
    ds = driver.dispatch_snapshot()
    engine = driver.engine
    base = {"engine": engine}
    fams = [
        family(
            f"{PREFIX}_ticks_total", "counter",
            "Simulated gossip periods dispatched.",
            [(f"{PREFIX}_ticks_total", base, ds["ticks_dispatched"])],
        ),
        family(
            f"{PREFIX}_windows_total", "counter",
            "Jitted windows dispatched.",
            [(f"{PREFIX}_windows_total", base, ds["windows_dispatched"])],
        ),
        family(
            f"{PREFIX}_readbacks_total", "counter",
            "Device-to-host transfer events (sync points only on the "
            "no-consumer path).",
            [(f"{PREFIX}_readbacks_total", base, ds["readbacks"])],
        ),
        family(
            f"{PREFIX}_flushes_total", "counter",
            "Coalesced deferred-reduction flushes.",
            [(f"{PREFIX}_flushes_total", base, ds["flushes"])],
        ),
        family(
            f"{PREFIX}_dispatch_queue_depth", "gauge",
            "Windows enqueued since the last host sync.",
            [(f"{PREFIX}_dispatch_queue_depth", base, ds["queue_depth"])],
        ),
        family(
            f"{PREFIX}_announce_dropped_total", "counter",
            "Membership-rumor announce drops, by reason.",
            [
                (f"{PREFIX}_announce_dropped_total",
                 {**base, "reason": name[len("announce_dropped_"):] or "total"},
                 v)
                for name, v in sorted(counters.items())
                if name.startswith("announce_dropped_")
            ],
        ),
        family(
            f"{PREFIX}_announced_total", "counter",
            "Membership rumors allocated into the pool.",
            [(f"{PREFIX}_announced_total", base, counters.get("announced", 0))],
        ),
        family(
            f"{PREFIX}_pool_evicted_total", "counter",
            "Priority evictions of majority-covered rumors.",
            [(f"{PREFIX}_pool_evicted_total", base,
              counters.get("pool_evicted", 0))],
        ),
        # r21: the ragged all-to-all budget-drop sentinel, accumulated
        # device-side per window like the other counters (0 everywhere
        # except budgeted sharded pview runs — a live sentinel, always
        # exposed so dashboards can alert on the first nonzero)
        family(
            f"{PREFIX}_delivery_overflow_total", "counter",
            "Gossip records dropped by the ragged-delivery budget "
            "(sharded pview windows).",
            [(f"{PREFIX}_delivery_overflow_total", base,
              counters.get("delivery_overflow", 0))],
        ),
    ]
    if driver.mesh is not None:
        from ..ops.sharding import mesh_axes

        fams.append(
            family(
                f"{PREFIX}_mesh_devices", "gauge",
                "Devices in the driver's mesh, by axis.",
                [
                    (f"{PREFIX}_mesh_devices", {**base, "axis": str(ax)}, int(sz))
                    for ax, sz in sorted(mesh_axes(driver.mesh).items())
                ],
            )
        )
    # newest ring row -> per-series gauges (the live window values; the
    # full retained series rides the flight recorder, not the scrape).
    # NO driver lock (r19): latest_values reads the ring's RETAINED last
    # row — a never-donated buffer — not the donated ring itself, so the
    # scrape cannot hit the deleted pre-append array (the r6 hazard) and
    # never queues behind a mega-sim window's compute. Full-ring reads
    # (flight dumps, plane.snapshot) still take the lock.
    latest = plane.ring.latest_values()
    fams.append(
        family(
            f"{PREFIX}_window", "gauge",
            "Newest metric-ring window row, by series name.",
            [
                (f"{PREFIX}_window", {**base, "series": name}, value)
                for name, value in sorted(latest.items())
            ],
        )
    )
    fams.append(
        family(
            f"{PREFIX}_ring_windows_total", "counter",
            "Window rows appended to the device metric ring.",
            [(f"{PREFIX}_ring_windows_total", base, plane.ring.windows)],
        )
    )
    # r10 satellite: device-ring cursor position + wrap count as gauges
    # (host-side cursor arithmetic — the scrape does not touch the device
    # for these; how much retained history a flight dump would carry)
    fams.append(
        family(
            f"{PREFIX}_ring_cursor", "gauge",
            "Device metric-ring write cursor (next row index).",
            [(f"{PREFIX}_ring_cursor", base,
              plane.ring.windows % plane.ring.ring_len)],
        )
    )
    fams.append(
        family(
            f"{PREFIX}_ring_wraps_total", "counter",
            "Times the device metric ring lapped itself (history overwritten).",
            [(f"{PREFIX}_ring_wraps_total", base,
              plane.ring.windows // plane.ring.ring_len)],
        )
    )
    tplane = getattr(driver, "_trace", None)
    if tplane is not None:
        # counters use the LIFETIME totals (monotone across the
        # restore-path ring clear — a decreasing counter corrupts
        # Prometheus rate()/increase() over the restore boundary)
        fams.append(
            family(
                f"{PREFIX}_trace_records_total", "counter",
                "Records appended to the device trace ring (lifetime).",
                [(f"{PREFIX}_trace_records_total", base,
                  tplane.ring.records_total)],
            )
        )
        fams.append(
            family(
                f"{PREFIX}_trace_ring_cursor", "gauge",
                "Device trace-ring write cursor (next record index).",
                [(f"{PREFIX}_trace_ring_cursor", base, tplane.ring.cursor)],
            )
        )
        fams.append(
            family(
                f"{PREFIX}_trace_ring_wraps_total", "counter",
                "Times the device trace ring lapped itself (lifetime).",
                [(f"{PREFIX}_trace_ring_wraps_total", base,
                  tplane.ring.wraps_total)],
            )
        )
    for hname, hist, help_ in (
        ("window_dispatch_seconds", plane.hist_dispatch,
         "Host wall time to enqueue one jitted window."),
        ("tick_latency_seconds", plane.hist_tick,
         "Per-tick host latency (window dispatch time / ticks)."),
        ("detection_latency_ticks", plane.hist_detection,
         "Crash-detection latency observed by chaos sentinels, in ticks."),
        ("rumor_spread_ticks", plane.hist_spread,
         "Ticks from rumor creation to full coverage."),
    ):
        fams.append(
            family(f"{PREFIX}_{hname}", "histogram", help_,
                   hist.samples(f"{PREFIX}_{hname}", base))
        )
    fams.extend(_bus_families(plane.bus))
    return fams


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)


def _parse_labels(text: str) -> Dict[str, str]:
    """Parse a ``k="v",k2="v2"`` label body (the inverse of :func:`render`'s
    label formatting, including the escape rules)."""
    labels: Dict[str, str] = {}
    i, n = 0, len(text)
    while i < n:
        eq = text.index("=", i)
        key = text[i:eq].strip().lstrip(",").strip()
        if text[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {text[eq:]!r}")
        j = eq + 2
        out = []
        while True:
            c = text[j]
            if c == "\\":
                nxt = text[j + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            elif c == '"':
                break
            else:
                out.append(c)
                j += 1
        labels[key] = "".join(out)
        i = j + 1
    return labels


def parse_exposition(text: str) -> List[dict]:
    """Parse a Prometheus 0.0.4 text exposition back into family dicts —
    the inverse of :func:`render`, used by the federation route to fold
    worker scrapes. Tolerates the trailing ``# EOF`` and unknown comment
    lines; samples seen before any ``# TYPE`` get type ``untyped``."""
    fams: List[dict] = []
    by_name: Dict[str, dict] = {}
    helps: Dict[str, str] = {}

    def fam_for(sample_name: str) -> dict:
        # histogram/summary samples attach to their base family name
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in by_name:
                base = base[: -len(suffix)]
                break
        if base not in by_name:
            by_name[base] = family(
                base, "untyped", helps.get(base, ""), []
            )
            fams.append(by_name[base])
        return by_name[base]

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                name = parts[2]
                ftype = parts[3] if len(parts) > 3 else "untyped"
                if name not in by_name:
                    by_name[name] = family(name, ftype, helps.get(name, ""), [])
                    fams.append(by_name[name])
                else:
                    by_name[name]["type"] = ftype
            elif len(parts) >= 3 and parts[1] == "HELP":
                name = parts[2]
                help_ = parts[3] if len(parts) > 3 else ""
                helps[name] = help_
                if name in by_name:
                    by_name[name]["help"] = help_
            continue
        if "{" in line:
            brace = line.index("{")
            sname = line[:brace]
            close = line.rindex("}")
            labels = _parse_labels(line[brace + 1:close])
            value = _parse_value(line[close + 1:].strip().split()[0])
        else:
            fields = line.split()
            sname, value, labels = fields[0], _parse_value(fields[1]), {}
        fam_for(sname)["samples"].append((sname, labels, value))
    return fams


def federated_families(expositions: Dict[str, str]) -> List[dict]:
    """Fold per-worker expositions (shard label -> scrape text) into one
    family list: every sample is re-emitted verbatim with a ``shard``
    label added, families merged by name (first worker's TYPE/HELP wins,
    stable order). Values pass through untouched, so each (series, shard)
    stream keeps the source counter's lifetime monotonicity — the r10
    Prometheus rule federates shard-wise instead of summing away."""
    merged: List[dict] = []
    by_name: Dict[str, dict] = {}
    for shard, text in expositions.items():
        for fam in parse_exposition(text):
            tgt = by_name.get(fam["name"])
            if tgt is None:
                tgt = family(fam["name"], fam["type"], fam["help"], [])
                by_name[fam["name"]] = tgt
                merged.append(tgt)
            tgt["samples"].extend(
                (sname, {**labels, "shard": str(shard)}, value)
                for sname, labels, value in fam["samples"]
            )
    return merged


def cluster_families(cluster, bus=None) -> List[dict]:
    """Metric families for one scalar-engine Cluster node."""
    mp = cluster.membership_protocol
    member = cluster.member()
    base = {"engine": "scalar", "member": member.id}
    fams = [
        family(
            f"{PREFIX}_cluster_size", "gauge",
            "Members in this node's view (incl. itself).",
            [(f"{PREFIX}_cluster_size", base, len(mp.members()))],
        ),
        family(
            f"{PREFIX}_incarnation", "gauge",
            "This node's own incarnation number.",
            [(f"{PREFIX}_incarnation", base, mp.incarnation)],
        ),
        family(
            f"{PREFIX}_members", "gauge",
            "Members by status, as seen by this node.",
            [
                (f"{PREFIX}_members", {**base, "status": "alive"},
                 len(mp.alive_members())),
                (f"{PREFIX}_members", {**base, "status": "suspected"},
                 len(mp.suspected_members())),
                (f"{PREFIX}_members", {**base, "status": "removed"},
                 len(mp.removed_members())),
            ],
        ),
    ]
    if bus is not None:
        fams.extend(_bus_families(bus))
    return fams
