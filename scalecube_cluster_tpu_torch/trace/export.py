"""Render sewn spans and profiler timelines as Chrome-trace/Perfetto JSON.

The Chrome trace-event format (the JSON Perfetto and ``chrome://tracing``
both load) is the one observability surface everything funnels into:

* protocol span trees (:mod:`.spans`) — "X" complete events on a
  tick-clock track, one process per subject, nesting by span depth, with
  span events as "i" instants;
* rumor infection trees — one "X" per infected node at its arrival tick,
  thread = tree depth, so the waterfall IS the propagation tree;
* tick-phase profiler runs (:mod:`.profile`) — "X" events on a wall-clock
  track, one thread per phase.

Two clocks coexist (protocol ticks vs host wall): each rides its own
``pid`` track and ticks are mapped to microseconds via ``tick_us``
(default 1000 µs = 1 ms per tick, so a 200 ms gossip period renders
compactly). Everything is stdlib-only and JSON-ready; ``json.dump`` of any
return value is a loadable Perfetto file (the tier-1 test holds that).

A copy of the JAX package's ``trace/export.py`` (it imports no JAX), so that
the port decodes, sews and exports its records with its own code.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from .spans import flatten_spans

#: pid tracks of the combined timeline
PID_HOST = 1  # wall-clock: host dispatch + device phase timings
PID_SPANS = 2  # tick-clock: protocol span trees
PID_RUMORS = 3  # tick-clock: rumor infection trees


def _meta(pid: int, name: str) -> Dict:
    return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}


def spans_to_events(
    tree: Dict, tick_us: float = 1000.0, pid: int = PID_SPANS
) -> List[Dict]:
    """One span tree -> Chrome events ("X" per span, "i" per span event).
    Thread id = nesting depth, so the track renders as a flame of the
    probe-miss → suspect → dead chain."""
    out: List[Dict] = []

    def _walk(node, depth):
        start = node["start_tick"] * tick_us
        dur = max(node["end_tick"] - node["start_tick"], 1) * tick_us
        out.append({
            "name": node["name"],
            "cat": "protocol",
            "ph": "X",
            "ts": start,
            "dur": dur,
            "pid": pid,
            "tid": depth,
            "args": {
                "span_id": node["span_id"],
                "parent_span_id": node["parent_span_id"],
                **{k: v for k, v in node["attributes"].items()
                   if v is not None},
            },
        })
        for ev in node["events"]:
            out.append({
                "name": ev.get("name", "event"),
                "cat": "protocol",
                "ph": "i",
                "s": "t",
                "ts": ev["tick"] * tick_us,
                "pid": pid,
                "tid": depth,
                "args": {k: v for k, v in ev.items()
                         if k not in ("tick", "name")},
            })
        for c in node["children"]:
            _walk(c, depth + 1)

    _walk(tree, 0)
    return out


def rumor_tree_to_events(
    tree: Dict, tick_us: float = 1000.0, pid: int = PID_RUMORS
) -> List[Dict]:
    """One infection tree -> Chrome events: each node an "X" at its arrival
    tick on the thread of its tree depth, args carrying the infecting edge
    — the waterfall reads as the propagation frontier advancing."""
    out: List[Dict] = [{
        "name": f"rumor(slot={tree['slot']})",
        "cat": "rumor",
        "ph": "X",
        "ts": 0.0,
        "dur": max(tree.get("last_infection_tick") or 1, 1) * tick_us,
        "pid": pid,
        "tid": 0,
        "args": {"origin": tree["origin"], "n_infected": tree["n_infected"],
                 "depth": tree["depth"]},
    }]

    def _walk(node, depth):
        out.append({
            "name": f"infect(row={node['row']})",
            "cat": "rumor",
            "ph": "X",
            "ts": node["at"] * tick_us,
            "dur": tick_us,
            "pid": pid,
            "tid": depth + 1,
            "args": {"row": node["row"], "from": node["from"],
                     "at_tick": node["at"]},
        })
        for c in node["children"]:
            _walk(c, depth + 1)

    _walk(tree["root"], 0)
    return out


def profile_to_events(profile: Dict, pid: int = PID_HOST) -> List[Dict]:
    """A :func:`..trace.profile` result -> wall-clock Chrome events (one
    thread per phase; ts anchored at the run's own zero)."""
    out: List[Dict] = []
    tids = {}
    for ev in profile.get("timeline", ()):
        tid = tids.setdefault(ev["phase"], len(tids))
        out.append({
            "name": ev["phase"],
            "cat": "device_phase",
            "ph": "X",
            "ts": ev["start_s"] * 1e6,
            "dur": max(ev["dur_s"] * 1e6, 0.01),
            "pid": pid,
            "tid": tid,
            "args": {"tick": ev.get("tick")},
        })
    return out


def chrome_trace(
    span_trees: Sequence[Dict] = (),
    rumor_trees: Sequence[Dict] = (),
    profile: Optional[Dict] = None,
    tick_us: float = 1000.0,
) -> Dict:
    """The combined Perfetto document: protocol spans, rumor trees, and the
    phase profiler interleaved on their labelled clock tracks."""
    events: List[Dict] = []
    if profile is not None:
        events.append(_meta(PID_HOST, "host+device phases (wall clock)"))
        events.extend(profile_to_events(profile))
    if span_trees:
        events.append(_meta(PID_SPANS, "protocol spans (tick clock)"))
        for tree in span_trees:
            events.extend(spans_to_events(tree, tick_us))
    if rumor_trees:
        events.append(_meta(PID_RUMORS, "rumor infection trees (tick clock)"))
        for tree in rumor_trees:
            events.extend(rumor_tree_to_events(tree, tick_us))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"tick_us": tick_us, "source": "scalecube_cluster_tpu"},
    }


def to_otel_spans(span_trees: Sequence[Dict]) -> List[Dict]:
    """Span trees -> flat OpenTelemetry-style span dicts (the shape an OTLP
    adapter would serialize; tick time base, documented in docs/TRACING.md)."""
    out: List[Dict] = []
    for tree in span_trees:
        out.extend(flatten_spans(tree))
    return out


def write_chrome_trace(path: str, doc: Dict) -> str:
    """Write one Perfetto-loadable JSON file; returns the path."""
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
