"""Sew trace-ring records into causal span trees.

Two tree shapes, matching the two causal structures the protocol has:

* **Detection lineage** — for a subject (usually a crashed tracer): the
  probe-miss → suspect-raised → expired-DEAD chain, as nested spans. This
  is the reference's per-message log trail ("which probe missed, who
  vouched, how the suspicion aged") reconstructed from the ring, and the
  explainer for every chaos detection-latency sentinel: the root span's
  extent IS the detection latency.
* **Rumor propagation tree** — for a traced user-rumor slot: the infection
  tree with per-edge provenance (who infected whom, when), the structure
  the fault-tolerant rumor-spreading analyses reason about
  (arXiv:1311.2839 §per-round trees; arXiv:1209.6158's robust push-pull).

Spans are OpenTelemetry-style plain dicts (``name`` / ``span_id`` /
``parent_span_id`` / ``start_tick`` / ``end_tick`` / ``attributes`` /
``events`` / ``children``); :mod:`.export` renders them to Chrome-trace /
Perfetto JSON. Ticks are the time base throughout (the export maps them to
microseconds).

Everything here is host-side stdlib+numpy code operating on ALREADY READ
ring snapshots — sewing never touches the device.

A copy of the JAX package's ``trace/spans.py`` (it imports no JAX), so that
the port decodes, sews and exports its records with its own code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .schema import NO_ROW, TraceSpec, decode_records


def _span(
    name: str,
    span_id: str,
    start: int,
    end: int,
    parent: Optional[str] = None,
    **attributes,
) -> Dict:
    return {
        "name": name,
        "span_id": span_id,
        "parent_span_id": parent,
        "start_tick": int(start),
        "end_tick": int(end),
        "attributes": attributes,
        "events": [],
        "children": [],
    }


def detection_tree(events: Sequence[Dict], subject: int) -> Optional[Dict]:
    """The probe-miss → suspect → DEAD lineage of ``subject``, or None when
    the ring holds no detection activity about it.

    The chain nests: a ``detection`` root spanning first-symptom to
    detection-complete; a ``probe_miss`` child covering the failed-probe
    window; its ``suspicion`` child covering suspect-raised to the first
    expiry (with refutation events inline — a refuted episode simply has
    no ``dead`` child); and the ``dead`` grandchild covering the spread of
    the DEAD verdict across observers. Exemplar observers ride as span
    events; counts in the attributes stay exact.
    """
    mine = [e for e in events if e.get("subject") == subject]
    misses = [e for e in mine if e["kind"] == "probed" and e["missed"]]
    # suspicion: per-tick FD verdicts (the origins) + window-granular
    # gossip/SYNC dissemination summaries; same split for death (per-tick
    # expiry sweeps + window-granular spread of the verdict)
    suspects = [e for e in mine
                if e["kind"] in ("suspect_raised", "suspect_spread")]
    deads = [e for e in mine if e["kind"] in ("dead", "dead_spread")]
    refutes = [e for e in mine if e["kind"] in ("suspect_refuted", "refute")]
    if not (misses or suspects or deads):
        return None

    t_first = min(e["tick"] for e in (misses + suspects + deads))
    t_last = max(e["tick"] for e in (misses + suspects + deads + refutes))
    sid = f"detect-{subject}"
    dead_totals = [e["dead_total"] for e in deads if "dead_total" in e]
    root = _span(
        f"detection(subject={subject})", sid, t_first, t_last,
        subject=subject,
        probe_misses=sum(e["missed"] for e in misses),
        suspect_raised=sum(
            e["count"] for e in suspects if e["kind"] == "suspect_raised"
        ),
        dead_expiries=sum(e["count"] for e in deads if e["kind"] == "dead"),
        refutations=len(refutes),
        dead_total=max(dead_totals, default=0),
        detected_at=deads[-1]["tick"] if deads else None,
    )

    parent = root
    if misses:
        pm = _span(
            f"probe_miss(subject={subject})", f"{sid}-probe",
            misses[0]["tick"], misses[-1]["tick"], parent=parent["span_id"],
            first_missed_by=misses[0]["missed_by"],
            probes_missed=sum(e["missed"] for e in misses),
        )
        pm["events"] = [
            {"tick": e["tick"], "name": "probe_missed",
             "observer": e["missed_by"], "missed": e["missed"]}
            for e in misses
        ]
        parent["children"].append(pm)
        parent = pm
    if suspects:
        end = deads[0]["tick"] if deads else (
            refutes[-1]["tick"] if refutes else suspects[-1]["tick"]
        )
        peak = max(
            (e["suspect_total"] for e in suspects if "suspect_total" in e),
            default=max(e["count"] for e in suspects),
        )
        sus = _span(
            f"suspicion(subject={subject})", f"{sid}-suspect",
            suspects[0]["tick"], end, parent=parent["span_id"],
            first_suspected_by=suspects[0]["observer"],
            peak_suspect_observers=peak,
            refuted=bool(refutes and not deads),
        )
        sus["events"] = [
            {"tick": e["tick"], "name": e["kind"],
             "observer": e["observer"], "count": e["count"]}
            for e in suspects
        ] + [
            {"tick": e["tick"], "name": e["kind"]} for e in refutes
        ]
        sus["events"].sort(key=lambda e: e["tick"])
        parent["children"].append(sus)
        parent = sus
    if deads:
        dd = _span(
            f"dead(subject={subject})", f"{sid}-dead",
            deads[0]["tick"], deads[-1]["tick"], parent=parent["span_id"],
            first_expired_by=deads[0]["observer"],
            final_dead_total=max(dead_totals, default=0),
        )
        dd["events"] = [
            {
                "tick": e["tick"],
                "name": "marked_dead" if e["kind"] == "dead" else "dead_spread",
                "observer": e["observer"], "count": e["count"],
                **({"dead_total": e["dead_total"]}
                   if "dead_total" in e else {}),
            }
            for e in deads
        ]
        parent["children"].append(dd)
    return root


def rumor_tree(
    slot: int,
    origin: int,
    infected_rows: Sequence[int],
    infected_at: Sequence[int],
    infected_from: Sequence[int],
) -> Dict:
    """The per-rumor infection tree from the persistent provenance planes:
    ``infected_from[i]`` is the delivering peer (NO_ROW at the origin), so
    parent pointers ARE the tree. Returns a nested node structure rooted at
    the origin plus flat stats; nodes whose recorded parent is not itself
    infected (a reclaimed-slot edge case) attach under the root with an
    ``orphan_edge`` marker rather than being dropped."""
    nodes = {
        int(r): {"row": int(r), "at": int(a), "from": int(f), "children": []}
        for r, a, f in zip(infected_rows, infected_at, infected_from)
    }
    if origin not in nodes:
        nodes[origin] = {"row": int(origin), "at": 0, "from": NO_ROW,
                         "children": []}
    root = nodes[origin]
    depth_max = 0
    for row, node in sorted(nodes.items()):
        if row == origin:
            continue
        parent = nodes.get(node["from"])
        if parent is None or parent is node:
            node["orphan_edge"] = True
            root["children"].append(node)
        else:
            parent["children"].append(node)

    def _depth(node, d=0):
        nonlocal depth_max
        depth_max = max(depth_max, d)
        for c in node["children"]:
            _depth(c, d + 1)

    _depth(root)
    ticks = [n["at"] for n in nodes.values() if n["row"] != origin]
    return {
        "slot": int(slot),
        "origin": int(origin),
        "n_infected": len(nodes),
        "depth": depth_max,
        "first_infection_tick": min(ticks) if ticks else None,
        "last_infection_tick": max(ticks) if ticks else None,
        "root": root,
    }


def sew_trees(rows, spec: TraceSpec) -> Dict:
    """Ring rows (oldest first) -> every detection lineage the ring can
    substantiate, keyed by tracer row, plus the flat decoded event list."""
    events = decode_records(rows, spec)
    detections = {}
    for subject in spec.tracer_rows:
        tree = detection_tree(events, subject)
        if tree is not None:
            detections[int(subject)] = tree
    return {"events": events, "detections": detections}


def flatten_spans(tree: Dict) -> List[Dict]:
    """Nested span tree -> flat OTel-style span list (children resolved to
    ``parent_span_id`` references; ``children`` keys dropped)."""
    out: List[Dict] = []

    def _walk(node):
        flat = {k: v for k, v in node.items() if k != "children"}
        out.append(flat)
        for c in node["children"]:
            _walk(c)

    _walk(tree)
    return out
