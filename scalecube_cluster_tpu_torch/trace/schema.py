"""Trace-ring record schema: THE shared spelling of the causal trace plane.

One ring record is a wide int32 row describing everything protocol-visible
that happened to ONE tracer member in ONE tick — the reference gets the
same information for free from per-message DEBUG logs on its Reactor
pipeline (``FailureDetectorImpl`` / ``GossipProtocolImpl`` logging, SURVEY
§5); the lockstep tensor engine captures it as a fixed-shape device append
instead (``[ring_len, n_fields]`` int32, the r8 metric-ring discipline:
appended inside the window jit, HOST cursor, transferred only at a
flush/scrape sync point).

Why a wide row per (tracer, tick) instead of one narrow row per event: the
number of protocol events per tick is data-dependent, and a data-dependent
append count would force a DEVICE cursor — and with it either a per-window
readback (breaking the r6 zero-transfer discipline) or dynamic shapes
(breaking jit). A static row per tracer per tick keeps the append count a
host-known constant (K rows per tick), at the cost of exemplar sampling
for event classes that can burst (see the ``*_BY`` fields: counts are
exact, the named observer is the lowest-row exemplar).

Field groups (offsets depend on the static ``ping_req_k`` and the traced
rumor-slot count — always go through :class:`TraceSpec`):

* header — tick, tracer row, flags (FD round ran / probe sent / acked /
  direct / self-refuted / SYNC due / SYNC ok).
* tracer as OBSERVER — its FD probe (target, ack path, vouch verdict
  bitmask, relay rows = the vouch requests) and its SYNC round (peer,
  records the peer accepted from its table, records it accepted back).
* tracer as SUBJECT — who probed it and who missed (count + exemplar),
  suspicion raised / refuted / expired→DEAD transitions in observer
  tables about it (counts + exemplars + running totals), derived by
  diffing the tracer's view-key COLUMN across the tick, so a transition
  is captured no matter which phase (FD verdict, gossip merge, SYNC
  merge, suspicion sweep) caused it.
* traced rumor slots — per-slot first-infection activity this tick
  (count, exemplar infectee, its infecting edge from ``infected_from`` —
  the per-rumor propagation-tree lineage of the fault-tolerant
  rumor-spreading analyses, arXiv:1311.2839 / arXiv:1209.6158). The FULL
  infection tree additionally rides the persistent ``infected_at`` /
  ``infected_from`` planes, gathered at sync points
  (:meth:`..trace.plane.TracePlane.rumor_provenance`).

Everything here is host-importable without jax (numpy only) — spans.py and
export.py decode records on the monitor thread.

A copy of the JAX package's ``trace/schema.py`` (it imports no JAX), so that
the port decodes, sews and exports its records with its own code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

#: sentinel for "no row" in row-valued fields
NO_ROW = -1

# header flag bits (F_FLAGS)
FLAG_FD_ROUND = 1 << 0  # the FD phase ran this tick (tick % fd_every == 0)
FLAG_PROBE_SENT = 1 << 1  # tracer had a probe target this round
FLAG_PROBE_ACK = 1 << 2  # the probe round-trip succeeded (direct or vouched)
FLAG_PROBE_DIRECT = 1 << 3  # ...via the direct ping (no vouch needed)
FLAG_SELF_REFUTED = 1 << 4  # tracer bumped its own incarnation this tick
FLAG_SYNC_DUE = 1 << 5  # tracer held a SYNC caller slot this tick
FLAG_SYNC_OK = 1 << 6  # ...and the SYNC round trip landed
#: WINDOW-SUMMARY record (appended once per window by the driver, not per
#: tick by the kernel): the subject-group fields hold the window-over-window
#: view-column diff — suspicion/death/refutation SPREAD across observers and
#: the running totals. Per-tick rows carry the event ORIGINS instead (FD
#: verdicts, expiry sweeps, self-refutations), captured from phase
#: internals: an in-scan read of the donated [N, N] view plane costs a full
#: extra plane materialization per tick (~18% at N=4096 CPU — measured, not
#: guessed), so the column diff runs OUTSIDE the window jit at the window
#: boundary, where the r8 telemetry plane already proved the pattern free.
FLAG_SUMMARY = 1 << 7

# fixed header fields
F_TICK = 0
F_TRACER = 1
F_FLAGS = 2
F_PROBE_TGT = 3  # tracer's probe target this FD round (NO_ROW = none)
F_VOUCH_MASK = 4  # bit s set = relay s acked the indirect probe
_HEADER_FIELDS = 5

#: per-relay vouch-request fields follow the header (ping_req_k of them),
#: then the as-subject group, then the SYNC group, then 3 per traced slot.
#: tick rows: new_suspect = FD-verdict suspicions raised about the tracer
#: this round (the lineage ORIGIN events); new_dead = suspicion-expiry
#: transitions this tick (the sweep that turns SUSPECT into DEAD); the
#: totals/refute_seen are 0. Summary rows (FLAG_SUMMARY): the same fields
#: hold the window-over-window view-column diff — gossip/SYNC-spread
#: suspicion ("who else now suspects"), death dissemination, observed
#: refutations, and the running suspect/dead observer totals.
_SUBJECT_FIELDS = (
    "probed_by",  # up observers that probed the tracer this round
    "probed_miss",  # ...whose probe round failed (the probe-miss events)
    "probed_miss_by",  # exemplar failing observer (lowest row; NO_ROW none)
    "new_suspect",  # tick: FD suspect verdicts; summary: newly-SUSPECT cells
    "new_suspect_by",  # exemplar suspecting observer
    "suspect_total",  # summary only: up observers holding SUSPECT on tracer
    "new_dead",  # tick: expiry transitions; summary: newly-DEAD cells
    "new_dead_by",  # exemplar observer
    "dead_total",  # summary only: up observers holding DEAD on tracer
    "refute_seen",  # summary only: cells flipped SUSPECT -> higher ALIVE
)
_SYNC_FIELDS = (
    "sync_peer",  # peer of the tracer's SYNC round (NO_ROW = none/undue)
    "sync_req_accepts",  # records the peer accepted from the tracer's table
    "sync_ack_accepts",  # records the tracer accepted from the ACK table
)
_RUMOR_FIELDS = ("rumor_new_inf", "rumor_inf_node", "rumor_inf_src")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Static (hashable — it parameterizes jitted window programs) shape of
    one armed trace plane: WHO is traced and how much history is retained.

    ``tracer_rows`` — the K sampled tracer members (both their outbound
    protocol activity and everything other members do ABOUT them is
    captured). ``rumor_slots`` — the T traced user-rumor slots.
    ``ring_len`` — device ring rows retained (K rows append per tick, so
    the ring holds ``ring_len / K`` ticks of history). ``ping_req_k``
    mirrors the engine's relay count and fixes the vouch-field width.
    """

    tracer_rows: Tuple[int, ...]
    rumor_slots: Tuple[int, ...] = ()
    ring_len: int = 8192
    ping_req_k: int = 3

    def __post_init__(self):
        if not self.tracer_rows:
            raise ValueError("TraceSpec needs at least one tracer row")
        if len(set(self.tracer_rows)) != len(self.tracer_rows):
            raise ValueError("tracer_rows must be distinct")
        if len(set(self.rumor_slots)) != len(self.rumor_slots):
            raise ValueError("rumor_slots must be distinct")
        if self.ring_len < len(self.tracer_rows):
            raise ValueError(
                "ring_len must hold at least one tick of records "
                f"({len(self.tracer_rows)} tracer rows)"
            )

    @property
    def n_tracers(self) -> int:
        return len(self.tracer_rows)

    @property
    def n_fields(self) -> int:
        return (
            _HEADER_FIELDS
            + self.ping_req_k
            + len(_SUBJECT_FIELDS)
            + len(_SYNC_FIELDS)
            + 3 * len(self.rumor_slots)
        )

    # -- field offsets --------------------------------------------------------
    def relay_field(self, s: int) -> int:
        """Row of the s-th vouch request (the relay the tracer asked)."""
        return _HEADER_FIELDS + s

    def subject_field(self, name: str) -> int:
        return _HEADER_FIELDS + self.ping_req_k + _SUBJECT_FIELDS.index(name)

    def sync_field(self, name: str) -> int:
        return (
            _HEADER_FIELDS
            + self.ping_req_k
            + len(_SUBJECT_FIELDS)
            + _SYNC_FIELDS.index(name)
        )

    def rumor_field(self, t: int, name: str) -> int:
        """Field of rumor group ``t`` (the t-th TRACED slot, not the slot
        id); identical values are written to every tracer's row."""
        return (
            _HEADER_FIELDS
            + self.ping_req_k
            + len(_SUBJECT_FIELDS)
            + len(_SYNC_FIELDS)
            + 3 * t
            + _RUMOR_FIELDS.index(name)
        )

    def field_names(self) -> List[str]:
        names = ["tick", "tracer", "flags", "probe_tgt", "vouch_mask"]
        names += [f"vouch_relay{s}" for s in range(self.ping_req_k)]
        names += list(_SUBJECT_FIELDS)
        names += list(_SYNC_FIELDS)
        for slot in self.rumor_slots:
            names += [f"{n}_s{slot}" for n in _RUMOR_FIELDS]
        return names


def decode_record(row: Sequence[int], spec: TraceSpec) -> List[Dict]:
    """One ring row -> the list of protocol EVENTS it encodes (host-side;
    plain dicts, JSON-ready). Empty groups decode to no events, so a quiet
    tick's row vanishes here rather than polluting the span stream."""
    row = [int(v) for v in row]
    tick = row[F_TICK]
    tracer = row[F_TRACER]
    flags = row[F_FLAGS]
    sf = lambda n: row[spec.subject_field(n)]  # noqa: E731
    events: List[Dict] = []

    if flags & FLAG_SUMMARY:
        # window-boundary view-diff record: dissemination of the verdicts
        # across observers + running totals (see FLAG_SUMMARY)
        if sf("new_suspect"):
            events.append({
                "kind": "suspect_spread",
                "tick": tick,
                "subject": tracer,
                "count": sf("new_suspect"),
                "observer": sf("new_suspect_by"),
                "suspect_total": sf("suspect_total"),
            })
        if sf("new_dead"):
            events.append({
                "kind": "dead_spread",
                "tick": tick,
                "subject": tracer,
                "count": sf("new_dead"),
                "observer": sf("new_dead_by"),
                "dead_total": sf("dead_total"),
            })
        if sf("refute_seen"):
            events.append({
                "kind": "suspect_refuted",
                "tick": tick,
                "subject": tracer,
                "count": sf("refute_seen"),
            })
        return events

    if flags & FLAG_PROBE_SENT:
        relays = [
            row[spec.relay_field(s)]
            for s in range(spec.ping_req_k)
            if row[spec.relay_field(s)] != NO_ROW
        ]
        events.append({
            "kind": "probe",
            "tick": tick,
            "observer": tracer,
            "subject": row[F_PROBE_TGT],
            "ack": bool(flags & FLAG_PROBE_ACK),
            "direct": bool(flags & FLAG_PROBE_DIRECT),
            "vouch_relays": relays,
            "vouch_mask": row[F_VOUCH_MASK],
        })
    if (flags & FLAG_FD_ROUND) and sf("probed_by"):
        events.append({
            "kind": "probed",
            "tick": tick,
            "subject": tracer,
            "probes": sf("probed_by"),
            "missed": sf("probed_miss"),
            "missed_by": sf("probed_miss_by"),
        })
    if sf("new_suspect"):
        events.append({
            "kind": "suspect_raised",  # FD verdicts — the lineage origin
            "tick": tick,
            "subject": tracer,
            "count": sf("new_suspect"),
            "observer": sf("new_suspect_by"),
        })
    if sf("new_dead"):
        events.append({
            "kind": "dead",  # suspicion-expiry transitions this tick
            "tick": tick,
            "subject": tracer,
            "count": sf("new_dead"),
            "observer": sf("new_dead_by"),
        })
    if flags & FLAG_SELF_REFUTED:
        events.append({"kind": "refute", "tick": tick, "subject": tracer})
    if flags & FLAG_SYNC_DUE:
        events.append({
            "kind": "sync",
            "tick": tick,
            "observer": tracer,
            "peer": row[spec.sync_field("sync_peer")],
            "ok": bool(flags & FLAG_SYNC_OK),
            "req_accepts": row[spec.sync_field("sync_req_accepts")],
            "ack_accepts": row[spec.sync_field("sync_ack_accepts")],
        })
    for t, slot in enumerate(spec.rumor_slots):
        n_new = row[spec.rumor_field(t, "rumor_new_inf")]
        if n_new and tracer == spec.tracer_rows[0]:
            # rumor groups are replicated across every tracer's row (the
            # capture is slot-scoped, not tracer-scoped); decode them once
            events.append({
                "kind": "rumor_infection",
                "tick": tick,
                "slot": slot,
                "count": n_new,
                "node": row[spec.rumor_field(t, "rumor_inf_node")],
                "src": row[spec.rumor_field(t, "rumor_inf_src")],
            })
    return events


def decode_records(rows, spec: TraceSpec) -> List[Dict]:
    """Decode a [M, n_fields] block (oldest first) into a flat, tick-ordered
    event list. Rows whose tick is 0 are ring cells never written."""
    events: List[Dict] = []
    for row in rows:
        if int(row[F_TICK]) <= 0:
            continue
        events.extend(decode_record(row, spec))
    events.sort(key=lambda e: (e["tick"], e["kind"]))
    return events
