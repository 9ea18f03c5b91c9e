"""The per-tick trace-record builders the three engines share.

Two record paths, split by cost, as in the JAX package's
``trace/capture.py`` (whose module note carries the measurements):

* **Per-tick rows** (:func:`build_trace_rows`, called by a traced tick):
  everything derivable from [N]-sized phase internals the tick already
  computed — the FD probe picks and outcomes and the verdict suspicions,
  the suspicion sweep's expiry transitions (exported from the sweep's own
  ``expired`` mask), self-refutations, the SYNC callers' outcomes, and
  per-slot rumor first-infection exemplars.
* **Per-window summary rows** (:func:`build_summary_rows`, run by the
  trace plane at the window boundary): the window-over-window diff of the
  tracers' view-key COLUMNS — suspicion and death dissemination across
  observers, observed refutations, running totals.

Capture reads the trajectory and never feeds back into it, so an armed
tick's state is the unarmed tick's, bit for bit. Every builder here is a
device-side tensor op: the tick and the fd gate enter as host ints and
bools through fills, and the tracer rows as a tensor made once per device
(:func:`tracer_index`), so a traced window reads nothing back.

The port of the JAX package's ``trace/capture.py``, op for op: the
exemplar is a masked min over rows, the SYNC slot the first matching one
(``argmax`` over an int tensor returns the first maximum, as JAX's does),
and narrow i16 keys are widened to int32 before any diff.
"""

from __future__ import annotations

import functools

import torch

from ..ops._tensor import host_constant
from ..ops.lattice import RANK_ALIVE, RANK_DEAD, RANK_SUSPECT
from .schema import (
    FLAG_FD_ROUND,
    FLAG_PROBE_ACK,
    FLAG_PROBE_DIRECT,
    FLAG_PROBE_SENT,
    FLAG_SELF_REFUTED,
    FLAG_SUMMARY,
    FLAG_SYNC_DUE,
    FLAG_SYNC_OK,
    NO_ROW,
    TraceSpec,
)

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _rows_tensor(rows: tuple, device) -> torch.Tensor:
    return host_constant(rows, torch.int64, device)


def tracer_index(spec_or_rows, device) -> torch.Tensor:
    """The tracer rows as an int64 [K] tensor on ``device``, made once per
    (rows, device) and copied without a wait (``_tensor.host_constant``):
    a copy from the host each tick would wait for the device. ``spec_or_rows`` is a :class:`.schema.TraceSpec` or a row
    sequence."""
    rows = spec_or_rows.tracer_rows if isinstance(spec_or_rows, TraceSpec) else spec_or_rows
    return _rows_tensor(tuple(int(r) for r in rows), torch.device(device))


def zero_fd_trace(n: int, k: int, device) -> dict:
    """The FD export of a tick whose FD round did not run: no probes, so
    every derived event decodes to nothing."""
    zi = torch.zeros((n,), dtype=_I32, device=device)
    zb = torch.zeros((n,), dtype=torch.bool, device=device)
    return {
        "tgt": zi,
        "has_tgt": zb,
        "ack": zb,
        "direct_ok": zb,
        "suspect": zb,
        "relays": torch.zeros((n, k), dtype=_I32, device=device),
        "relay_valid": torch.zeros((n, k), dtype=torch.bool, device=device),
        "relay_ok": torch.zeros((n, k), dtype=torch.bool, device=device),
    }


def zero_sus_trace(spec: TraceSpec, device) -> dict:
    """The expiry export of a skipped suspicion sweep: no expiries."""
    k = spec.n_tracers
    return {
        "count": torch.zeros((k,), dtype=_I32, device=device),
        "by": torch.full((k,), NO_ROW, dtype=_I32, device=device),
    }


class ExpiryTrace:
    """The tracers' expiry export (JAX's ``expiry_trace``), accumulated
    over the row chunks of a suspicion sweep: each chunk hands over its
    slice of the sweep's own ``expired`` mask ([rows, N] — or [rows, K]
    columns already picked)."""

    def __init__(self, spec: TraceSpec, device):
        self.tr = tracer_index(spec, device)
        k = spec.n_tracers
        self.count = torch.zeros((k,), dtype=_I32, device=device)
        # [K] lowest expiring row so far (int64; the int64 max while none)
        self.first = torch.full((k,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)

    def add(self, cols: torch.Tensor, lo: int) -> None:
        """Fold the [rows, K] expiry mask of the chunk starting at row
        ``lo`` into the count and the lowest-row exemplar."""
        self.count += cols.sum(dim=0, dtype=_I32)
        n_rows = cols.shape[0]
        rows = torch.arange(lo, lo + n_rows, device=cols.device)
        big = torch.iinfo(torch.int64).max
        ex = torch.where(cols, rows[:, None], big).amin(dim=0)
        self.first = torch.minimum(self.first, ex)

    def add_plane(self, expired: torch.Tensor, lo: int) -> None:
        """:meth:`add` from a chunk of the [N, N] expiry mask."""
        self.add(expired.index_select(1, self.tr), lo)

    def result(self) -> dict:
        big = torch.iinfo(torch.int64).max
        by = torch.where(self.first == big, NO_ROW, self.first).to(_I32)
        return {"count": self.count, "by": by}


def gather_tracer_cols(view_key: torch.Tensor, spec_or_rows) -> torch.Tensor:
    """The tracers' [N, K] view-key columns of an [N, N] plane as int32
    (narrow i16 keys are widened so the diff math is layout-independent)."""
    return view_key.index_select(1, tracer_index(spec_or_rows, view_key.device)).to(_I32)


def _exemplar(mask: torch.Tensor) -> torch.Tensor:
    """Lowest set row per column of an [N, K] mask (NO_ROW when empty) —
    the deterministic exemplar the wide-row schema records when an event
    class bursts past one observer per tick. A masked min over rows."""
    n = mask.shape[0]
    rows = torch.arange(n, dtype=_I32, device=mask.device)
    ex = torch.where(mask, rows[:, None], n).amin(dim=0)
    return torch.where(ex >= n, NO_ROW, ex).to(_I32)


def _fill(value: int, k: int, device) -> torch.Tensor:
    return torch.full((k,), int(value), dtype=_I32, device=device)


def build_trace_rows(
    spec: TraceSpec,
    *,
    tick: int,
    up: torch.Tensor,
    fd_ran: bool,
    trace_fd: dict,
    trace_sus: dict,
    trace_ref: torch.Tensor,
    trace_sync: dict,
    infected_b: torch.Tensor,
    infected_at: torch.Tensor,
    infected_from: torch.Tensor,
) -> torch.Tensor:
    """One tick's [K, n_fields] int32 record block (see :mod:`.schema`).

    ``trace_fd`` / ``trace_sus`` / ``trace_sync`` are the engines'
    phase-internal exports; ``trace_ref`` the [K] self-refuted mask;
    ``infected_*`` the post-tick rumor planes ([N, R] bool / int32);
    ``tick`` the post-increment host tick and ``fd_ran`` whether the FD
    round ran."""
    dev = up.device
    k = spec.ping_req_k
    tr = tracer_index(spec, dev)  # [K] int64
    K = spec.n_tracers
    zero_k = torch.zeros((K,), dtype=_I32, device=dev)

    # -- tracer as observer: the FD probe ------------------------------------
    tgt = trace_fd["tgt"].to(_I32)
    has_tgt = trace_fd["has_tgt"] & bool(fd_ran)
    ack = trace_fd["ack"]
    probe_sent = has_tgt[tr]
    probe_tgt = torch.where(probe_sent, tgt[tr], NO_ROW)
    probe_ack = probe_sent & ack[tr]
    probe_direct = probe_sent & trace_fd["direct_ok"][tr]
    # vouch requests fire only when the direct ping failed
    indirect = probe_sent & ~probe_direct
    relay_rows = torch.where(
        indirect[:, None] & trace_fd["relay_valid"][tr],
        trace_fd["relays"][tr].to(_I32),
        NO_ROW,
    )  # [K, k]
    bits = torch.ones((), dtype=_I32, device=dev) << torch.arange(k, dtype=_I32, device=dev)
    vouch_mask = torch.where(
        indirect[:, None] & trace_fd["relay_ok"][tr], bits[None, :], 0
    ).sum(dim=1, dtype=_I32)

    # -- tracer as subject: probes and FD suspect verdicts about it ---------
    probed = has_tgt[:, None] & (tgt[:, None] == tr.to(_I32)[None, :])  # [N, K]
    probed_by = probed.sum(dim=0, dtype=_I32)
    miss = probed & ~ack[:, None]
    probed_miss = miss.sum(dim=0, dtype=_I32)
    probed_miss_by = _exemplar(miss)
    sus_verdict = probed & trace_fd["suspect"][:, None]
    new_suspect = sus_verdict.sum(dim=0, dtype=_I32)
    new_suspect_by = _exemplar(sus_verdict)

    # -- tracer as SYNC caller -----------------------------------------------
    caller = trace_sync["caller"].to(_I32)
    m = (caller[None, :] == tr.to(_I32)[:, None]) & trace_sync["valid"][None, :]  # [K, Ks]
    sync_due = m.any(dim=1)
    slot = torch.argmax(m.to(_I32), dim=1)  # the first matching slot (0 if none)
    sync_ok = sync_due & trace_sync["ok"][slot]
    sync_peer = torch.where(sync_ok, trace_sync["peer"].to(_I32)[slot], NO_ROW)
    sync_req_acc = torch.where(sync_ok, trace_sync["req_acc"].to(_I32)[slot], 0)
    sync_ack_acc = torch.where(sync_ok, trace_sync["ack_acc"].to(_I32)[slot], 0)

    # -- header flags ----------------------------------------------------------
    def _bit(cond, bit):
        return torch.where(cond, bit, 0).to(_I32)

    flags = (
        (FLAG_FD_ROUND if fd_ran else 0)
        + _bit(probe_sent, FLAG_PROBE_SENT)
        + _bit(probe_ack, FLAG_PROBE_ACK)
        + _bit(probe_direct, FLAG_PROBE_DIRECT)
        + _bit(trace_ref & up[tr], FLAG_SELF_REFUTED)
        + _bit(sync_due, FLAG_SYNC_DUE)
        + _bit(sync_ok, FLAG_SYNC_OK)
    )

    fields = [_fill(tick, K, dev), tr.to(_I32), flags.to(_I32), probe_tgt.to(_I32), vouch_mask]
    fields += [relay_rows[:, s] for s in range(k)]
    fields += [
        probed_by,
        probed_miss,
        probed_miss_by,
        new_suspect,
        new_suspect_by,
        zero_k,  # suspect_total: summary rows only
        trace_sus["count"].to(_I32),
        trace_sus["by"].to(_I32),
        zero_k,  # dead_total: summary rows only
        zero_k,  # refute_seen: summary rows only
        sync_peer.to(_I32),
        sync_req_acc.to(_I32),
        sync_ack_acc.to(_I32),
    ]

    # -- traced rumor slots (slot-scoped; replicated across tracer rows) ----
    for slot_id in spec.rumor_slots:
        newly = infected_b[:, slot_id] & (infected_at[:, slot_id] == tick) & up
        count = newly.sum(dtype=_I32)
        node = _exemplar(newly[:, None])  # [1]
        # a one-element index: a 0-d one would read it to the host
        src = torch.where(
            node >= 0, infected_from[:, slot_id].index_select(0, node.clamp(min=0).long()), NO_ROW
        ).to(_I32)
        fields += [count.expand(K), node.expand(K), src.expand(K)]

    assert len(fields) == spec.n_fields, (len(fields), spec.n_fields)
    return torch.stack(fields, dim=1)


def build_summary_rows(
    spec: TraceSpec,
    tick: int,
    up: torch.Tensor,
    prev_cols: torch.Tensor,
    now_cols: torch.Tensor,
) -> torch.Tensor:
    """One window-boundary [K, n_fields] summary block (FLAG_SUMMARY): the
    view-column diff since the previous boundary — dissemination counts,
    exemplars and running totals. Run by the trace plane on the
    post-window state; transitions are captured whatever phase caused
    them, at window granularity."""
    K = spec.n_tracers
    dev = up.device
    tr = tracer_index(spec, dev).to(_I32)
    zero_k = torch.zeros((K,), dtype=_I32, device=dev)
    no_row = _fill(NO_ROW, K, dev)
    up_col = up[:, None]

    known_prev = prev_cols >= 0
    known_now = now_cols >= 0
    sus_prev = known_prev & ((prev_cols & 3) == RANK_SUSPECT)
    sus_now = known_now & ((now_cols & 3) == RANK_SUSPECT)
    dead_prev = known_prev & ((prev_cols & 3) == RANK_DEAD)
    dead_now = known_now & ((now_cols & 3) == RANK_DEAD)
    new_suspect = up_col & sus_now & ~sus_prev
    new_dead = up_col & dead_now & ~dead_prev
    refute_seen = up_col & sus_prev & known_now & ((now_cols & 3) == RANK_ALIVE) & (now_cols > prev_cols)

    fields = [_fill(tick, K, dev), tr, _fill(FLAG_SUMMARY, K, dev), no_row, zero_k]
    fields += [no_row for _ in range(spec.ping_req_k)]
    fields += [
        zero_k,  # probed_by
        zero_k,  # probed_miss
        no_row,  # probed_miss_by
        new_suspect.sum(dim=0, dtype=_I32),
        _exemplar(new_suspect),
        (up_col & sus_now).sum(dim=0, dtype=_I32),
        new_dead.sum(dim=0, dtype=_I32),
        _exemplar(new_dead),
        (up_col & dead_now).sum(dim=0, dtype=_I32),
        refute_seen.sum(dim=0, dtype=_I32),
        no_row,  # sync_peer
        zero_k,  # sync_req_accepts
        zero_k,  # sync_ack_accepts
    ]
    fields += [zero_k] * (3 * len(spec.rumor_slots))
    assert len(fields) == spec.n_fields, (len(fields), spec.n_fields)
    return torch.stack(fields, dim=1)
