"""What the pview and sparse engines share: both states carry the same
leaves under the same names and meanings for everything but the view
(``tick``, ``up``, ``sus_key``/``sus_since``, the membership-rumor pool
``mr_*``/``minf_age``, the user-rumor pool ``rumor_*``/``infected*``), so
the host mutators of those leaves, the pool's coverage and segmentation
reductions, the rumor metrics, the push-pull reply leg, the pending
delivery rings and the window loop are written once here. Each engine module re-exports the mutators under
the JAX names."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..dissemination.strategies import pull_salt
from . import sharding
from ._tensor import bytes64, host_flags, maximum_into_, plane_chunks, row_chunks
from .bitplane import pack_bits, unpack_bits
from .pool import allocate
from .rand import fetch_uniform
from .state import NEVER


def rows_of(state) -> torch.Tensor:
    """int32 [N] row indices on the state's device."""
    return torch.arange(state.capacity, dtype=torch.int32, device=state.device)


def row_index(rows, device) -> torch.Tensor:
    """int64 [K] row indices on ``device`` from a tensor, a sequence, a
    range or an int."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.as_tensor(np.atleast_1d(np.asarray(rows, np.int64)), device=device)


def count_i32(x) -> torch.Tensor:
    """A bool tensor's count (or an integer tensor) as an int32 scalar."""
    return x.sum().to(torch.int32) if x.dtype == torch.bool else x.to(torch.int32)


def _rows_here(state) -> torch.Tensor:
    """int32 global row ids of the state's rows (the rank's rows on a member
    mesh)."""
    ctx = sharding.active()
    return rows_of(state) if ctx is None else ctx.rows(state.device)


def pull_replies(state, ok_all, p_all, ym_p, yu_p, loss_at, recv_u, recv_src, recv_m_p):
    """The push-pull reply leg of the pview and sparse gossip phases
    (DZ-2): each sender whose undelayed contact in fanout slot s landed
    (``ok_all[s]``, peer ``p_all[s]``) pulls the peer's payload back over
    the same round trip, gated on one hashed draw on the reverse link
    (``loss_at(state, peer, sender)``): the peer's packed forwarding words
    (``ym_p``), its young user rumors (``yu_p``) less those the sender is
    known to hold. The peer rows are gathered from the three sender
    planes in place (plain tensor code; a sender has one target per slot,
    so no inverse index is needed); on a member mesh they come back from
    the peers' ranks in one exact request/reply exchange
    (:func:`.ragged_a2a.fetch_rows`). ``recv_u``, ``recv_src`` and
    ``recv_m_p`` are folded in place. Returns (replies sent, rumor replies
    sent) as int32 scalars, counted over this rank's rows."""
    rows = _rows_here(state)
    R = state.infected_from.shape[1]
    F = p_all.shape[0]
    rev_ok = []
    for s in range(F):
        p_s = p_all[s].long()
        rev_u = fetch_uniform(state.tick, pull_salt(s), rows, p_s)
        rev_ok.append(ok_all[s] & (rev_u < (1.0 - loss_at(state, p_s, rows))))
    ctx = sharding.active()
    if ctx is not None:
        Wm, Wu = ym_p.shape[1], yu_p.shape[1]
        got = ctx.fetch_rows(torch.cat([ym_p, yu_p, state.infected_from], dim=1),
                             torch.where(torch.stack(rev_ok), p_all, -1))

        def peer(s):
            return got[s, :, Wm : Wm + Wu], got[s, :, :Wm], got[s, :, Wm + Wu :]
    else:
        def peer(s):
            p_s = p_all[s].long()
            return yu_p[p_s], ym_p[p_s], state.infected_from[p_s]

    sent = torch.zeros((), dtype=torch.int32, device=state.device)
    rumor_sent = torch.zeros((), dtype=torch.int32, device=state.device)
    for s in range(F):
        yu_r, ym_r, from_r = peer(s)
        reply_u = (
            unpack_bits(yu_r, R)
            & rev_ok[s][:, None]
            & (from_r != rows[:, None])
            & (state.rumor_origin[None, :] != rows[:, None])
        )
        recv_u |= reply_u
        maximum_into_(recv_src, recv_src, torch.where(reply_u, p_all[s].to(torch.int32)[:, None], -1))
        recv_m_p |= torch.where(rev_ok[s][:, None], ym_r, 0)
        sent += count_i32(rev_ok[s])
        rumor_sent += count_i32(reply_u)
    return sent, rumor_sent


def fd_trace(tgt, has_tgt, ack, direct_ok, suspect, relays, relay_valid, relay_ok) -> dict:
    """The FD phase's trace export (``suspect``: rows whose verdict raised
    a suspicion, the detection lineage's origin events) — shared by the
    three engines."""
    return {
        "tgt": tgt.to(torch.int32),
        "has_tgt": has_tgt,
        "ack": ack,
        "direct_ok": direct_ok,
        "suspect": suspect,
        "relays": relays.to(torch.int32),
        "relay_valid": relay_valid,
        "relay_ok": relay_ok,
    }


def sync_trace(caller, valid_c, peer, ok, req_acc, ack_acc) -> dict:
    """The SYNC phase's trace export (the compacted callers, their peers,
    the round trips, the records each side accepted) — shared by the
    three engines."""
    return {
        "caller": caller.to(torch.int32),
        "valid": valid_c,
        "peer": peer.to(torch.int32),
        "ok": ok,
        "req_acc": req_acc.to(torch.int32),
        "ack_acc": ack_acc.to(torch.int32),
    }


def no_props(state):
    """The empty proposal block of a phase that did not run: (subject, key,
    origin, valid) over the N rows, none valid."""
    n, dev = state.capacity, state.device
    z = torch.zeros((n,), dtype=torch.int32, device=dev)
    return (z, z, rows_of(state), torch.zeros((n,), dtype=torch.bool, device=dev))


def register_sus(state, sus_cand):
    """Suspicion-episode registration: raise each subject's episode key to
    ``sus_cand`` and stamp the tick where it rose."""
    new_sus = torch.maximum(state.sus_key, sus_cand)
    return state.replace(
        sus_key=new_sus,
        sus_since=torch.where(new_sus > state.sus_key, state.tick, state.sus_since).to(torch.int32),
    )


@functools.lru_cache(maxsize=None)
def seed_rows_tensor(seed_rows: tuple, device) -> torch.Tensor:
    """The seed rows on ``device``, made once: a copy from the host each
    tick would wait for the device."""
    return torch.tensor(seed_rows, dtype=torch.int32, device=device)


# -- host mutators of the shared leaves ---------------------------------------


def set_at(t: torch.Tensor, index, value) -> torch.Tensor:
    """Copy of ``t`` with ``t[index] = value`` (host mutators of these
    leaves are functional, like the JAX spelling they mirror)."""
    out = t.clone()
    out[index] = value
    return out


def announce(state, subject, key, origin):
    """Host-side membership-rumor allocation (join/leave/metadata paths),
    through the pool machinery: supersedes a weaker rumor about the same
    subject, evicts the most-covered majority-spread rumor when full."""
    dev = state.device

    def one(x):
        return torch.as_tensor(x, device=dev).reshape(1).to(torch.int32)

    ones = torch.ones((1,), dtype=torch.bool, device=dev)
    st, _a, _d, _e = allocate(state, one(subject), one(key), one(origin), ones, prio=ones)
    return st


def crash_row(state, row: int):
    return state.replace(up=set_at(state.up, row, False))


def crash_rows(state, rows):
    """Hard-kill of a whole crash cohort."""
    return state.replace(up=set_at(state.up, row_index(rows, state.device), False))


def spread_rumor(state, slot: int, origin: int):
    """Start a user rumor (Cluster.spreadGossip)."""
    infected = set_at(state.infected, (slice(None), slot), False)
    infected[origin, slot] = True
    return state.replace(
        rumor_active=set_at(state.rumor_active, slot, True),
        rumor_origin=set_at(state.rumor_origin, slot, origin),
        rumor_created=set_at(state.rumor_created, slot, state.tick),
        infected=infected,
        infected_at=set_at(state.infected_at, (origin, slot), state.tick),
        infected_from=set_at(state.infected_from, (slice(None), slot), -1),
    )


# -- the pending delivery rings (``params.delay_slots`` = D > 0) ---------------
#
# ``pending_minf`` [D, N, M] bool, ``pending_inf`` [D, N, R] bool and
# ``pending_src`` [D, N, R] int32 hold what lands at each receiver in a later
# tick: ring slot ``t % D`` is delivered in tick t and then cleared. Every
# write goes into the state's ring tensors in place (a tick or a mutator
# consumes its state), and the [N, M] membership passes run in row chunks.
# A ring cell's source is -1 wherever its infection bit is clear, and
# membership bits sit only in active pool columns: the allocation clears a
# superseded or evicted column, the rumor sweep a freed one.


def clear_pending_rows_(state, rows) -> None:
    """A (re)joined row has nothing in flight: its cells of the three rings
    are cleared in place."""
    if state.pending_minf.shape[0]:
        rows = row_index(rows, state.device)
        state.pending_minf.index_fill_(1, rows, False)
        state.pending_inf.index_fill_(1, rows, False)
        state.pending_src.index_fill_(1, rows, -1)


def pending_now_flags(state, D: int) -> tuple:
    """``(user, membership)``: 0-d bools, whether ring slot ``tick % D``
    holds a delivery (both False without rings)."""
    if not D:
        f = torch.zeros((), dtype=torch.bool, device=state.device)
        return f, f
    slot = state.tick % D
    return state.pending_inf[slot].any(), state.pending_minf[slot].any()


def receive_pending(state, D: int, user: bool, member: bool, recv_u, recv_src, recv_m_p):
    """Fold ring slot ``tick % D`` into this tick's receipts (``recv_*``
    are fresh tensors: the result of an OR and a max)."""
    slot = state.tick % D
    if user:
        recv_u = recv_u | state.pending_inf[slot]
        recv_src = torch.maximum(recv_src, state.pending_src[slot])
    if member:
        recv_m_p = recv_m_p | pack_bits(state.pending_minf[slot])
    return recv_u, recv_src, recv_m_p


def clear_pending_now_(state, D: int, user: bool, member: bool) -> None:
    """Clear the delivered ring slot in place (a slot whose flag was clear
    holds nothing to clear)."""
    slot = state.tick % D
    if user:
        state.pending_inf[slot].fill_(False)
        state.pending_src[slot].fill_(-1)
    if member:
        state.pending_minf[slot].fill_(False)


def delay_ticks(gossip_delay_t, qd, D: int) -> torch.Tensor:
    """[F, N] per-edge delay d with P(d >= k) = q^k, capped at D - 1, from
    the edges' delay draws (``gossip_delay_t`` [F, N]) and the links'
    geometric parameter ``qd`` (a scalar or [F, N]); each power its own f32
    product, in the JAX order."""
    d_all = torch.zeros(gossip_delay_t.shape, dtype=torch.int32, device=gossip_delay_t.device)
    qpow = qd
    for _ in range(1, D):
        d_all = d_all + (gossip_delay_t < qpow).to(torch.int32)
        qpow = qpow * qd
    return d_all


@functools.lru_cache(maxsize=None)
def _byte_cells(device) -> torch.Tensor:
    """[256] int64: byte value v -> its 8 bits as 8 bytes of 0 or 1, bit b
    in byte b (little-endian), made on ``device`` once."""
    v = torch.arange(256, dtype=torch.int64, device=device)
    return sum(((v >> b) & 1) << (8 * b) for b in range(8))


def or_words_(plane: torch.Tensor, words: torch.Tensor) -> None:
    """``plane |= unpack(words)`` in place: the bits of the int32 words [N, W]
    into the bool plane [N, M], over row chunks."""
    n, m = plane.shape
    wide = bytes64(plane) if m % 32 == 0 else None
    for lo, hi in plane_chunks(n, m):
        if wide is None:
            plane[lo:hi] |= unpack_bits(words[lo:hi], m)
        else:
            # byte k of word w (little-endian) holds cells 32w + 8k .. + 7,
            # which are int64 element 4w + k of the plane's row: one table
            # lookup per byte gives those eight cells
            byte = words[lo:hi].contiguous().view(torch.uint8)
            wide[lo:hi] |= _byte_cells(plane.device)[byte.long()]


def origin_words(state, n_words: int) -> torch.Tensor:
    """[N, W] int32: bit c set in row ``mr_origin[c]`` — the origin filter of
    a membership delivery, packed (the bits of one (row, word) are
    distinct, so adding them is OR-ing them)."""
    n = state.capacity
    m = state.mr_origin.shape[0]
    cols = torch.arange(m, device=state.device)
    vo = (state.mr_origin >= 0) & (state.mr_origin < n)
    flat = torch.zeros(((n + 1) * n_words,), dtype=torch.int32, device=state.device)
    flat.index_add_(
        0,
        torch.where(vo, state.mr_origin, n).long() * n_words + cols // 32,
        torch.ones((m,), dtype=torch.int32, device=state.device) << (cols % 32).to(torch.int32),
    )
    return flat.view(n + 1, n_words)[:n]


def origin_words_here(state, n_words: int) -> torch.Tensor:
    """:func:`origin_words` over the state's rows (on a member mesh, each
    pool column's origin bit at its local row on the rank that holds it)."""
    ctx = sharding.active()
    return origin_words(state if ctx is None else state.replace(mr_origin=state.mr_origin - ctx.lo), n_words)


def late_deliveries_(state, D: int, ok_all, d_all, p_all, ym_p, yu_p, user: bool, member: bool) -> None:
    """The delayed contacts of the gossip phase into the rings, per fanout
    slot s: the highest-row sender whose contact is late reaches each
    receiver, and its payload (the young user rumors and forwarding words
    of the sender planes ``yu_p`` / ``ym_p``, gathered in place) lands in
    slot ``(tick + d) % D`` under the receiver-side filters of an on-time
    delivery. ``user`` / ``member``: whether any user rumor / pool slot is
    active (a quiet payload writes nothing).

    The user rumors go in per fanout slot (the (slot, row) pairs of one
    fanout slot are distinct, so a gather, an OR and a put are exact). The
    membership words are filtered packed, OR-ed per delay d over the fanout
    slots (a ring cell is the OR of every contribution, in any order), and
    each d's words go into its ring slot in place.

    On a member mesh the late contacts cross to their receivers' ranks in
    one exact exchange (:func:`.ragged_a2a.late_exchange`), which elects the
    same winners there; each rank writes its own rows of the rings."""
    n = state.capacity
    rows = _rows_here(state)
    rows_l = torch.arange(n, dtype=torch.int64, device=state.device)
    R = state.infected.shape[1]
    ctx = sharding.active()
    late = []  # per slot: (winner row, has one, its d, its yu / ym / infected_from rows)
    if ctx is not None:
        Wm, Wu = ym_p.shape[1], yu_p.shape[1]
        sender, d_w, pl = ctx.late_exchange(torch.cat([ym_p, yu_p, state.infected_from], dim=1), p_all,
                                            ok_all & (d_all > 0), d_all)
        for s in range(p_all.shape[0]):
            late.append((sender[s].clamp(min=0), sender[s] >= 0, d_w[s],
                         lambda s=s: pl[s, :, Wm : Wm + Wu], lambda s=s: pl[s, :, :Wm],
                         lambda s=s: pl[s, :, Wm + Wu :]))
    else:
        for s in range(p_all.shape[0]):
            ok_late = ok_all[s] & (d_all[s] > 0)
            inv_l = torch.full((n,), -1, dtype=torch.int32, device=state.device)
            inv_l.scatter_reduce_(0, p_all[s].long(), torch.where(ok_late, rows, -1), "amax", include_self=True)
            jl = inv_l.clamp(min=0).long()
            late.append((jl, inv_l >= 0, d_all[s][jl], lambda jl=jl: yu_p[jl], lambda jl=jl: ym_p[jl],
                         lambda jl=jl: state.infected_from[jl]))
    if user:
        for jl, hasl, d_row, yu_rows, _ym, from_rows in late:
            late_u = (
                unpack_bits(yu_rows(), R)
                & hasl[:, None]
                & (from_rows() != rows[:, None])
                & (state.rumor_origin[None, :] != rows[:, None])
            )
            idx = (((state.tick + d_row) % D).long(), rows_l)
            state.pending_inf.index_put_(idx, state.pending_inf[idx] | late_u)
            src = state.pending_src[idx]
            state.pending_src.index_put_(idx, torch.maximum(src, torch.where(late_u, jl.to(torch.int32)[:, None], -1)))
    if not member:
        return
    not_origin = ~origin_words_here(state, ym_p.shape[1])
    words = [torch.where(hasl[:, None], ym_rows() & not_origin, 0) for _jl, hasl, _d, _yu, ym_rows, _f in late]
    del not_origin
    for d in range(1, D):
        acc = torch.zeros_like(words[0])
        for (_jl, _hasl, d_row, *_), w in zip(late, words):
            acc |= torch.where((d_row == d)[:, None], w, 0)
        or_words_(state.pending_minf[(state.tick + d) % D], acc)


# -- pool reductions and metrics ----------------------------------------------


def covered_columns(state) -> torch.Tensor:
    """[M] bool: every row has the rumor, is down, or joined after it was
    created (the early-free test) — reduced over row chunks."""
    cov = torch.ones(state.mr_active.shape, dtype=torch.bool, device=state.device)
    for lo, hi in row_chunks(state.capacity):
        cov &= (
            (state.minf_age[lo:hi] > 0)
            | ~state.up[lo:hi, None]
            | (state.joined_at[lo:hi, None] > state.mr_created[None, :])
        ).all(dim=0)
    return cov


def seg_m(state) -> torch.Tensor:
    """Membership-rumor segmentation per row, over row chunks: pool rumors
    a row misses although it holds a newer one."""
    out = []
    for lo, hi in row_chunks(state.capacity):
        age = state.minf_age[lo:hi]
        newest = torch.where(age > 0, state.mr_created[None, :], NEVER).amax(dim=1)
        out.append(
            (
                state.mr_active[None, :]
                & (age == 0)
                & (state.mr_created[None, :] < newest[:, None])
                & state.up[lo:hi, None]
            ).sum(dim=1, dtype=torch.int32)
        )
    return torch.cat(out)


def _no_reduce(x, op):
    return x


def rumor_metrics(state, params, n_up, reduce=_no_reduce) -> dict:
    """The state metrics both engines report: up count, pool occupancy,
    per-rumor coverage, and the gossip segmentation, whose membership part
    is scanned on sweep ticks only (a monitoring metric; one flag read
    there). ``reduce(x, op)``, on a member mesh, combines the rows' counts
    and maxima over the ranks (``n_up`` is then the global count)."""
    covered = reduce((state.infected & state.up[:, None]).sum(dim=0), "sum")
    coverage = covered.to(torch.float32) / (n_up.clamp(min=1).to(torch.float32))
    newest_u = torch.where(state.infected, state.rumor_created[None, :], NEVER).amax(dim=1)
    seg = (
        state.rumor_active[None, :]
        & ~state.infected
        & (state.rumor_created[None, :] < newest_u[:, None])
        & state.up[:, None]
    ).sum(dim=1, dtype=torch.int32)
    if state.tick % params.sweep_every == 0:
        (mr_any,) = host_flags(state.mr_active.any())
        if mr_any:
            seg = seg + seg_m(state)
    return {
        "n_up": n_up,
        "mr_active_count": count_i32(state.mr_active),
        "rumor_coverage": coverage,
        "gossip_segmentation": reduce(seg.max(), "max").to(torch.int32),
    }


# -- the window loop -------------------------------------------------------------


def phase(timer, name: str):
    """The phase-split profiler's scope around one tick phase
    (:mod:`..trace.profile`), or a no-op when no profile runs."""
    return contextlib.nullcontext() if timer is None else timer.phase(name)


def run_window(tick, view_rows, draw, state, draws, n_ticks: int, params, watch_rows=None, ad=None,
               trace=None, ring=None):
    """Run ``n_ticks`` of ``tick(state, fd, round, params)``.

    ``draws`` is either a ``torch.Generator`` on the state's device (the
    main path: each tick draws its uniforms with the engine's ``draw(gen,
    params, fd_due)`` — its round uniforms, and its FD uniforms on FD
    ticks) or a sequence of ``n_ticks`` ``(fd, round)`` draw pairs (moved to
    the state's device). Returns ``(state, metrics stacked to [n_ticks],
    watched)``; ``watched`` is ``view_rows(state, watch_rows)`` after each
    tick, stacked, or None. With ``ad`` (an adaptive plane) each tick runs
    as ``tick(..., ad=ad)`` and the return is ``(state, ad, metrics,
    watched)``. With ``trace`` (a :class:`..trace.schema.TraceSpec`) each
    tick runs as ``tick(..., trace=trace)`` and appends its record block
    to ``ring`` (a :class:`..trace.rings.TraceRing`) in place."""
    gen = draws if isinstance(draws, torch.Generator) else None
    if gen is not None and gen.device.type != state.device.type:
        raise ValueError(f"generator on {gen.device}, state on {state.device}")
    if gen is None and len(draws) != n_ticks:
        raise ValueError(f"{len(draws)} per-tick draws for a {n_ticks}-tick window")
    if (trace is None) != (ring is None):
        raise ValueError("a traced window needs both the trace spec and its ring")
    if trace is not None:
        from ..trace.capture import tracer_index

        tracer_index(trace, state.device)  # the tracer rows on the device, made before the ticks
    per_tick, watched = [], []
    for t in range(n_ticks):
        if gen is not None:
            fd, rd = draw(gen, params, (state.tick + 1) % params.fd_every == 0)
        else:
            fd, rd = draws[t]
            fd = None if fd is None else fd.to(state.device)
            rd = rd.to(state.device)
        if ad is not None:
            state, ad, m = tick(state, fd, rd, params, ad=ad)
        elif trace is not None:
            state, m = tick(state, fd, rd, params, trace=trace)
            ring.append(m.pop("_trace_rows"))
        else:
            state, m = tick(state, fd, rd, params)
        per_tick.append(m)
        if watch_rows is not None:
            watched.append(view_rows(state, watch_rows))
    ms = {k: torch.stack([m[k] for m in per_tick]) for k in per_tick[0]} if per_tick else {}
    watched = torch.stack(watched) if watch_rows is not None else None
    return (state, ms, watched) if ad is None else (state, ad, ms, watched)
