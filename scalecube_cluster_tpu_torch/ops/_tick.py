"""What the pview and sparse engines share: both states carry the same
leaves under the same names and meanings for everything but the view
(``tick``, ``up``, ``sus_key``/``sus_since``, the membership-rumor pool
``mr_*``/``minf_age``, the user-rumor pool ``rumor_*``/``infected*``), so
the host mutators of those leaves, the pool's coverage and segmentation
reductions, the rumor metrics, the push-pull reply leg and the window loop
are written once here. Each engine module re-exports the mutators under
the JAX names."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dissemination.strategies import pull_salt
from ._tensor import host_flags, row_chunks
from .bitplane import unpack_bits
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


def pull_replies(state, ok_all, p_all, ym_p, yu_p, loss_at, recv_u, recv_src, recv_m_p):
    """The push-pull reply leg of the pview and sparse gossip phases
    (DZ-2): each sender whose undelayed contact in fanout slot s landed
    (``ok_all[s]``, peer ``p_all[s]``) pulls the peer's payload back over
    the same round trip, gated on one hashed draw on the reverse link
    (``loss_at(state, peer, sender)``): the peer's packed forwarding words
    (``ym_p``), its young user rumors (``yu_p``) less those the sender is
    known to hold. The peer rows are gathered from the three sender
    planes in place (plain tensor code; a sender has one target per slot,
    so no inverse index is needed). ``recv_u``, ``recv_src`` and
    ``recv_m_p`` are folded in place. Returns (replies sent, rumor replies
    sent) as int32 scalars."""
    rows = rows_of(state)
    R = state.infected_from.shape[1]
    sent = torch.zeros((), dtype=torch.int32, device=state.device)
    rumor_sent = torch.zeros((), dtype=torch.int32, device=state.device)
    for s in range(p_all.shape[0]):
        p_s = p_all[s].long()
        rev_u = fetch_uniform(state.tick, pull_salt(s), rows, p_s)
        rev_ok = ok_all[s] & (rev_u < (1.0 - loss_at(state, p_s, rows)))
        reply_u = (
            unpack_bits(yu_p[p_s], R)
            & rev_ok[:, None]
            & (state.infected_from[p_s] != rows[:, None])
            & (state.rumor_origin[None, :] != rows[:, None])
        )
        recv_u |= reply_u
        torch.maximum(recv_src, torch.where(reply_u, p_all[s].to(torch.int32)[:, None], -1), out=recv_src)
        recv_m_p |= ym_p[p_s].masked_fill_(~rev_ok[:, None], 0)
        sent += count_i32(rev_ok)
        rumor_sent += count_i32(reply_u)
    return sent, rumor_sent


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


def rumor_metrics(state, params, n_up) -> dict:
    """The state metrics both engines report: up count, pool occupancy,
    per-rumor coverage, and the gossip segmentation, whose membership part
    is scanned on sweep ticks only (a monitoring metric; one flag read
    there)."""
    coverage = (state.infected & state.up[:, None]).sum(dim=0).to(torch.float32) / (
        n_up.clamp(min=1).to(torch.float32)
    )
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
        "gossip_segmentation": seg.max().to(torch.int32),
    }


# -- the window loop -------------------------------------------------------------


def run_window(tick, view_rows, draw, state, draws, n_ticks: int, params, watch_rows=None, ad=None):
    """Run ``n_ticks`` of ``tick(state, fd, round, params)``.

    ``draws`` is either a ``torch.Generator`` on the state's device (the
    main path: each tick draws its uniforms with the engine's ``draw(gen,
    params, fd_due)`` — its round uniforms, and its FD uniforms on FD
    ticks) or a sequence of ``n_ticks`` ``(fd, round)`` draw pairs (moved to
    the state's device). Returns ``(state, metrics stacked to [n_ticks],
    watched)``; ``watched`` is ``view_rows(state, watch_rows)`` after each
    tick, stacked, or None. With ``ad`` (an adaptive plane) each tick runs
    as ``tick(..., ad=ad)`` and the return is ``(state, ad, metrics,
    watched)``."""
    gen = draws if isinstance(draws, torch.Generator) else None
    if gen is not None and gen.device.type != state.device.type:
        raise ValueError(f"generator on {gen.device}, state on {state.device}")
    if gen is None and len(draws) != n_ticks:
        raise ValueError(f"{len(draws)} per-tick draws for a {n_ticks}-tick window")
    per_tick, watched = [], []
    for t in range(n_ticks):
        if gen is not None:
            fd, rd = draw(gen, params, (state.tick + 1) % params.fd_every == 0)
        else:
            fd, rd = draws[t]
            fd = None if fd is None else fd.to(state.device)
            rd = rd.to(state.device)
        if ad is None:
            state, m = tick(state, fd, rd, params)
        else:
            state, ad, m = tick(state, fd, rd, params, ad=ad)
        per_tick.append(m)
        if watch_rows is not None:
            watched.append(view_rows(state, watch_rows))
    ms = {k: torch.stack([m[k] for m in per_tick]) for k in per_tick[0]} if per_tick else {}
    watched = torch.stack(watched) if watch_rows is not None else None
    return (state, ms, watched) if ad is None else (state, ad, ms, watched)
