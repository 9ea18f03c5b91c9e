"""The bounded membership-rumor pool: allocation of new rumors from a tick's
accepted-change proposals.

A port of the JAX package's sparse-engine pool machinery, which its pview
engine imports there, shared here by the pview and sparse engines:
``_allocate`` (supersede / fresh slot / priority eviction of the rumor
closest to done) and ``_alloc_phase`` (compaction of the tick's proposals
to ``announce_slots`` entries, pool dedup, per-source drop attribution).
A superseded or evicted slot's column of the pending membership ring
(``pending_minf``, when the engine runs the delay rings) is cleared in
place, as the JAX ``_allocate`` clears it. See ``ops/sparse.py`` of the JAX
package for the semantics and the deviations they implement.
"""

from __future__ import annotations

import numpy as np
import torch

from ._tensor import first_true, host_flags, keep_columns_, nonzero_fixed, put_drop_, row_chunks, scatter_reduce_1d
from .state import NO_CANDIDATE_I32

_I32_MIN = NO_CANDIDATE_I32


def _need_and_cover(state):
    """Per pool column: the members that need the rumor (up, and not joined
    after it was created) and those of them that hold it. Counted over row
    chunks in int32: summing the whole [N, M] bool plane would first widen
    it to int64 (16 GiB at a million rows)."""
    m = state.mr_active.shape[0]
    need_m = torch.zeros((m,), dtype=torch.int32, device=state.up.device)
    cov_m = torch.zeros_like(need_m)
    for lo, hi in row_chunks(state.capacity):
        needs = state.up[lo:hi, None] & (state.joined_at[lo:hi, None] <= state.mr_created[None, :])
        need_m += needs.sum(dim=0, dtype=torch.int32)
        cov_m += (needs & (state.minf_age[lo:hi] > 0)).sum(dim=0, dtype=torch.int32)
    return need_m, cov_m


def allocate(state, subj_p, key_p, orig_p, got, prio):
    """Allocate/supersede membership rumors for E compacted proposals.

    Pool invariant: active slots carry unique subjects. A proposal about an
    active subject with a strictly higher key supersedes the slot in place;
    fresh subjects take ascending free slots; batch duplicates resolve to
    the max key, ties to the earliest entry. A fresh PRIORITY winner that
    finds no free slot evicts the active rumor with the fewest
    still-uncovered needing members (ties to the lowest slot), among slots
    with a covered majority.

    Returns (state, allocated_count, no_slot_mask, evicted_count)."""
    E = subj_p.shape[0]
    M = state.mr_active.shape[0]
    dev = subj_p.device
    earange = torch.arange(E, device=dev)
    s = torch.where(got, subj_p, -9)
    same_s = s[:, None] == s[None, :]
    tie_earlier = earange[None, :] < earange[:, None]  # [e, e']: e' < e
    lose = (
        same_s
        & (
            (key_p[None, :] > key_p[:, None])
            | ((key_p[None, :] == key_p[:, None]) & tie_earlier)
        )
    ).any(dim=1)
    win = got & ~lose
    match = (s[:, None] == state.mr_subject[None, :]) & state.mr_active[None, :]
    has_match = match.any(dim=1)
    mslot = first_true(match, 1)
    replace = win & has_match & (key_p > state.mr_key[mslot])
    fresh = win & ~has_match
    rank = torch.cumsum(fresh, 0) - 1
    free = nonzero_fixed(~state.mr_active, E, M)
    slot_fresh = free[rank.clamp(0, E - 1)]
    ok_fresh = fresh & (slot_fresh < M)
    cap_npr = (M * 7) // 8
    a0 = state.mr_active.sum()
    ok_fresh = ok_fresh & (prio | (a0 + rank < cap_npr))
    need = fresh & ~ok_fresh & prio
    K = min(E, M)
    erank_raw = torch.cumsum(need, 0) - 1
    erank = erank_raw.clamp(0, K - 1)

    # with the rings, whether any column restarts (a supersede or an
    # eviction) rides the same read
    D = state.pending_minf.shape[0]
    if D:
        need_any, replace_any = host_flags(need.any(), replace.any())
    else:
        (need_any,) = host_flags(need.any())
        replace_any = False
    if need_any:
        need_m, cov_m = _need_and_cover(state)
        replace_tgt = torch.zeros((M + 1,), dtype=torch.bool, device=dev)
        replace_tgt.index_fill_(0, torch.where(replace, mslot, M), True)
        evictable = state.mr_active & ~replace_tgt[:M] & (2 * cov_m >= need_m)
        score = torch.where(evictable, cov_m - need_m, _I32_MIN)
        # jax.lax.top_k breaks ties toward the lower index: a stable
        # descending sort does the same
        vals, victims = torch.sort(score, descending=True, stable=True)
        vals, victims = vals[:K], victims[:K]
        ok_evict = need & (erank_raw < K) & (vals[erank] > _I32_MIN)
        slot_evict = victims[erank]
    else:
        ok_evict = torch.zeros((E,), dtype=torch.bool, device=dev)
        slot_evict = torch.full((E,), M, dtype=torch.int64, device=dev)

    do = replace | ok_fresh | ok_evict
    slot = torch.where(replace, mslot, slot_fresh.clamp(max=M - 1))
    slot = torch.where(ok_evict, slot_evict, slot)
    slot = torch.where(do, slot, M)
    # columns of superseded/evicted rumors restart uncovered
    clear_slot = torch.where(replace | ok_evict, slot, M + earange)
    # index_fill_, not `clear[clear_slot] = True`: setting a Python scalar
    # through an index copies it from the host, which waits for the device
    clear = torch.zeros((M + E,), dtype=torch.bool, device=dev)
    clear.index_fill_(0, clear_slot, True)
    age = state.minf_age.masked_fill(clear[None, :M], 0)
    if D and (need_any or replace_any):
        keep_columns_(state.pending_minf, ~clear[:M])
    put_drop_(age, (orig_p, slot), torch.ones((E,), dtype=torch.uint8, device=dev), slot < M)

    def _set(leaf, vals):
        buf = torch.cat([leaf, leaf[:1]])
        buf[slot] = vals.to(leaf.dtype)
        return buf[:M]

    st = state.replace(
        mr_active=_set(state.mr_active, torch.ones((E,), dtype=torch.bool, device=dev)),
        mr_subject=_set(state.mr_subject, s),
        mr_key=_set(state.mr_key, key_p),
        mr_created=_set(state.mr_created, torch.full((E,), state.tick, device=dev)),
        mr_origin=_set(state.mr_origin, orig_p),
        minf_age=age,
    )
    return (
        st,
        do.sum().to(torch.int32),
        fresh & ~ok_fresh & ~ok_evict,
        ok_evict.sum().to(torch.int32),
    )


_ALLOC_METRICS = (
    "announce_dropped",
    "announce_dropped_fd",
    "announce_dropped_expiry",
    "announce_dropped_refute",
    "announce_dropped_sync",
    "announced",
    "pool_evicted",
)


def alloc_phase(state, proposals, params):
    """Turn the tick's accepted-change proposals — (subject, key, origin,
    valid) from FD verdicts, suspicion expiries, refutations and SYNC
    re-gossip, in that order — into new membership rumors."""
    E = params.announce_slots
    n = state.capacity
    subject = torch.cat([p[0] for p in proposals])
    key = torch.cat([p[1] for p in proposals])
    origin = torch.cat([p[2] for p in proposals])
    valid = torch.cat([p[3] for p in proposals])
    pool_key_by_subject = scatter_reduce_1d(
        n,
        torch.where(state.mr_active, state.mr_subject, n),
        torch.where(state.mr_active, state.mr_key, NO_CANDIDATE_I32),
        "amax", NO_CANDIDATE_I32, torch.int32,
    )
    valid = valid & (key > pool_key_by_subject[subject.clamp(0, n - 1)])
    L = subject.shape[0]
    seg_ends = np.cumsum([int(p[0].shape[0]) for p in proposals])

    (any_valid,) = host_flags(valid.any())
    if not any_valid:
        z = torch.zeros((), dtype=torch.int32, device=subject.device)
        return state, {k: z for k in _ALLOC_METRICS}

    idx = nonzero_fixed(valid, E, L)
    got = idx < L
    idx = idx.clamp(max=L - 1)
    prio = got & (idx < int(seg_ends[2]))
    st, allocated, no_slot, evicted = allocate(
        state, subject[idx], key[idx], origin[idx], got, prio=prio
    )
    rank = torch.cumsum(valid, 0) - 1
    over = valid & (rank >= E)
    noslot_pos = scatter_reduce_1d(L, idx, no_slot & got, "amax", 0, torch.int32) > 0
    dropped_pos = over | noslot_pos
    seg_drops = [
        dropped_pos[lo:hi].sum().to(torch.int32)
        for lo, hi in zip([0, *seg_ends[:-1]], seg_ends)
    ]
    overflow = valid.sum() - got.sum()
    return st, {
        "announce_dropped": (overflow + no_slot.sum()).to(torch.int32),
        "announce_dropped_fd": seg_drops[0],
        "announce_dropped_expiry": seg_drops[1],
        "announce_dropped_refute": seg_drops[2],
        "announce_dropped_sync": seg_drops[3],
        "announced": allocated,
        "pool_evicted": evicted,
    }
