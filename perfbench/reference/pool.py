"""The bounded membership-rumor pool of the plain references: allocation of
new rumors from a tick's accepted-change proposals, shared by the sparse
and partial-view references as the engines share it.

The allocation is the protocol's sequential account (the JAX package's
``ops/sparse_oracle.py``, its announcement allocation): it runs on the
host over the few hundred entries of a tick, with the pool's leaves copied
there, and writes the [N, M] infection plane back on the state's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import I32, NO_CAND, blocks


def need_and_cover(st) -> tuple:
    """Per pool slot: members that need the rumor (up, not joined after it
    was created) and those of them that hold it. int64 numpy [M]."""
    m = st.mr_active.shape[0]
    need = torch.zeros((m,), dtype=torch.int64, device=st.up.device)
    cov = torch.zeros_like(need)
    for lo, hi in blocks(st.up.shape[0], m):
        needs = st.up[lo:hi, None] & ~(st.joined_at[lo:hi, None] > st.mr_created[None, :])
        need += needs.sum(dim=0)
        cov += (needs & (st.minf_age[lo:hi] > 0)).sum(dim=0)
    return need.cpu().numpy(), cov.cpu().numpy()


def allocate(st, entries, tick: int) -> dict:
    """Allocate pool slots to ``entries``, a list of (subject, key, origin,
    priority) in order, in place on ``st``. Batch duplicates of a subject
    resolve to the highest key (ties to the earliest entry); a subject
    already pooled is superseded in place by a higher key; a fresh subject
    takes the next free slot (ascending), non-priority ones only below 7/8
    occupancy; a priority entry that finds no free slot evicts the pooled
    rumor with the fewest uncovered needing members among those with a
    covered majority (ties to the lowest slot). Returns the counts and the
    positions (in ``entries``) that got no slot."""
    M = st.mr_active.shape[0]
    E = len(entries)
    active0 = st.mr_active.cpu().numpy()
    active = active0.copy()
    subject = st.mr_subject.cpu().numpy().copy()
    key = st.mr_key.cpu().numpy().copy()
    created = st.mr_created.cpu().numpy().copy()
    origin = st.mr_origin.cpu().numpy().copy()
    wins = []
    best: dict = {}
    for e, (s, k, _o, _p) in enumerate(entries):
        if s not in best or k > entries[best[s]][1]:
            best[s] = e
    for e, ent in enumerate(entries):
        if best[ent[0]] == e:
            wins.append((e, *ent))
    pool_by_subject = {int(subject[m]): m for m in range(M) if active[m]}
    pre_key = key.copy()
    free = [m for m in range(M) if not active[m]][:E]
    replace_tgt = {pool_by_subject[s] for _e, s, k, _o, _p in wins
                   if s in pool_by_subject and k > int(key[pool_by_subject[s]])}
    victims = None
    a0 = int(active0.sum())
    cap = (M * 7) // 8
    fi = vi = 0
    cleared, written, no_slot = [], [], []
    evicted = 0
    for e, s, k, o, pr in wins:
        if s in pool_by_subject:
            slot = pool_by_subject[s]
            if k <= int(pre_key[slot]):
                continue
            cleared.append(slot)
        else:
            r = fi
            fi += 1
            if r < len(free) and (pr or a0 + r < cap):
                slot = free[r]
            else:
                if pr and victims is None:
                    need, cov = need_and_cover(st)
                    victims = sorted((m for m in range(M) if active0[m] and m not in replace_tgt
                                      and 2 * cov[m] >= need[m]),
                                     key=lambda m: (need[m] - cov[m], m))[: min(E, M)]
                if pr and vi < len(victims):
                    slot = victims[vi]
                    vi += 1
                    evicted += 1
                    cleared.append(slot)
                else:
                    no_slot.append(e)
                    continue
        active[slot] = True
        subject[slot], key[slot], created[slot], origin[slot] = s, k, tick, o
        written.append((o, slot))
    dev = st.up.device
    if cleared:
        st.minf_age[:, torch.tensor(cleared, device=dev)] = 0
    if written:
        w = torch.tensor(written, dtype=torch.int64, device=dev)
        st.minf_age[w[:, 0], w[:, 1]] = 1
    for name, arr in (("mr_active", active), ("mr_subject", subject), ("mr_key", key),
                      ("mr_created", created), ("mr_origin", origin)):
        getattr(st, name).copy_(torch.as_tensor(arr, device=dev))
    return {"allocated": len(written), "evicted": evicted, "no_slot": no_slot}


def alloc_phase(st, proposals, E: int, tick: int) -> dict:
    """The tick's announcement allocation: ``proposals`` are (subject, key,
    origin, valid) blocks in order FD, expiry, refute, SYNC (the first three
    rank as priority). Proposals already covered by an equal or stronger
    pooled rumor are dropped first; the first E valid ones are allocated.
    Returns the allocation metrics."""
    n = st.up.shape[0]
    subj = torch.cat([p[0] for p in proposals]).to(torch.int64)
    key = torch.cat([p[1] for p in proposals]).to(I32)
    orig = torch.cat([p[2] for p in proposals]).to(torch.int64)
    valid = torch.cat([p[3] for p in proposals])
    pooled = torch.full((n,), NO_CAND, dtype=I32, device=key.device)
    act = st.mr_active
    pooled.scatter_reduce_(0, st.mr_subject[act].long(), st.mr_key[act], "amax", include_self=True)
    valid = valid & (key > pooled[subj.clamp(0, n - 1)])
    pos = torch.nonzero(valid)[:, 0]
    names = ("announce_dropped", "announce_dropped_fd", "announce_dropped_expiry",
             "announce_dropped_refute", "announce_dropped_sync", "announced", "pool_evicted")
    if pos.numel() == 0:
        return dict.fromkeys(names, 0)
    take = pos[:E]
    n_prio = sum(int(p[0].shape[0]) for p in proposals[:3])
    rows = torch.stack([subj[take], key[take].to(torch.int64), orig[take]], 1).cpu().tolist()
    take_h = take.cpu().tolist()
    entries = [(s, k, o, ci < n_prio) for (s, k, o), ci in zip(rows, take_h)]
    res = allocate(st, entries, tick)
    dropped = set(pos[E:].cpu().tolist()) | {take_h[e] for e in res["no_slot"]}
    ends = np.cumsum([int(p[0].shape[0]) for p in proposals])
    starts = [0, *ends[:-1]]
    seg = [sum(1 for d in dropped if lo <= d < hi) for lo, hi in zip(starts, ends)]
    return {
        "announce_dropped": int(pos.numel()) - len(take_h) + len(res["no_slot"]),
        "announce_dropped_fd": seg[0],
        "announce_dropped_expiry": seg[1],
        "announce_dropped_refute": seg[2],
        "announce_dropped_sync": seg[3],
        "announced": res["allocated"],
        "pool_evicted": res["evicted"],
    }
