"""Plain reference of the partial-view SWIM engine: each member keeps a table
of ``view_slots`` neighbors (the first ``active_slots`` active, the rest a
passive reservoir) with their packed keys, and its own self record;
membership changes spread as rumors through the bounded pool.

Written from the protocol's account (the JAX package's
``ops/pview_oracle.py``, a per-member loop, whose tie-breaks it keeps:
first qualifying slot try, lowest matching or empty slot, the passive
entry with the lowest key evicted, the lowest eligible pool column per
apply pass, the highest caller slot per SYNC peer, step-order top-P
insertion) as whole-tensor PyTorch, so that it runs at a million members.
It imports nothing of the program under test and takes nothing it made:
it builds the warm overlay, applies the host mutations and steps the ticks
from the same seed-made inputs.

Covered: the warm start, the crash mutator, user rumors, and every phase
of the tick (FD over the active slots, the maintenance sweep with expiry,
purge and promotion, gossip with the A-pass membership apply, SYNC's
two-direction table merge, refute, the rumor sweeps, the pool allocation,
the state metrics) on scalar links without delay slots, with the push
strategy and no partitions, as the benchmark's configurations run them.

``drop_slot`` (the control) leaves out every gossip delivery of the last
fanout slot.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import pool
from .common import (
    I32,
    I64,
    NEVER,
    NO_CAND,
    RANK_ALIVE,
    RANK_DEAD,
    RANK_LEAVING,
    RANK_SUSPECT,
    SALT_GOSSIP,
    SALT_SYNC_ACK,
    SALT_SYNC_REQ,
    UNKNOWN_KEY,
    capped,
    draw_tick,
    fetch_uniform,
    register_suspicions,
    scatter_max,
)

KEY_DTYPES = {"i32": torch.int32, "i16": torch.int16}
LAYOUTS = {"i32": (21, 23), "i16": (9, 11)}  # (incarnation bits, epoch shift)


def sizes(cfg: dict) -> dict:
    """The static windows of a configuration: log2 N, the forwarding span,
    the sweep window, the suspicion timeout, the purge period, the pool."""
    n = cfg["capacity"]
    log2n = int(n).bit_length()
    sweep = 2 * (cfg["repeat_mult"] * log2n + 1)
    return {
        "log2n": log2n,
        "spread": cfg["repeat_mult"] * log2n,
        "sweep": sweep,
        "timeout": cfg["suspicion_mult"] * log2n * cfg["fd_every"],
        "purge_sweeps": max(1, -(-(cfg.get("tombstone_ticks", 0) or sweep) // cfg["sweep_every"])),
        "pool": cfg.get("mr_slots", 0) or min(2048, max(256, n // 32)),
    }


def warm_overlay(n: int, n_up: int, k: int) -> np.ndarray:
    """The warm start's tables: row i's slots hold i + c (mod n_up) for the
    chord offsets c — odd halvings of n_up / 2 first (the active slots),
    then 1, 2, 3, ... not taken yet; rows and offsets past n_up are
    empty (-1)."""
    offs: list = []
    step = n_up // 2
    while len(offs) < k and step > 1:
        c = step | 1
        if c < n_up and c not in offs:
            offs.append(c)
        step //= 2
    d = 1
    while len(offs) < k and len(offs) < n_up - 1:
        c = d % n_up
        if c and c not in offs:
            offs.append(c)
        d += 1
    while len(offs) < k:
        offs.append(n_up + len(offs))
    o = np.asarray(offs, np.int64)
    rows = np.arange(n)
    ids = (rows[:, None] + o[None, :]) % max(n_up, 1)
    ok = (rows[:, None] < n_up) & (o[None, :] < n_up)
    return np.where(ok, ids, -1).astype(np.int32)


def init_state(cfg: dict, n_up: int, device) -> types.SimpleNamespace:
    n, k, r = cfg["capacity"], cfg["view_slots"], cfg["rumor_slots"]
    m = sizes(cfg)["pool"]
    kdt = KEY_DTYPES[cfg.get("key_dtype", "i32")]
    if n_up > 1:
        ids = torch.as_tensor(warm_overlay(n, n_up, k), device=device)
    else:
        raise ValueError("the warm start needs two members up")
    up = torch.arange(n, device=device) < n_up
    g = cfg.get("partition_groups", 4)
    f32 = torch.float32
    return types.SimpleNamespace(
        tick=0,
        up=up,
        epoch=torch.zeros((n,), dtype=I32, device=device),
        joined_at=torch.zeros((n,), dtype=I32, device=device),
        self_key=torch.where(up, 0, UNKNOWN_KEY).to(I32),
        nbr_id=ids,
        nbr_key=torch.where(ids >= 0, 0, UNKNOWN_KEY).to(kdt),
        sus_key=torch.full((n,), NO_CAND, dtype=I32, device=device),
        sus_since=torch.full((n,), NEVER, dtype=I32, device=device),
        force_sync=torch.zeros((n,), dtype=torch.bool, device=device),
        leaving=torch.zeros((n,), dtype=torch.bool, device=device),
        mr_active=torch.zeros((m,), dtype=torch.bool, device=device),
        mr_subject=torch.full((m,), -1, dtype=I32, device=device),
        mr_key=torch.zeros((m,), dtype=I32, device=device),
        mr_created=torch.zeros((m,), dtype=I32, device=device),
        mr_origin=torch.zeros((m,), dtype=I32, device=device),
        minf_age=torch.zeros((n, m), dtype=torch.uint8, device=device),
        rumor_active=torch.zeros((r,), dtype=torch.bool, device=device),
        rumor_origin=torch.zeros((r,), dtype=I32, device=device),
        rumor_created=torch.zeros((r,), dtype=I32, device=device),
        infected=torch.zeros((n, r), dtype=torch.bool, device=device),
        infected_at=torch.zeros((n, r), dtype=I32, device=device),
        infected_from=torch.full((n, r), -1, dtype=I32, device=device),
        loss=torch.tensor(float(np.float32(cfg.get("loss", 0.0))), dtype=f32, device=device),
        delay_q=torch.tensor(0.0, dtype=f32, device=device),
        part_id=torch.zeros((n,), dtype=I32, device=device),
        part_loss=torch.zeros((g, g), dtype=f32, device=device),
        pending_minf=torch.zeros((0, n, m), dtype=torch.bool, device=device),
        pending_inf=torch.zeros((0, n, r), dtype=torch.bool, device=device),
        pending_src=torch.full((0, n, r), -1, dtype=I32, device=device),
    )


# -- host mutations ------------------------------------------------------------


def crash(st, rows: torch.Tensor) -> None:
    st.up[rows.to(st.up.device).long()] = False


def spread_rumor(st, slot: int, origin: int) -> None:
    st.rumor_active[slot] = True
    st.rumor_origin[slot] = origin
    st.rumor_created[slot] = st.tick
    st.infected[:, slot] = False
    st.infected[origin, slot] = True
    st.infected_at[origin, slot] = st.tick
    st.infected_from[:, slot] = -1


def apply(st, act: tuple, cfg: dict) -> None:
    """One host mutation of the traffic's schedule: ``("crash", rows)`` or
    ``("rumor", slot, origin)``; the partial-view engine has no batched
    join."""
    if act[0] == "crash":
        crash(st, torch.as_tensor(act[1]))
    elif act[0] == "rumor":
        spread_rumor(st, act[1], act[2])
    else:
        raise ValueError(f"the partial-view reference has no action {act[0]!r}")


def draws(gen: torch.Generator, st, cfg: dict):
    """The next tick's uniforms, laid out as the engine's window draws them
    (the sparse layout, read as active-slot indexes): (FD draws or None,
    round draws)."""
    return draw_tick(gen, st.up.shape[0], cfg["fanout"], cfg["ping_req_k"], cfg["sample_tries"],
                     (st.tick + 1) % cfg["fd_every"] == 0)


# -- links and records -------------------------------------------------------------


def _loss(st, i, j):
    return torch.maximum(st.loss, st.part_loss[st.part_id[i].long(), st.part_id[j].long()])


def _rt(st, i, j):
    return (1.0 - _loss(st, i, j)) * (1.0 - _loss(st, j, i))


def _pick_slots(st, u, n_picks: int, tries: int, ka: int):
    """Distinct active-slot picks per row by bounded rejection: the first
    of each pick's tries that holds a non-DEAD neighbor. Returns (slot,
    member, valid), slot and member clamped at 0."""
    slots = (u * float(ka)).to(I32).clamp(max=ka - 1)
    sid = st.nbr_id.gather(1, slots.long())
    skey = st.nbr_key.gather(1, slots.long()).to(I32)
    live = (sid >= 0) & ((skey & 3) != RANK_DEAD)
    picks = []
    for p in range(n_picks):
        sel = torch.full((u.shape[0],), -1, dtype=I32, device=u.device)
        for t in range(tries):
            c = slots[:, p * tries + t]
            ok = live[:, p * tries + t]
            for q in picks:
                ok = ok & (c != q)
            sel = torch.where((sel < 0) & ok, c, sel)
        picks.append(sel)
    slot = torch.stack(picks, 1)
    member = st.nbr_id.gather(1, slot.clamp(min=0).long()).clamp(min=0)
    return slot.clamp(min=0), member, slot >= 0


def _place(st, tick: int, rows, ids, keys, selfk, subj, cand, valid, salt: int, ka: int):
    """One record per row merged into that row's table (``ids``/``keys``
    int32 [R, k]) and self record: strictly higher; an unknown subject
    admits ALIVE and LEAVING only; ALIVE needs the metadata fetch. The
    row's own subject goes to the self record; a tabled subject is updated
    in its slot; a new one takes the first empty slot, else the passive
    slot with the lowest key. Returns (ids, keys, self, accepted); ``keys``
    hold the stored dtype's value."""
    n = st.up.shape[0]
    k = ids.shape[1]
    kdt = st.nbr_key.dtype
    sc = subj.clamp(0, n - 1).long()
    to_self = valid & (subj == rows)
    to_tab = valid & ~to_self & (subj >= 0)
    match = (ids == subj[:, None]) & to_tab[:, None]
    present = match.any(dim=1)
    slot_p = match.to(torch.uint8).argmax(dim=1)
    own = torch.where(to_self, selfk, torch.where(present, keys.gather(1, slot_p[:, None])[:, 0], UNKNOWN_KEY))
    fetch = ((cand & 3) != RANK_ALIVE) | (st.up[sc] & (fetch_uniform(tick, salt, rows, sc) < _rt(st, rows, sc)))
    acc = (to_self | to_tab) & (cand > own) & ((own >= 0) | ((cand & 3) <= RANK_LEAVING)) & fetch
    new_self = torch.where(acc & to_self, cand, selfk)
    empty = ids < 0
    slot_e = empty.to(torch.uint8).argmax(dim=1)
    slot_v = ka + keys[:, ka:].argmin(dim=1)
    slot = torch.where(present, slot_p, torch.where(empty.any(dim=1), slot_e, slot_v))
    put = (acc & to_tab)[:, None] & (torch.arange(k, device=ids.device)[None, :] == slot[:, None])
    stored = cand.to(kdt).to(I32)
    return (torch.where(put, subj[:, None], ids), torch.where(put, stored[:, None], keys), new_self, acc)


def _sus_of(n: int, acc, subj, cand):
    return scatter_max(n, subj.clamp(0, n - 1), cand, acc & ((cand & 3) == RANK_SUSPECT))


# -- the tick --------------------------------------------------------------------


def _fd(st, fd: dict, cfg: dict, t: int):
    n = st.up.shape[0]
    rows = torch.arange(n, dtype=I32, device=st.up.device)
    k, T, ka = cfg["ping_req_k"], cfg["sample_tries"], cfg["active_slots"]
    slot, member, valid = _pick_slots(st, fd["fd_try"], 1 + k, T, ka)
    tgt_slot, tgt = slot[:, 0].long(), member[:, 0].long()
    has = valid[:, 0] & st.up
    ack = st.up[tgt] & (fd["fd_direct"] < _rt(st, rows, tgt))
    for s in range(k):
        rl = member[:, 1 + s].long()
        p4 = _rt(st, rows, rl) * _rt(st, rl, tgt)
        ack = ack | (valid[:, 1 + s] & st.up[rl] & st.up[tgt] & (fd["fd_relay"][:, s] < p4))
    own = st.nbr_key.gather(1, tgt_slot[:, None])[:, 0].to(I32)
    cand = torch.where(ack, (st.self_key[tgt] >> 2) << 2, ((own >> 2) << 2) | RANK_SUSPECT).to(I32)
    accept = has & (cand > own)
    eff = capped(accept, min(n, cfg.get("fd_accept_slots", 0) or max(64, n // 16)))
    ri = rows.long()[eff]
    st.nbr_key[ri, tgt_slot[eff]] = cand[eff].to(st.nbr_key.dtype)
    register_suspicions(st.sus_key, st.sus_since, scatter_max(n, tgt, cand, eff & ~ack), t)
    mets = {"fd_probes": int(has.sum()), "fd_failed_probes": int((has & ~ack).sum()),
            "fd_new_suspects": int((eff & ~ack).sum())}
    return (tgt.to(I32), cand, rows, eff), mets


def _sweep(st, cfg: dict, t: int, z: dict):
    n = st.up.shape[0]
    dev = st.up.device
    k, ka = cfg["view_slots"], cfg["active_slots"]
    rows = torch.arange(n, dtype=I32, device=dev)
    props = (torch.zeros((n,), dtype=I32, device=dev),) * 2 + (rows, torch.zeros((n,), dtype=torch.bool, device=dev))
    if t % cfg["sweep_every"]:
        return props
    kdt = st.nbr_key.dtype
    if bool((st.sus_since > NEVER).any()):
        keys = st.nbr_key.to(I32)
        sid = st.nbr_id
        sc = sid.clamp(min=0).long()
        expired = ((sid >= 0) & ((keys & 3) == RANK_SUSPECT) & st.up[:, None]
                   & ((t - st.sus_since[sc]) >= z["timeout"]) & (keys <= st.sus_key[sc]))
        keys = keys + expired.to(I32)
        st.nbr_key = keys.to(kdt)
        self_exp = (st.up & ((st.self_key & 3) == RANK_SUSPECT) & ((t - st.sus_since) >= z["timeout"])
                    & (st.self_key <= st.sus_key))
        st.self_key = st.self_key + self_exp.to(I32)
        left = bool((((keys & 3) == RANK_SUSPECT) & st.up[:, None] & (sid >= 0)).any()) or bool(
            (((st.self_key & 3) == RANK_SUSPECT) & st.up).any())
        # each subject's lowest expiring row announces it, from its first
        # such slot
        first = torch.full((n + 1,), n, dtype=I64, device=dev)
        first.scatter_reduce_(0, torch.where(expired, sid.long(), n).reshape(-1),
                              rows.long()[:, None].expand(n, k).reshape(-1), "amin", include_self=True)
        mine = expired & (first[sc] == rows.long()[:, None])
        any_exp = mine.any(dim=1)
        col = mine.to(torch.uint8).argmax(dim=1)[:, None]
        props = (sid.gather(1, col)[:, 0].clamp(min=0), keys.gather(1, col)[:, 0], rows, any_exp)
        if not left:
            st.sus_key.fill_(NO_CAND)
            st.sus_since.fill_(NEVER)
    if (t // cfg["sweep_every"]) % z["purge_sweeps"] == 0:
        dead = (st.nbr_id >= 0) & ((st.nbr_key.to(I32) & 3) == RANK_DEAD)
        st.nbr_id = torch.where(dead, -1, st.nbr_id).to(I32)
        st.nbr_key = torch.where(dead, UNKNOWN_KEY, st.nbr_key.to(I32)).to(kdt)
    # promotion: each empty or DEAD active slot, ascending, swaps with the
    # live passive entry of the highest key
    ids, keys = st.nbr_id.clone(), st.nbr_key.to(I32)
    ar = torch.arange(n, device=dev)
    for a in range(ka):
        bad = (ids[:, a] < 0) | ((keys[:, a] & 3) == RANK_DEAD)
        live = (ids[:, ka:] >= 0) & ((keys[:, ka:] & 3) != RANK_DEAD)
        score = torch.where(live, keys[:, ka:], NO_CAND)
        j = ka + score.argmax(dim=1)
        do = bad & live.any(dim=1)
        r_ = ar[do]
        jd = j[do]
        ia, ka_ = ids[r_, a].clone(), keys[r_, a].clone()
        ids[r_, a], keys[r_, a] = ids[r_, jd], keys[r_, jd]
        ids[r_, jd], keys[r_, jd] = ia, ka_
    st.nbr_id, st.nbr_key = ids, keys.to(kdt)
    return props


def _gossip(st, rd: dict, cfg: dict, t: int, z: dict, drop_slot: bool):
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    F, T, ka, A = cfg["fanout"], cfg["sample_tries"], cfg["active_slots"], cfg.get("apply_slots", 8)
    M = st.mr_active.shape[0]
    spread = z["spread"]
    zero = dict.fromkeys(("gossip_msgs", "rumor_sends", "rumor_deliveries", "mr_deliveries", "mr_accepts"), 0)
    mr_any = bool(st.mr_active.any())
    if not (bool(st.rumor_active.any()) or mr_any):
        return zero
    if mr_any:
        age = st.minf_age
        st.minf_age = torch.where(age > 0, age.clamp(max=254) + 1, age).to(torch.uint8)
    young_u = st.infected & st.rumor_active[None, :] & ((t - st.infected_at) < spread)
    age = st.minf_age
    young_m = st.mr_active[None, :] & (age > 0) & (age <= min(spread, 255))
    sender_has = young_u.any(dim=1) | young_m.any(dim=1)
    _slot, peers, pvalid = _pick_slots(st, rd["gossip_try"], F, T, ka)
    sent = 0
    inv = []
    for s in range(F):
        p = peers[:, s].long()
        ok = pvalid[:, s] & sender_has & st.up & st.up[p] & (rd["gossip_edge"][:, s] < 1.0 - _loss(st, rows, p))
        sent += int(ok.sum())
        j = torch.full((n + 1,), -1, dtype=I32, device=dev)
        j.scatter_reduce_(0, torch.where(ok, p, n), rows, "amax", include_self=True)
        inv.append(j[:n])
    if drop_slot:
        inv = inv[:-1]
    recv_u = torch.zeros_like(st.infected)
    recv_src = torch.full_like(st.infected_from, -1)
    recv_m = torch.zeros((n, M), dtype=torch.bool, device=dev)
    rumor_sends = 0
    for j in inv:
        has = j >= 0
        jl = j.clamp(min=0).long()
        d = (young_u[jl] & has[:, None] & (st.infected_from[jl] != rows[:, None])
             & (st.rumor_origin[None, :] != rows[:, None]))
        recv_u |= d
        recv_src = torch.maximum(recv_src, torch.where(d, j[:, None], -1))
        rumor_sends += int(d.sum())
        recv_m |= young_m[jl] & has[:, None]
    del young_m
    newly_u = recv_u & ~st.infected & st.up[:, None] & st.rumor_active[None, :]
    st.infected = st.infected | newly_u
    st.infected_at = torch.where(newly_u, t, st.infected_at).to(I32)
    st.infected_from = torch.where(newly_u, recv_src, st.infected_from)
    mets = {"gossip_msgs": sent, "rumor_sends": rumor_sends, "rumor_deliveries": int(newly_u.sum()),
            "mr_deliveries": 0, "mr_accepts": 0}
    if not mr_any:
        return mets
    # A passes: each row takes its lowest still-eligible pool column, marks
    # it delivered, and merges its record into the current table
    elig = (recv_m & (st.minf_age == 0) & (st.mr_origin[None, :] != rows[:, None]) & st.mr_active[None, :]
            & st.up[:, None])
    del recv_m
    ids, keys = st.nbr_id, st.nbr_key.to(I32)
    sus = torch.full((n,), NO_CAND, dtype=I32, device=dev)
    cols = torch.arange(M, device=dev)
    for _ in range(A):
        got = elig.any(dim=1)
        col = torch.where(elig, cols[None, :], M).amin(dim=1).clamp(max=M - 1)
        elig[rows.long()[got], col[got]] = False
        st.minf_age[rows.long()[got], col[got]] = 1
        subj, cand = st.mr_subject[col], st.mr_key[col]
        ids, keys, st.self_key, acc = _place(st, t, rows, ids, keys, st.self_key, subj, cand, got, SALT_GOSSIP, ka)
        sus = torch.maximum(sus, _sus_of(n, acc, subj, cand))
        mets["mr_deliveries"] += int(got.sum())
        mets["mr_accepts"] += int(acc.sum())
    st.nbr_id, st.nbr_key = ids, keys.to(st.nbr_key.dtype)
    register_suspicions(st.sus_key, st.sus_since, sus, t)
    return mets


def _merge(st, t: int, dst, src, pre: tuple, salt: int, cfg: dict):
    """Rows ``dst`` merge the pre-exchange tables and self records of rows
    ``src``, one entry a step (the k slots, then the self record), each
    step on the tables the last one left. Returns (suspicions, top-P
    subjects [Q, P], top-P keys [Q, P])."""
    n = st.up.shape[0]
    P, ka = cfg["sync_announce"], cfg["active_slots"]
    pre_id, pre_key, pre_self = pre
    q = dst.shape[0]
    ids, keys, selfk = st.nbr_id[dst], st.nbr_key[dst].to(I32), st.self_key[dst]
    subj_steps = torch.cat([pre_id[src].T, src[None, :].to(I32)])
    cand_steps = torch.cat([pre_key[src].T, pre_self[src][None, :]])
    best_k = torch.full((q, P), NO_CAND, dtype=I32, device=dst.device)
    best_s = torch.zeros((q, P), dtype=I32, device=dst.device)
    sus = torch.full((n,), NO_CAND, dtype=I32, device=dst.device)
    d32 = dst.to(I32)
    for subj, cand in zip(subj_steps, cand_steps):
        ids, keys, selfk, acc = _place(st, t, d32, ids, keys, selfk, subj, cand, subj >= 0, salt, ka)
        sus = torch.maximum(sus, _sus_of(n, acc, subj, cand))
        ins_k, ins_s = torch.where(acc, cand, NO_CAND), subj
        for p in range(P):
            take = ins_k > best_k[:, p]
            ok_, os_ = best_k[:, p].clone(), best_s[:, p].clone()
            best_k[:, p] = torch.where(take, ins_k, ok_)
            best_s[:, p] = torch.where(take, ins_s, os_)
            ins_k, ins_s = torch.where(take, ok_, ins_k), torch.where(take, os_, ins_s)
    st.nbr_id[dst] = ids
    st.nbr_key[dst] = keys.to(st.nbr_key.dtype)
    st.self_key[dst] = selfk
    return sus, best_s, best_k


def _sync(st, rd: dict, cfg: dict, t: int):
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    K = min(n, cfg.get("sync_slots", 0) or n // cfg["sync_every"] + 32)
    P, T, ka = cfg["sync_announce"], cfg["sample_tries"], cfg["active_slots"]
    stagger = cfg.get("sync_stagger", 1)
    seeds = torch.tensor(list(cfg["seed_rows"]), dtype=I64, device=dev)
    S = seeds.shape[0]
    due_f = st.up & st.force_sync
    due_p = st.up & ~st.force_sync & (((t + rows.to(I64) * stagger) % cfg["sync_every"]) == 0)
    cf = due_f.nonzero()[:K, 0]
    callers = torch.cat([cf, due_p.nonzero()[:K, 0]])[:K]
    periodic = torch.arange(callers.shape[0], device=dev) >= cf.shape[0]
    # the peer: the first try over active slots and seeds that is live
    pool_n = ka + S
    tries = (rd["sync_try"][callers] * float(pool_n)).to(I32).clamp(max=pool_n - 1)
    is_seed = tries >= ka
    sl = tries.clamp(max=ka - 1).long()
    sid = st.nbr_id[callers].gather(1, sl)
    skey = st.nbr_key[callers].gather(1, sl).to(I32)
    spick = seeds[(tries - ka).clamp(0, S - 1).long()]
    member = torch.where(is_seed, spick, sid.clamp(min=0).to(I64))
    ok_try = (~is_seed & (sid >= 0) & ((skey & 3) != RANK_DEAD)) | (is_seed & (spick != callers[:, None]))
    peer = torch.full(callers.shape, -1, dtype=I64, device=dev)
    for i in range(T):
        peer = torch.where((peer < 0) & ok_try[:, i], member[:, i], peer)
    picked = peer >= 0
    fb = seeds[(rd["sync_fb"][callers] * float(S)).to(I32).clamp(max=S - 1).long()]
    use_fb = ~picked & (fb != callers)
    peer = torch.where(use_fb, fb, peer.clamp(min=0))
    picked = picked | use_fb
    Q = cfg.get("seed_sync_every", 4)
    rnd = (t + callers * stagger) // cfg["sync_every"]
    sidx = (callers + rnd // Q) % S
    sp = seeds[sidx]
    sp = torch.where(sp == callers, seeds[(sidx + 1) % S], sp)
    use_seed = ((rnd % Q) == 0) & (sp != callers) & periodic
    peer = torch.where(use_seed, sp, peer)
    picked = picked | use_seed
    ok = picked & st.up[peer] & (rd["sync_edge"][callers] < _rt(st, callers, peer))
    c, p = callers[ok], peer[ok]
    pre = (st.nbr_id.clone(), st.nbr_key.to(I32), st.self_key.clone())
    # REQ: each peer merges the caller of the highest slot that reached it
    win = torch.full((n + 1,), -1, dtype=I64, device=dev)
    win.scatter_reduce_(0, p, torch.arange(c.shape[0], device=dev), "amax", include_self=True)
    req_dst = torch.nonzero(win[:n] >= 0)[:, 0]
    req_src = c[win[req_dst]]
    sus_r, rs, rk = _merge(st, t, req_dst, req_src, pre, SALT_SYNC_REQ, cfg)
    # ACK: every caller merges its peer's pre-exchange entries
    order = torch.argsort(c)
    sus_a, as_, ak = _merge(st, t, c[order], p[order], pre, SALT_SYNC_ACK, cfg)
    register_suspicions(st.sus_key, st.sus_since, torch.maximum(sus_r, sus_a), t)
    st.force_sync[c] = False

    def props(dst, bs, bk):
        sub = torch.zeros((P, n), dtype=I32, device=dev)
        key = torch.full((P, n), NO_CAND, dtype=I32, device=dev)
        sub[:, dst] = bs.T
        key[:, dst] = bk.T
        return sub.reshape(-1), key.reshape(-1), rows.repeat(P), (key > NO_CAND).reshape(-1)

    pr, pa = props(req_dst, rs, rk), props(c[order], as_, ak)
    return tuple(torch.cat([x, y]) for x, y in zip(pr, pa)), {"sync_roundtrips": int(ok.sum())}


def _refute(st, cfg: dict):
    n = st.up.shape[0]
    rows = torch.arange(n, dtype=I32, device=st.up.device)
    inc_bits, shift = LAYOUTS[cfg.get("key_dtype", "i32")]
    mask = (1 << inc_bits) - 1
    d = st.self_key
    rank = d & 3
    need = st.up & ((rank == RANK_SUSPECT) | (rank == RANK_DEAD) | (st.leaving & (rank != RANK_LEAVING)))
    eff = capped(need, min(n, cfg.get("refute_slots", 0) or max(64, n // 16)))
    inc = (((d >> 2) & mask) + 1).clamp(max=mask)
    bumped = ((d >> shift) << shift) | (inc << 2) | torch.where(st.leaving, RANK_LEAVING, RANK_ALIVE)
    new = torch.where(eff, bumped, d).to(I32)
    st.self_key = new
    return rows, new, rows, eff


def _rumor_sweeps(st, t: int, z: dict) -> None:
    fwd_u = (st.infected & st.up[:, None] & ((t - st.infected_at) < z["spread"])).any(dim=0)
    st.rumor_active &= ((t - st.rumor_created) <= z["sweep"]) | fwd_u
    if not bool(st.mr_active.any()):
        return
    a = st.minf_age
    fwd_m = (st.up[:, None] & (a > 0) & (a <= min(z["spread"], 255))).any(dim=0)
    covered = ((a > 0) | ~st.up[:, None] | (st.joined_at[:, None] > st.mr_created[None, :])).all(dim=0)
    keep = (((t - st.mr_created) <= z["sweep"]) | fwd_m) & ~covered & st.mr_active
    freed = st.mr_active & ~keep
    st.mr_active.copy_(keep)
    st.mr_subject[freed] = -1
    st.minf_age[:, freed] = 0


def _state_metrics(st, cfg: dict, t: int) -> dict:
    n_up = int(st.up.sum())
    cov = (st.infected & st.up[:, None]).sum(dim=0).to(torch.float32) / torch.tensor(
        float(max(n_up, 1)), dtype=torch.float32, device=st.up.device)
    newest = torch.where(st.infected, st.rumor_created[None, :], NEVER).amax(dim=1)
    seg = (st.rumor_active[None, :] & ~st.infected & (st.rumor_created[None, :] < newest[:, None])
           & st.up[:, None]).sum(dim=1, dtype=I32)
    if t % cfg["sweep_every"] == 0 and bool(st.mr_active.any()):
        age = st.minf_age
        newest_m = torch.where(age > 0, st.mr_created[None, :], NEVER).amax(dim=1)
        seg += (st.mr_active[None, :] & (age == 0) & (st.mr_created[None, :] < newest_m[:, None])
                & st.up[:, None]).sum(dim=1, dtype=I32)
    return {"n_up": n_up, "mr_active_count": int(st.mr_active.sum()), "rumor_coverage": cov,
            "gossip_segmentation": int(seg.max()), "alive_view_fraction": 0.0, "false_suspect_pairs": 0}


def tick(st, fd, rd: dict, cfg: dict, drop_slot: bool = False) -> dict:
    """One gossip period, in place on ``st``: FD, the maintenance sweep,
    gossip, SYNC, refute, the rumor sweeps, the pool allocation, the
    metrics. Returns the tick's metrics."""
    st.tick += 1
    t = st.tick
    z = sizes(cfg)
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    fd_mets = dict.fromkeys(("fd_probes", "fd_failed_probes", "fd_new_suspects"), 0)
    props_fd = (torch.zeros((n,), dtype=I32, device=dev),) * 2 + (rows, torch.zeros((n,), dtype=torch.bool, device=dev))
    if t % cfg["fd_every"] == 0:
        props_fd, fd_mets = _fd(st, fd, cfg, t)
    props_exp = _sweep(st, cfg, t, z)
    g_mets = _gossip(st, rd, cfg, t, z, drop_slot)
    props_sync, s_mets = _sync(st, rd, cfg, t)
    props_ref = _refute(st, cfg)
    _rumor_sweeps(st, t, z)
    a_mets = pool.alloc_phase(st, (props_fd, props_exp, props_ref, props_sync), cfg["announce_slots"], t)
    return {**fd_mets, **g_mets, **s_mets, **a_mets, **_state_metrics(st, cfg, t)}
