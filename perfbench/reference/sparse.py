"""Plain reference of the sparse SWIM engine: one [N, N] view of packed
precedence keys, membership changes spread as rumors through a bounded
pool.

Written from the protocol's account (the JAX package's
``ops/sparse_oracle.py``, a per-member loop, whose tie-breaks it keeps:
first qualifying rejection try, highest-row sender per fanout slot, first
V accepting rows, lowest expiring row per subject, earliest of equal
proposals, ascending free slots) as whole-tensor PyTorch over row blocks,
so that it runs at the benchmark's sizes. It imports nothing of the
program under test and takes nothing the program made: it builds the
start state, applies the host mutations and steps the ticks from the same
seed-made inputs (sizes, schedule, the draw generator's seed).

Covered: the warm start, the crash and join mutators, user rumors, and
every phase of the tick (FD, suspicion sweep, gossip with the membership
apply, SYNC, refute, the rumor sweeps, the pool allocation and the state
metrics) on scalar links without delay slots, the push strategy and no
namespaces, as the benchmark's configurations run them.

``drop_slot`` (the control) leaves out every gossip delivery of the last
fanout slot: the configuration's fanout broken, everything else exact.
"""

from __future__ import annotations

import types

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
    EPOCH_SHIFT_I32,
    bit_length,
    blocks,
    capped,
    fetch_uniform,
    live_count,
    draw_tick,
    pick_distinct,
    register_suspicions,
    scatter_max,
)


def init_state(cfg: dict, n_up: int, device) -> types.SimpleNamespace:
    """The warm start: rows below ``n_up`` up, each knowing every up row
    ALIVE at incarnation 0; nothing pooled, no rumor."""
    n, m, r = cfg["capacity"], cfg["mr_slots"], cfg["rumor_slots"]
    up = torch.arange(n, device=device) < n_up
    vk = torch.full((n, n), UNKNOWN_KEY, dtype=I32, device=device)
    vk[:n_up, :n_up] = 0
    f32 = torch.float32
    loss = torch.tensor(float(cfg.get("loss", 0.0)), dtype=f32, device=device)
    return types.SimpleNamespace(
        tick=0,
        up=up,
        epoch=torch.zeros((n,), dtype=I32, device=device),
        joined_at=torch.zeros((n,), dtype=I32, device=device),
        view_key=vk,
        n_live=torch.where(up, n_up, 0).to(I32),
        sus_key=torch.full((n,), NO_CAND, dtype=I32, device=device),
        sus_since=torch.full((n,), NEVER, dtype=I32, device=device),
        force_sync=torch.zeros((n,), dtype=torch.bool, device=device),
        leaving=torch.zeros((n,), dtype=torch.bool, device=device),
        ns_id=torch.zeros((n,), dtype=I32, device=device),
        ns_rel=torch.ones((1, 1), dtype=torch.bool, device=device),
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
        loss=loss,
        fetch_rt=(1.0 - loss) * (1.0 - loss),
        delay_q=torch.tensor(0.0, dtype=f32, device=device),
        pending_minf=torch.zeros((0, n, m), dtype=torch.bool, device=device),
        pending_inf=torch.zeros((0, n, r), dtype=torch.bool, device=device),
        pending_src=torch.full((0, n, r), -1, dtype=I32, device=device),
    )


# -- host mutations ------------------------------------------------------------


def crash(st, rows: torch.Tensor) -> None:
    """Hard kill: the rows go down; nothing else changes."""
    st.up[rows.to(st.up.device).long()] = False


def join(st, rows: torch.Tensor, seed_rows, cfg: dict) -> None:
    """A burst of joins of distinct rows: each comes up knowing itself and
    the seeds ALIVE at incarnation 0 (a reused row at the next epoch, so it
    is a new identity), is forced to SYNC, and self-announces through the
    pool with priority."""
    dev = st.up.device
    rows = rows.to(dev).long()
    seeds = torch.tensor(list(seed_rows), dtype=I64, device=dev)
    used = st.view_key[rows, rows] >= 0
    epoch = torch.where(used, (st.epoch[rows] + 1) & 0xFF, st.epoch[rows]).to(I32)
    st.epoch[rows] = epoch
    self_key = (epoch << EPOCH_SHIFT_I32).to(I32)
    k = rows.shape[0]
    table = torch.full((k, st.view_key.shape[1]), UNKNOWN_KEY, dtype=I32, device=dev)
    table[:, seeds] = ((st.epoch[seeds] & 0xFF) << EPOCH_SHIFT_I32).to(I32)[None, :]
    table[torch.arange(k, device=dev), rows] = self_key
    st.view_key[rows] = table
    st.n_live[rows] = live_count(table)
    st.up[rows] = True
    st.joined_at[rows] = st.tick
    st.force_sync[rows] = True
    st.leaving[rows] = False
    st.minf_age[rows] = 0
    st.infected[rows] = False
    st.infected_from[rows] = -1
    keys = self_key.cpu().tolist()
    pool.allocate(st, [(r, kk, r, True) for r, kk in zip(rows.cpu().tolist(), keys)], st.tick)


def spread_rumor(st, slot: int, origin: int) -> None:
    """A user rumor starts at ``origin`` in ``slot`` (replacing whatever
    the slot carried)."""
    st.rumor_active[slot] = True
    st.rumor_origin[slot] = origin
    st.rumor_created[slot] = st.tick
    st.infected[:, slot] = False
    st.infected[origin, slot] = True
    st.infected_at[origin, slot] = st.tick
    st.infected_from[:, slot] = -1


def apply(st, act: tuple, cfg: dict) -> None:
    """One host mutation of the traffic's schedule: ``("crash", rows)``,
    ``("join", rows)`` or ``("rumor", slot, origin)``."""
    if act[0] == "crash":
        crash(st, torch.as_tensor(act[1]))
    elif act[0] == "join":
        join(st, torch.as_tensor(act[1]), cfg["seed_rows"], cfg)
    elif act[0] == "rumor":
        spread_rumor(st, act[1], act[2])
    else:
        raise ValueError(f"the sparse reference has no action {act[0]!r}")


def draws(gen: torch.Generator, st, cfg: dict):
    """The next tick's uniforms, laid out as the engine's window draws
    them: (FD draws or None, round draws)."""
    return draw_tick(gen, st.up.shape[0], cfg["fanout"], cfg["ping_req_k"], cfg["sample_tries"],
                     (st.tick + 1) % cfg["fd_every"] == 0)


# -- the tick --------------------------------------------------------------------


def _fd(st, fd: dict, cfg: dict, t: int):
    n = st.up.shape[0]
    rows = torch.arange(n, dtype=I32, device=st.up.device)
    rl = rows.long()
    k, T = cfg["ping_req_k"], cfg["sample_tries"]
    vk = st.view_key
    sel = pick_distinct(lambda c: (vk.gather(1, c.long()) & 3) != RANK_DEAD, rows, fd["fd_try"], n, 1 + k, T)
    has = (sel[:, 0] >= 0) & st.up
    tgt = sel[:, 0].clamp(min=0).long()
    rt = st.fetch_rt
    ack = st.up[tgt] & (fd["fd_direct"] < rt)
    for s in range(k):
        relay = sel[:, 1 + s]
        ack = ack | ((relay >= 0) & st.up[relay.clamp(min=0).long()] & st.up[tgt] & (fd["fd_relay"][:, s] < rt * rt))
    own = vk[rl, tgt]
    cand = torch.where(ack, (vk[tgt, tgt] >> 2) << 2, ((own >> 2) << 2) | RANK_SUSPECT).to(I32)
    accept = has & (cand > own)
    eff = capped(accept, min(n, cfg.get("fd_accept_slots", 0) or max(64, n // 16)))
    vk[rl[eff], tgt[eff]] = cand[eff]
    register_suspicions(st.sus_key, st.sus_since, scatter_max(n, tgt, cand, eff & ~ack), t)
    mets = {"fd_probes": int(has.sum()), "fd_failed_probes": int((has & ~ack).sum()),
            "fd_new_suspects": int((eff & ~ack).sum())}
    return (tgt.to(I32), cand, rows, eff), mets


def _sweep(st, cfg: dict, t: int):
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    none = (torch.zeros((n,), dtype=I32, device=dev),) * 2 + (rows, torch.zeros((n,), dtype=torch.bool, device=dev))
    if t % cfg["sweep_every"] or not bool((st.sus_since > NEVER).any()):
        return none
    timeout = cfg["suspicion_mult"] * bit_length(st.n_live) * cfg["fd_every"]
    waited = t - st.sus_since
    first = torch.full((n,), n, dtype=I64, device=dev)
    gone = torch.zeros((n,), dtype=I32, device=dev)
    left = False
    for lo, hi in blocks(n, n):
        blk = st.view_key[lo:hi]
        expired = (
            ((blk & 3) == RANK_SUSPECT)
            & st.up[lo:hi, None]
            & (waited[None, :] >= timeout[lo:hi, None])
            & (blk <= st.sus_key[None, :])
        )
        blk += expired.to(I32)
        gone[lo:hi] = expired.sum(dim=1, dtype=I32)
        left = left or bool((((blk & 3) == RANK_SUSPECT) & st.up[lo:hi, None]).any())
        idx = torch.arange(lo, hi, dtype=I64, device=dev)[:, None]
        first = torch.minimum(first, torch.where(expired, idx, n).amin(dim=0))
    st.n_live -= gone
    # each subject's lowest expiring row announces it; a row announcing
    # several announces the lowest subject
    col = torch.full((n + 1,), n, dtype=I64, device=dev)
    col.scatter_reduce_(0, first, torch.arange(n, dtype=I64, device=dev), "amin", include_self=True)
    col = col[:n]
    any_exp = col < n
    col = torch.where(any_exp, col, 0)
    key = st.view_key[rows.long(), col]
    if not left:
        st.sus_key.fill_(NO_CAND)
        st.sus_since.fill_(NEVER)
    return col.to(I32), key, rows, any_exp


def _gossip(st, rd: dict, cfg: dict, t: int, drop_slot: bool):
    """Returns (metrics, covered or None); ``covered`` (the early-free test
    after the apply) is None when the pool was empty."""
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    F, T, M = cfg["fanout"], cfg["sample_tries"], cfg["mr_slots"]
    zero = dict.fromkeys(("gossip_msgs", "rumor_sends", "rumor_deliveries", "mr_deliveries", "mr_accepts"), 0)
    mr_any = bool(st.mr_active.any())
    if not (bool(st.rumor_active.any()) or mr_any):
        return zero, None
    if mr_any:
        age = st.minf_age
        st.minf_age = torch.where(age > 0, age.clamp(max=254) + 1, age).to(torch.uint8)
    spread = cfg["repeat_mult"] * bit_length(st.n_live)
    vk = st.view_key
    peers = pick_distinct(lambda c: (vk.gather(1, c.long()) & 3) != RANK_DEAD, rows, rd["gossip_try"], n, F, T)
    young_u = st.infected & st.rumor_active[None, :] & ((t - st.infected_at) < spread[:, None])
    young_m = torch.zeros((n, M), dtype=torch.bool, device=dev)
    for lo, hi in blocks(n, M):
        a = st.minf_age[lo:hi].to(I32)
        young_m[lo:hi] = st.mr_active[None, :] & (a > 0) & (a <= spread[lo:hi, None])
    sender_has = young_u.any(dim=1) | young_m.any(dim=1)
    sent = 0
    inv = []
    for s in range(F):
        p = peers[:, s]
        pl = p.clamp(min=0).long()
        ok = (p >= 0) & sender_has & st.up & st.up[pl] & (rd["gossip_edge"][:, s] < 1.0 - st.loss)
        sent += int(ok.sum())
        # several senders at one receiver: the highest row wins the slot
        j = torch.full((n + 1,), -1, dtype=I32, device=dev)
        j.scatter_reduce_(0, torch.where(ok, pl, n), rows, "amax", include_self=True)
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
        for lo, hi in blocks(n, M):
            recv_m[lo:hi] |= young_m[jl[lo:hi]] & has[lo:hi, None]
    del young_m
    newly_u = recv_u & ~st.infected & st.up[:, None] & st.rumor_active[None, :]
    st.infected = st.infected | newly_u
    st.infected_at = torch.where(newly_u, t, st.infected_at).to(I32)
    st.infected_from = torch.where(newly_u, recv_src, st.infected_from)
    mets = {"gossip_msgs": sent, "rumor_sends": rumor_sends, "rumor_deliveries": int(newly_u.sum()),
            "mr_deliveries": 0, "mr_accepts": 0}
    if not mr_any:
        return mets, None
    subj = st.mr_subject.clamp(min=0).long()
    cand = st.mr_key
    c_rank = cand & 3
    rt = st.fetch_rt
    sus_cand = torch.full((n,), NO_CAND, dtype=I32, device=dev)
    for lo, hi in blocks(n, M):
        newly = (recv_m[lo:hi] & (st.mr_origin[None, :] != rows[lo:hi, None]) & st.up[lo:hi, None]
                 & st.mr_active[None, :] & (st.minf_age[lo:hi] == 0))
        st.minf_age[lo:hi][newly] = 1
        mets["mr_deliveries"] += int(newly.sum())
        own = vk[lo:hi].gather(1, subj[None, :].expand(hi - lo, M))
        u = fetch_uniform(t, SALT_GOSSIP, rows[lo:hi, None], subj[None, :])
        fetch_ok = (c_rank != RANK_ALIVE)[None, :] | (st.up[subj][None, :] & (u < rt))
        accept = newly & (cand[None, :] > own) & ((own >= 0) | (c_rank <= RANK_LEAVING)[None, :]) & fetch_ok
        i_acc, m_acc = accept.nonzero(as_tuple=True)
        vk[lo + i_acc, subj[m_acc]] = cand[m_acc]
        st.n_live[lo:hi] += ((accept & (c_rank != RANK_DEAD)[None, :]).sum(dim=1, dtype=I32)
                             - (accept & ((own & 3) != RANK_DEAD)).sum(dim=1, dtype=I32))
        mets["mr_accepts"] += int(accept.sum())
        sus = accept & (c_rank == RANK_SUSPECT)[None, :]
        sus_cand = torch.maximum(sus_cand, scatter_max(n, subj, cand, sus.any(dim=0)))
    register_suspicions(st.sus_key, st.sus_since, sus_cand, t)
    covered = torch.ones((M,), dtype=torch.bool, device=dev)
    for lo, hi in blocks(n, M):
        covered &= ((st.minf_age[lo:hi] > 0) | ~st.up[lo:hi, None]
                    | (st.joined_at[lo:hi, None] > st.mr_created[None, :])).all(dim=0)
    return mets, covered


def _gates(cand, own, up, tick: int, salt: int, i, cols, rt):
    """The merge gates of a candidate key over a receiver's own: strictly
    higher; an unknown subject admits ALIVE and LEAVING only; an ALIVE
    record needs the metadata fetch to succeed (subject up, hashed draw)."""
    fetch = ((cand & 3) != RANK_ALIVE) | (up[cols][None, :] & (fetch_uniform(tick, salt, i, cols[None, :]) < rt))
    return (cand > own) & ((own >= 0) | ((cand & 3) <= RANK_LEAVING)) & fetch


def _top(rows_acc: torch.Tensor, P: int):
    """The top-P accepted keys of each row (ties to the lowest column):
    [P, Q] columns and keys."""
    rem = rows_acc.clone()
    cols, keys = [], []
    for _ in range(P):
        c = rem.argmax(dim=1)
        cols.append(c)
        keys.append(rem.gather(1, c[:, None])[:, 0])
        rem.scatter_(1, c[:, None], NO_CAND)
    return torch.stack(cols), torch.stack(keys)


def _sync(st, rd: dict, cfg: dict, t: int):
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    K = min(n, cfg.get("sync_slots", 0) or n // cfg["sync_every"] + 32)
    P = cfg["sync_announce"]
    T = cfg["sample_tries"]
    due_f = st.up & st.force_sync
    due_p = st.up & ~st.force_sync & (((t + rows.to(I64) * cfg.get("sync_stagger", 1)) % cfg["sync_every"]) == 0)
    callers = torch.cat([due_f.nonzero()[:K, 0], due_p.nonzero()[:K, 0]])[:K]
    vk = st.view_key
    seeds = torch.tensor(list(cfg["seed_rows"]), dtype=I64, device=dev)
    seed_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    seed_mask[seeds] = True
    c32 = callers.to(I32)
    pick = pick_distinct(lambda c: (vk[callers[:, None], c.long()] & 3) != RANK_DEAD, c32,
                         rd["sync_try"][callers], n, 1, T, extra=seed_mask)[:, 0]
    S = seeds.shape[0]
    fb = seeds[(rd["sync_fb"][callers] * float(S)).to(I32).clamp(max=S - 1).long()]
    use_fb = (pick < 0) & (fb != callers)
    peer = torch.where(use_fb, fb, pick.to(I64))
    ok = ((pick >= 0) | use_fb) & st.up[peer.clamp(min=0)] & (rd["sync_edge"][callers] < st.fetch_rt)
    slot = torch.arange(callers.shape[0], device=dev)[ok]
    c, p = callers[ok], peer[ok]
    q = c.shape[0]
    cols = torch.arange(n, dtype=I64, device=dev)
    # REQ: each peer merges the tables of every caller that reached it
    pre_c = vk[c]
    uniq, grp = torch.unique(p, return_inverse=True)
    merged = vk[uniq]
    own_p = merged.clone()
    merged.scatter_reduce_(0, grp[:, None].expand(q, n), pre_c, "amax", include_self=True)
    acc_p = _gates(merged, own_p, st.up, t, SALT_SYNC_REQ, uniq[:, None], cols, st.fetch_rt)
    new_p = torch.where(acc_p, merged, own_p)
    vk[uniq] = new_p
    st.n_live[uniq] += live_count(new_p) - live_count(own_p)
    sus = torch.where(acc_p & ((merged & 3) == RANK_SUSPECT), merged, NO_CAND).amax(dim=0)
    # each peer re-gossips from the first slot that reached it
    first_slot = torch.full((uniq.shape[0],), K, dtype=I64, device=dev).scatter_reduce_(
        0, grp, slot, "amin", include_self=True)
    props_p = torch.where(acc_p, merged, NO_CAND)
    del merged, own_p, pre_c
    # ACK: the peer's merged row back to the caller
    ack = vk[p]
    own_c = vk[c]
    acc_c = _gates(ack, own_c, st.up, t, SALT_SYNC_ACK, c[:, None], cols, st.fetch_rt)
    new_c = torch.where(acc_c, ack, own_c)
    vk[c] = new_c
    st.n_live[c] += live_count(new_c) - live_count(own_c)
    sus = torch.maximum(sus, torch.where(acc_c & ((ack & 3) == RANK_SUSPECT), ack, NO_CAND).amax(dim=0))
    props_c = torch.where(acc_c, ack, NO_CAND)
    del ack, own_c, new_c
    register_suspicions(st.sus_key, st.sus_since, sus, t)
    st.force_sync[c] = False

    def layout(owner, acc, at):
        """[P * K] proposals, iteration-major over the K caller slots, the
        owner's top-P accepted keys at its slot ``at``."""
        sub = torch.zeros((P, K), dtype=I32, device=dev)
        key = torch.zeros((P, K), dtype=I32, device=dev)
        org = torch.zeros((P, K), dtype=I32, device=dev)
        val = torch.zeros((P, K), dtype=torch.bool, device=dev)
        if owner.shape[0]:
            cs, ks = _top(acc, P)
            sub[:, at] = cs.to(I32)
            key[:, at] = ks
            org[:, at] = owner.to(I32)[None, :]
            val[:, at] = ks > NO_CAND
        return sub.reshape(-1), key.reshape(-1), org.reshape(-1), val.reshape(-1)

    pp = layout(uniq, props_p, first_slot)
    pc = layout(c, props_c, slot)
    props = tuple(torch.cat([a, b]) for a, b in zip(pp, pc))
    return props, {"sync_roundtrips": q}


def _refute(st, cfg: dict):
    n = st.up.shape[0]
    rows = torch.arange(n, dtype=I32, device=st.up.device)
    diag = st.view_key.diagonal()
    d = diag.clone()
    rank = d & 3
    need = st.up & ((rank == RANK_SUSPECT) | (rank == RANK_DEAD) | (st.leaving & (rank != RANK_LEAVING)))
    eff = capped(need, min(n, cfg.get("refute_slots", 0) or max(64, n // 16)))
    new = torch.where(eff, (((d >> 2) + 1) << 2) | torch.where(st.leaving, RANK_LEAVING, RANK_ALIVE), d).to(I32)
    diag.copy_(new)
    st.n_live += (eff & (rank == RANK_DEAD)).to(I32)
    return rows, new, rows, eff


def _rumor_sweeps(st, cfg: dict, t: int, covered) -> int:
    n_up = int(st.up.sum())
    rm = cfg["repeat_mult"]
    sweep = 2 * (rm * int(bit_length(torch.tensor([n_up]))[0]) + 1)
    spread = rm * bit_length(st.n_live)
    fwd_u = (st.infected & st.up[:, None] & ((t - st.infected_at) < spread[:, None])).any(dim=0)
    st.rumor_active &= ((t - st.rumor_created) <= sweep) | fwd_u
    if covered is not None:
        fwd_m = torch.zeros_like(st.mr_active)
        for lo, hi in blocks(st.up.shape[0], st.mr_active.shape[0]):
            a = st.minf_age[lo:hi].to(I32)
            fwd_m |= (st.up[lo:hi, None] & (a > 0) & (a <= spread[lo:hi, None])).any(dim=0)
        keep = (((t - st.mr_created) <= sweep) | fwd_m) & ~covered & st.mr_active
        freed = st.mr_active & ~keep
        st.mr_active.copy_(keep)
        st.mr_subject[freed] = -1
        st.minf_age[:, freed] = 0
    return n_up


def _state_metrics(st, cfg: dict, t: int, n_up: int) -> dict:
    n = st.up.shape[0]
    dev = st.up.device
    cov = (st.infected & st.up[:, None]).sum(dim=0).to(torch.float32) / torch.tensor(
        float(max(n_up, 1)), dtype=torch.float32, device=st.up.device)
    newest = torch.where(st.infected, st.rumor_created[None, :], NEVER).amax(dim=1)
    seg = (st.rumor_active[None, :] & ~st.infected & (st.rumor_created[None, :] < newest[:, None])
           & st.up[:, None]).sum(dim=1, dtype=I32)
    if t % cfg["sweep_every"] == 0 and bool(st.mr_active.any()):
        for lo, hi in blocks(n, st.mr_active.shape[0]):
            age = st.minf_age[lo:hi]
            newest_m = torch.where(age > 0, st.mr_created[None, :], NEVER).amax(dim=1)
            seg[lo:hi] += (st.mr_active[None, :] & (age == 0) & (st.mr_created[None, :] < newest_m[:, None])
                           & st.up[lo:hi, None]).sum(dim=1, dtype=I32)
    return {
        "n_up": n_up,
        "mr_active_count": int(st.mr_active.sum()),
        "rumor_coverage": cov.to(dev),
        "gossip_segmentation": int(seg.max()),
        "alive_view_fraction": 0.0,
        "false_suspect_pairs": 0,
    }


def tick(st, fd, rd: dict, cfg: dict, drop_slot: bool = False) -> dict:
    """One gossip period, in place on ``st``: FD (every ``fd_every``
    ticks), the suspicion sweep, gossip, SYNC, refute, the rumor sweeps,
    the pool allocation, the metrics. Returns the tick's metrics."""
    st.tick += 1
    t = st.tick
    n = st.up.shape[0]
    dev = st.up.device
    rows = torch.arange(n, dtype=I32, device=dev)
    fd_mets = dict.fromkeys(("fd_probes", "fd_failed_probes", "fd_new_suspects"), 0)
    props_fd = (torch.zeros((n,), dtype=I32, device=dev),) * 2 + (rows, torch.zeros((n,), dtype=torch.bool, device=dev))
    if t % cfg["fd_every"] == 0:
        props_fd, fd_mets = _fd(st, fd, cfg, t)
    props_exp = _sweep(st, cfg, t)
    g_mets, covered = _gossip(st, rd, cfg, t, drop_slot)
    props_sync, s_mets = _sync(st, rd, cfg, t)
    props_ref = _refute(st, cfg)
    n_up = _rumor_sweeps(st, cfg, t, covered)
    a_mets = pool.alloc_phase(st, (props_fd, props_exp, props_ref, props_sync), cfg["announce_slots"], t)
    return {**fd_mets, **g_mets, **s_mets, **a_mets, **_state_metrics(st, cfg, t, n_up)}
