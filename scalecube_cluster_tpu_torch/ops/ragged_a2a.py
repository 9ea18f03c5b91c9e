"""The ragged delivery exchange of the member-sharded pview engine.

A port of the JAX package's ``ops/ragged_a2a.py``. The pview delivery is an
inverse-sender election: for fanout slot f and receiver p, the highest
sender s with ``ok_now[f, s]`` whose slot-f target is p wins, and its
payload row is delivered. On one device that is a global scatter-max and a
row gather; on a member mesh each rank holds L = N / W rows (senders and
receivers alike), and the election runs where the receiver lives:

1. **Records** (:func:`bucket_records`): each local sender row contributes
   one record per fanout slot, fanout-slot-major and local-row-minor: a
   header of 3 words (local receiver row, fanout slot, sender + 1; 0 marks
   an empty record) and the ``Wt`` payload words.
2. **Buckets**: the valid records go to their receiver's rank, the first B
   of each destination in record order; the rest are counted as overflow
   (summed over the ranks: the ``delivery_overflow`` metric), never lost
   silently. One ``[W, B, 3 + Wt]`` int32 buffer.
3. **Exchange** (:func:`exchange`): one ``all_to_all_single`` over the
   member group; rank d receives every rank's bucket d.
4. **Election and fold** (:func:`elect_and_fold`): a scatter-max of
   ``sender + 1`` into the local ``[F, L]`` inverse table, the unique
   winner's payload per cell (a (slot, sender) pair names one receiver, so
   the winner is unique), then the receiver-side fold of the one-device
   combine (:func:`.delivery.delivery_combine_ref`) on the local rows.

Under the default budget B = F·L no record is ever dropped and the result
equals the global election's. The split into three functions lets the CPU
tests hold the per-rank pieces against JAX's ``shard_map`` without
processes: the exchange is a transpose of the buckets.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .bitplane import unpack_bits

#: int32 header words per exchanged record, before the Wt payload words:
#: local receiver row, fanout slot, sender + 1 (0 = empty bucket slot)
HEADER_WORDS = 3


def default_budget(fanout: int, capacity: int, mesh_size: int) -> int:
    """The lossless per-(src, dst) bucket budget: one rank emits at most
    ``fanout * (capacity // mesh_size)`` records in all, so a bucket of
    that size never overflows, however skewed the receivers are."""
    return fanout * (capacity // mesh_size)


def check_budget(fanout: int, capacity: int, mesh_size: int, budget: Optional[int]) -> int:
    """The budget a window runs with (None: the default), refusing what JAX
    refuses: a capacity the mesh does not divide, a budget outside
    (0, F·L]."""
    if capacity % mesh_size:
        raise ValueError(f"capacity {capacity} not divisible by member-mesh size {mesh_size}")
    L = capacity // mesh_size
    B = budget if budget is not None else default_budget(fanout, capacity, mesh_size)
    if not (0 < B <= fanout * L):
        raise ValueError(
            f"a2a budget must be in (0, F*L] = (0, {fanout * L}]: got {B} "
            "(budgets beyond F*L waste exchange bytes on provably-empty "
            "slots)"
        )
    return B


def exchange_bytes(fanout: int, capacity: int, mesh_size: int, words: int, budget: Optional[int] = None) -> int:
    """Bytes of one rank's send buffer (its receive buffer is as large):
    ``W · B · (3 + Wt)`` int32 words."""
    B = check_budget(fanout, capacity, mesh_size, budget)
    return 4 * mesh_size * B * (HEADER_WORDS + words)


def bucket_records(payload: torch.Tensor, p_l: torch.Tensor, ok_l: torch.Tensor, base: int, L: int,
                   W: int, B: int):
    """Steps 1-2 on one rank: the records of its L sender rows, bucketed by
    destination rank.

    Args:
      payload: int32 [L, Wt] — the senders' payload rows.
      p_l: int32 [F, L] — each slot's global receiver row.
      ok_l: bool [F, L] — the undelayed sends.
      base: the rank's first global row (r·L).

    Returns ``(buf int32 [W, B, 3 + Wt], overflow int32)``: the send buffer
    (unused slots zero) and the records this rank dropped."""
    F = p_l.shape[0]
    Wt = payload.shape[1]
    dev = payload.device
    nrec = F * L
    recv = p_l.reshape(-1).to(torch.int64)
    valid = ok_l.reshape(-1)
    rec = torch.empty((nrec, HEADER_WORDS + Wt), dtype=torch.int32, device=dev)
    rec[:, 0] = (recv % L).to(torch.int32)
    rec[:, 1] = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(L)
    sender1 = (base + 1 + torch.arange(L, dtype=torch.int32, device=dev)).repeat(F)
    rec[:, 2] = torch.where(valid, sender1, 0)
    rec[:, HEADER_WORDS:].view(F, L, Wt).copy_(payload[None].expand(F, L, Wt))
    dest = recv // L
    slot = torch.full((nrec,), W * B, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(W):
        mask = valid & (dest == d)
        pos = torch.cumsum(mask, 0) - 1
        keep = mask & (pos < B)
        slot = torch.where(keep, d * B + pos, slot)
        overflow += (mask.sum() - B).clamp(min=0)
    # one spare row takes the dropped records; every kept record has its own
    buf = torch.zeros((W * B + 1, HEADER_WORDS + Wt), dtype=torch.int32, device=dev)
    buf.index_copy_(0, slot, rec)
    return buf[: W * B].view(W, B, HEADER_WORDS + Wt), overflow.to(torch.int32)


def exchange(buf: torch.Tensor, group) -> torch.Tensor:
    """Step 3: one ``all_to_all_single`` over the member group. Sends bucket
    d of ``buf`` [W, B, 3 + Wt] to rank d; returns the [W·B, 3 + Wt]
    records this rank received, source rank major."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.view(-1, buf.shape[2])


def elect_and_fold(got: torch.Tensor, rumor_origin: torch.Tensor, base: int, L: int, F: int, Wm: int, R: int):
    """Step 4 on one rank: the election over the received records and the
    receiver-side fold on its L rows.

    Args:
      got: int32 [K, 3 + Wt] — received records (empty ones have sender 0).
      rumor_origin: int32 [R]; base: the rank's first global row.

    Returns ``(u_or bool [L, R], src_max int32 [L, R], m_or int32 [L, Wm],
    cnt int32)`` — ``cnt`` this rank's deliveries."""
    dev = got.device
    Wt = got.shape[1] - HEADER_WORDS
    Wu = Wt - Wm - R
    r_lr = got[:, 0].clamp(0, L - 1).to(torch.int64)
    r_f = got[:, 1].clamp(0, F - 1).to(torch.int64)
    r_s1 = got[:, 2]
    vr = r_s1 > 0
    cell = r_f * L + r_lr
    inv1 = torch.zeros((F * L,), dtype=torch.int32, device=dev)
    inv1.scatter_reduce_(0, cell, torch.where(vr, r_s1, 0), "amax", include_self=True)
    win = vr & (r_s1 == inv1[cell])
    # one winner per cell; the losers go to the spare row
    pl_e = torch.zeros((F * L + 1, Wt), dtype=torch.int32, device=dev)
    pl_e.index_copy_(0, torch.where(win, cell, F * L), got[:, HEADER_WORDS:])
    pl_e = pl_e[: F * L].view(F, L, Wt)
    inv1 = inv1.view(F, L)
    has = (inv1 > 0)[:, :, None]
    j_all = (inv1 - 1).clamp(min=0)
    grow = base + torch.arange(L, dtype=torch.int32, device=dev)
    yu = unpack_bits(pl_e[:, :, Wm : Wm + Wu], R)
    frm = pl_e[:, :, Wm + Wu :]
    deliver = yu & has & (frm != grow[None, :, None]) & (rumor_origin[None, None, :] != grow[None, :, None])
    u_or = deliver.any(dim=0)
    src_max = torch.where(deliver, j_all[:, :, None], -1).amax(dim=0).to(torch.int32)
    m_or = torch.zeros((L, Wm), dtype=torch.int32, device=dev)
    for s in range(F):
        m_or |= torch.where(has[s], pl_e[s, :, :Wm], 0)
    return u_or, src_max, m_or, deliver.sum().to(torch.int32)


def ragged_delivery_combine(payload, p_l, ok_l, rumor_origin, Wm: int, R: int, *, mesh, capacity: int,
                            budget: Optional[int] = None):
    """Steps 1-4 on this rank of ``mesh``: the sharded twin of the one-device
    combine. ``payload`` [L, Wt], ``p_l`` / ``ok_l`` [F, L] are this rank's
    rows. Returns ``(u_or [L, R], src_max [L, R], m_or [L, Wm], cnt,
    overflow)``; ``cnt`` and ``overflow`` are summed over the ranks (int64
    on the wire), so they are the same on every rank."""
    from .sharding import MEMBER_AXIS, _rank_rows, all_reduce, member_mesh_size

    F = p_l.shape[0]
    W = member_mesh_size(mesh)
    B = check_budget(F, capacity, W, budget)
    lo, hi = _rank_rows(mesh, capacity)
    L = hi - lo
    group = mesh.get_group(MEMBER_AXIS)
    buf, overflow = bucket_records(payload, p_l, ok_l, lo, L, W, B)
    got = exchange(buf, group)
    u_or, src_max, m_or, cnt = elect_and_fold(got, rumor_origin, lo, L, F, Wm, R)
    counts = all_reduce(torch.stack([cnt, overflow]).to(torch.int64), "sum", group).to(torch.int32)
    return u_or, src_max, m_or, counts[0], counts[1]
