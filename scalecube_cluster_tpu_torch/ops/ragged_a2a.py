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

JAX budgets only this on-time delivery. Its late deliveries (the delay
rings) and its push-pull leg are global scatters and gathers, which lose
nothing; here they are **exact exchanges** sized by their records: one
``all_to_all_single`` of the per-destination counts, read to the host once
as the splits, then the records with those splits (:func:`late_exchange`,
which elects the late winners where the receivers live, and
:func:`fetch_rows`, a request/reply exchange that brings peer rows back in
request order). A destination outside the group raises :class:`ExchangeError`.

Every exchange is a ``torch.library.custom_op`` with a vmap rule: under the
fleet's ``torch.func.vmap`` (a 2-D scenarios x members mesh) one exchange
carries every scenario of the rank's block, its buffer laid out ``[W, S,
B, ...]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .bitplane import unpack_bits
from .sharding import _plain

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


def _bucket_records_s(payload: torch.Tensor, p_l: torch.Tensor, ok_l: torch.Tensor, base: int, L: int,
                      W: int, B: int):
    """:func:`bucket_records` over a leading scenario axis: ``payload`` [S,
    L, Wt], ``p_l`` / ``ok_l`` [S, F, L]. Returns ``(buf [S, W, B, 3 + Wt],
    overflow int32 [S])``, each scenario's buckets as the serial call
    makes them."""
    S, F = p_l.shape[:2]
    Wt = payload.shape[2]
    C = HEADER_WORDS + Wt
    dev = payload.device
    nrec = F * L
    recv = p_l.reshape(S, nrec).to(torch.int64)
    valid = ok_l.reshape(S, nrec)
    rec = torch.empty((S, nrec, C), dtype=torch.int32, device=dev)
    rec[:, :, 0] = (recv % L).to(torch.int32)
    rec[:, :, 1] = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(L)
    sender1 = (base + 1 + torch.arange(L, dtype=torch.int32, device=dev)).repeat(F)
    rec[:, :, 2] = torch.where(valid, sender1, 0)
    rec[:, :, HEADER_WORDS:].view(S, F, L, Wt).copy_(payload[:, None].expand(S, F, L, Wt))
    dest = recv // L
    slot = torch.full((S, nrec), W * B, dtype=torch.int64, device=dev)
    overflow = torch.zeros((S,), dtype=torch.int64, device=dev)
    for d in range(W):
        mask = valid & (dest == d)
        pos = torch.cumsum(mask, 1) - 1
        keep = mask & (pos < B)
        slot = torch.where(keep, d * B + pos, slot)
        overflow += (mask.sum(1) - B).clamp(min=0)
    # one spare row per scenario takes the dropped records; every kept
    # record has its own
    slot = slot + torch.arange(S, device=dev)[:, None] * (W * B + 1)
    buf = torch.zeros((S, W * B + 1, C), dtype=torch.int32, device=dev)
    buf.view(-1, C).index_copy_(0, slot.reshape(-1), rec.view(-1, C))
    return buf[:, : W * B].reshape(S, W, B, C), overflow.to(torch.int32)


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
    buf, overflow = _bucket_records_s(payload[None], p_l[None], ok_l[None], base, L, W, B)
    return buf[0], overflow[0]


def exchange(buf: torch.Tensor, group) -> torch.Tensor:
    """Step 3: one ``all_to_all_single`` over the member group. Sends bucket
    d of ``buf`` [W, ...] to rank d; returns what this rank received,
    source rank first, flattened to records of ``buf.shape[-1]`` words."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.view(-1, buf.shape[-1])


def _elect_and_fold_s(got: torch.Tensor, rumor_origin: torch.Tensor, base: int, L: int, F: int, Wm: int,
                      R: int):
    """:func:`elect_and_fold` over a leading scenario axis: ``got`` [S, K,
    3 + Wt], ``rumor_origin`` [S, R]. Returns ``(u_or [S, L, R], src_max
    [S, L, R], m_or [S, L, Wm], cnt [S])``."""
    dev = got.device
    S = got.shape[0]
    Wt = got.shape[2] - HEADER_WORDS
    Wu = Wt - Wm - R
    r_lr = got[..., 0].clamp(0, L - 1).to(torch.int64)
    r_f = got[..., 1].clamp(0, F - 1).to(torch.int64)
    r_s1 = got[..., 2]
    vr = r_s1 > 0
    cells = S * F * L
    cell = (torch.arange(S, device=dev)[:, None] * F + r_f) * L + r_lr
    inv1 = torch.zeros((cells,), dtype=torch.int32, device=dev)
    inv1.scatter_reduce_(0, cell.reshape(-1), torch.where(vr, r_s1, 0).reshape(-1), "amax", include_self=True)
    win = vr & (r_s1 == inv1[cell])
    # one winner per cell; the losers go to the spare row
    pl_e = torch.zeros((cells + 1, Wt), dtype=torch.int32, device=dev)
    pl_e.index_copy_(0, torch.where(win, cell, cells).reshape(-1), got[..., HEADER_WORDS:].reshape(-1, Wt))
    pl_e = pl_e[:cells].view(S, F, L, Wt)
    inv1 = inv1.view(S, F, L)
    has = (inv1 > 0)[..., None]
    j_all = (inv1 - 1).clamp(min=0)
    grow = base + torch.arange(L, dtype=torch.int32, device=dev)
    yu = unpack_bits(pl_e[..., Wm : Wm + Wu], R)
    frm = pl_e[..., Wm + Wu :]
    deliver = (yu & has & (frm != grow[None, None, :, None])
               & (rumor_origin[:, None, None, :] != grow[None, None, :, None]))
    u_or = deliver.any(dim=1)
    src_max = torch.where(deliver, j_all[..., None], -1).amax(dim=1).to(torch.int32)
    m_or = torch.zeros((S, L, Wm), dtype=torch.int32, device=dev)
    for s in range(F):
        m_or |= torch.where(has[:, s], pl_e[:, s, :, :Wm], 0)
    return u_or, src_max, m_or, deliver.sum(dim=(1, 2, 3)).to(torch.int32)


def elect_and_fold(got: torch.Tensor, rumor_origin: torch.Tensor, base: int, L: int, F: int, Wm: int, R: int):
    """Step 4 on one rank: the election over the received records and the
    receiver-side fold on its L rows.

    Args:
      got: int32 [K, 3 + Wt] — received records (empty ones have sender 0).
      rumor_origin: int32 [R]; base: the rank's first global row.

    Returns ``(u_or bool [L, R], src_max int32 [L, R], m_or int32 [L, Wm],
    cnt int32)`` — ``cnt`` this rank's deliveries."""
    return tuple(x[0] for x in _elect_and_fold_s(got[None], rumor_origin[None], base, L, F, Wm, R))


def _lead(args, in_dims, s: int) -> list:
    """Every operand with its scenario axis first (an unbatched one broadcast)."""
    return [t.expand((s,) + tuple(t.shape)) if d is None else t.movedim(d, 0) for t, d in zip(args, in_dims)]


def _ragged_s(payload, p_l, ok_l, rumor_origin, Wm: int, R: int, base: int, L: int, W: int, B: int,
              group: int):
    """Steps 1-4 over a leading scenario axis: every scenario's buckets in
    one ``[W, S, B, 3 + Wt]`` buffer, one ``all_to_all_single`` for all."""
    from .sharding import all_reduce, group_of

    g = group_of(group)
    S, F = p_l.shape[:2]
    buf, overflow = _bucket_records_s(payload, p_l, ok_l, base, L, W, B)
    got = exchange(buf.transpose(0, 1).contiguous(), g)  # [W·S·B, C], source rank first
    got = got.view(W, S, B, -1).transpose(0, 1).reshape(S, W * B, -1)
    u_or, src_max, m_or, cnt = _elect_and_fold_s(got, rumor_origin, base, L, F, Wm, R)
    counts = all_reduce(torch.stack([cnt, overflow], dim=1).to(torch.int64), "sum", g).to(torch.int32)
    return u_or, src_max, m_or, counts[:, 0], counts[:, 1]


@torch.library.custom_op("scalecube_port::ragged_delivery", mutates_args=())
def _ragged_op(payload: torch.Tensor, p_l: torch.Tensor, ok_l: torch.Tensor, rumor_origin: torch.Tensor,
               Wm: int, R: int, base: int, L: int, W: int, B: int, group: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    with _plain():
        out = _ragged_s(payload[None], p_l[None], ok_l[None], rumor_origin[None], Wm, R, base, L, W, B, group)
        return tuple(x[0].clone() for x in out)


@_ragged_op.register_vmap
def _ragged_vmap(info, in_dims, payload, p_l, ok_l, rumor_origin, Wm, R, base, L, W, B, group):
    with _plain():
        args = _lead((payload, p_l, ok_l, rumor_origin), in_dims[:4], info.batch_size)
        return _ragged_s(*args, Wm, R, base, L, W, B, group), (0, 0, 0, 0, 0)


def ragged_delivery_combine(payload, p_l, ok_l, rumor_origin, Wm: int, R: int, *, mesh, capacity: int,
                            budget: Optional[int] = None):
    """Steps 1-4 on this rank of ``mesh``: the sharded twin of the one-device
    combine. ``payload`` [L, Wt], ``p_l`` / ``ok_l`` [F, L] are this rank's
    rows. Returns ``(u_or [L, R], src_max [L, R], m_or [L, Wm], cnt,
    overflow)``; ``cnt`` and ``overflow`` are summed over the ranks (int64
    on the wire), so they are the same on every rank. Under a fleet's vmap
    every scenario's records cross in one exchange."""
    from .sharding import MEMBER_AXIS, _rank_rows, group_index, member_mesh_size

    F = p_l.shape[-2]
    W = member_mesh_size(mesh)
    B = check_budget(F, capacity, W, budget)
    lo, hi = _rank_rows(mesh, capacity)
    return _ragged_op(payload, p_l, ok_l, rumor_origin, Wm, R, lo, hi - lo, W, B,
                      group_index(mesh.get_group(MEMBER_AXIS)))


# ---------------------------------------------------------------------------
# the exact exchanges: the delay rings' late contacts and the pull leg
# ---------------------------------------------------------------------------
#
# JAX budgets only the on-time delivery: its late deliveries and its pull
# leg are plain global scatters and gathers under GSPMD, which lose nothing.
# Here they are exchanges sized by their records: one ``all_to_all_single``
# of the per-destination counts (read to the host once: the splits), then
# the records with those splits. The receivers' splits are the senders'
# counts, so no record is dropped.


class ExchangeError(RuntimeError):
    """An exact exchange given a destination outside its group."""


def _splits(key: torch.Tensor, W: int, group):
    """Send order and splits of the records whose destination rank is
    ``key`` (W: not sent). Returns ``(order int64 [K], send [W], recv [W])``:
    the kept records' indices, destination-major and in record order within
    a destination, and the host split lists. One host read."""
    counts = torch.bincount(key, minlength=W + 1)
    if counts.shape[0] != W + 1:
        raise ExchangeError(f"exact exchange: a destination outside the {W} ranks of the group")
    send = counts[:W].contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    host = torch.cat([send, recv]).tolist()
    send_l, recv_l = host[:W], host[W:]
    order = torch.argsort(key, stable=True)[: sum(send_l)]
    return order, send_l, recv_l


def _a2a(x: torch.Tensor, send_l: list, recv_l: list, group) -> torch.Tensor:
    """The records ``x`` [K, ...] (destination-major) to their ranks."""
    out = x.new_empty((sum(recv_l),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv_l, input_split_sizes=send_l,
                           group=group)
    return out


#: int32 header words of a late record: scenario, fanout slot, local
#: receiver row, sender + 1, delay d
LATE_HEADER = 5


def _late_s(payload, p_all, ok_late, d_all, base: int, L: int, W: int, group: int):
    """:func:`late_exchange` over a leading scenario axis."""
    from .sharding import group_of

    g = group_of(group)
    S, F = p_all.shape[:2]
    Wt = payload.shape[2]
    dev = payload.device
    recv = p_all.reshape(-1).to(torch.int64)
    order, send_l, recv_l = _splits(torch.where(ok_late.reshape(-1), recv // L, W), W, g)
    s_i, f_i, r_i = order // (F * L), (order // L) % F, order % L
    hdr = torch.stack([s_i, f_i, recv[order] % L, base + 1 + r_i, d_all.reshape(-1)[order].to(torch.int64)], 1)
    got = _a2a(torch.cat([hdr.to(torch.int32), payload[s_i, r_i]], 1), send_l, recv_l, g)
    # the election where the receiver lives: the highest sender per
    # (scenario, slot, receiver), as the one-device scatter-max elects it
    cells = S * F * L
    cell = (got[:, 0].to(torch.int64) * F + got[:, 1]) * L + got[:, 2]
    inv1 = torch.zeros((cells,), dtype=torch.int32, device=dev)
    inv1.scatter_reduce_(0, cell, got[:, 3], "amax", include_self=True)
    win = got[:, 3] == inv1[cell]
    tab = torch.zeros((cells + 1, 1 + Wt), dtype=torch.int32, device=dev)
    tab.index_copy_(0, torch.where(win, cell, cells), got[:, 4:])
    tab = tab[:cells].view(S, F, L, 1 + Wt)
    return (inv1 - 1).view(S, F, L), tab[..., 0].contiguous(), tab[..., 1:].contiguous()


@torch.library.custom_op("scalecube_port::late_exchange", mutates_args=())
def _late_op(payload: torch.Tensor, p_all: torch.Tensor, ok_late: torch.Tensor, d_all: torch.Tensor, base: int,
             L: int, W: int, group: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    with _plain():
        return tuple(x[0] for x in _late_s(payload[None], p_all[None], ok_late[None], d_all[None], base, L, W,
                                           group))


@_late_op.register_vmap
def _late_vmap(info, in_dims, payload, p_all, ok_late, d_all, base, L, W, group):
    with _plain():
        args = _lead((payload, p_all, ok_late, d_all), in_dims[:4], info.batch_size)
        return _late_s(*args, base, L, W, group), (0, 0, 0)


def late_exchange(payload, p_all, ok_late, d_all, base: int, L: int, W: int, group: int):
    """The delay rings' late contacts on a member mesh. Each rank sends, per
    fanout slot, its late contacts (``ok_late`` [F, L]) to the receivers'
    ranks: the slot, the receiver's local row, the global sender row, the
    delay ``d_all`` and the sender's ``payload`` row [Wt]. Each receiver
    elects the highest sender per (slot, row). Returns ``(sender [F, L]
    int32 global, -1 where none, d [F, L] int32, payload [F, L, Wt])``, the
    winners at this rank's rows. Exact: nothing is dropped."""
    return _late_op(payload, p_all, ok_late, d_all, base, L, W, group)


def _fetch_s(table, want, L: int, W: int, group: int):
    """:func:`fetch_rows` over a leading scenario axis."""
    from .sharding import group_of

    g = group_of(group)
    S, C = table.shape[0], table.shape[2]
    w = want.reshape(S, -1).to(torch.int64)
    per = w.shape[1]
    flat = w.reshape(-1)
    order, send_l, recv_l = _splits(torch.where(flat >= 0, flat.clamp(min=0) // L, W), W, g)
    # a request names the row in the holder's [S·L] table
    asked = _a2a(order // per * L + flat[order] % L, send_l, recv_l, g)
    back = _a2a(table.reshape(S * L, C)[asked], recv_l, send_l, g)
    out = torch.zeros((S * per, C), dtype=table.dtype, device=table.device)
    out.index_copy_(0, order, back)
    return out.view(tuple(want.shape) + (C,))


@torch.library.custom_op("scalecube_port::fetch_rows", mutates_args=())
def _fetch_op(table: torch.Tensor, want: torch.Tensor, L: int, W: int, group: int) -> torch.Tensor:
    with _plain():
        return _fetch_s(table[None], want[None], L, W, group)[0]


@_fetch_op.register_vmap
def _fetch_vmap(info, in_dims, table, want, L, W, group):
    with _plain():
        args = _lead((table, want), in_dims[:2], info.batch_size)
        return _fetch_s(*args, L, W, group), 0


def fetch_rows(table, want, L: int, W: int, group: int):
    """Rows of a member-sharded ``table`` [L, C] at the global row ids
    ``want`` (any shape; -1: none), wherever they live: the ids go to their
    holders' ranks, the rows come back in request order (zeros where
    ``want`` is -1). Exact: every request is answered."""
    return _fetch_op(table, want, L, W, group)
