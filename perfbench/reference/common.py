"""What the plain references of the SWIM engines share: the packed-key
constants, the stateless fetch hash, the per-tick draw layout, the
rejection sampler, and the suspicion-episode registration.

Plain PyTorch, written from the protocol's semantics (the JAX package's
per-member oracles, ``ops/sparse_oracle.py`` and ``ops/pview_oracle.py``,
are the account followed); nothing here imports the program under test.
Every function runs on any device, so the same code serves the CPU tests
and the check on the card.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64

RANK_ALIVE, RANK_LEAVING, RANK_SUSPECT, RANK_DEAD = 0, 1, 2, 3
NO_CAND = -(1 << 31)  # scatter-max identity of an int32 key
NEVER = -(1 << 30)  # "long ago" stamp of the *_since leaves
UNKNOWN_KEY = -1
EPOCH_SHIFT_I32 = 23  # key = epoch << 23 | incarnation << 2 | rank (int32 keys)

M32 = 0xFFFFFFFF
SALT_GOSSIP = 0x40000000
SALT_SYNC_REQ = 0x80000000
SALT_SYNC_ACK = 0xC0000000

#: cells per row block of a pass over a wide plane
BLOCK_CELLS = 1 << 26


def blocks(n: int, width: int):
    """Row blocks ``(lo, hi)`` of an [n, width] plane of at most
    :data:`BLOCK_CELLS` cells each."""
    step = max(1, BLOCK_CELLS // max(1, width))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """``ceil_log2`` of the reference (``32 - numberOfLeadingZeros(n)``):
    the bit length of each positive value, 0 for the rest; int32."""
    x64 = x.to(I64).clamp(min=0)
    _, e = torch.frexp(x64.to(torch.float64))
    return torch.where(x64 > 0, e.to(I64), 0).to(I32)


def fetch_uniform(tick: int, salt: int, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The metadata-fetch draw of receiver ``i`` about subject ``j`` at
    ``tick``: add/shift/xor rounds over 32-bit lanes (held in int64), the
    i side mixed before j enters; float32 in [0, 1) from the top 24 bits."""

    def mix(a):
        a = (a + (a << 10)) & M32
        a = a ^ (a >> 6)
        a = (a + (a << 3)) & M32
        a = a ^ (a >> 11)
        return (a + (a << 15)) & M32

    h0 = ((int(tick) & M32) * 0x9E3779B1 + int(salt)) & M32
    a = mix(((i.to(I64) & M32) + h0) & M32)
    b = mix((a + (j.to(I64) & M32)) & M32)
    return (b >> 8).to(torch.float32) * (1.0 / (1 << 24))


def draw_tick(gen: torch.Generator, n: int, fanout: int, ping_req_k: int, tries: int, fd_due: bool):
    """One tick's uniforms, in the order and shapes the engines' windows draw
    them from their generator: on FD ticks the probe tries, the direct and
    the relay draws; then the gossip tries, edge and delay draws and the
    SYNC tries, fallback and edge draws. Returns (fd dict or None, round
    dict)."""

    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)

    fd = None
    if fd_due:
        fd = {"fd_try": u(n, (1 + ping_req_k) * tries), "fd_direct": u(n), "fd_relay": u(n, ping_req_k)}
    rd = {
        "gossip_try": u(n, fanout * tries),
        "gossip_edge": u(n, fanout),
        "gossip_delay": u(n, fanout),
        "sync_try": u(n, tries),
        "sync_fb": u(n),
        "sync_edge": u(n),
    }
    return fd, rd


def pick_distinct(live_at, rows: torch.Tensor, u: torch.Tensor, n: int, n_picks: int, tries: int,
                  extra=None) -> torch.Tensor:
    """Bounded rejection sampling: for each drawing row, ``n_picks`` picks,
    each the first of its ``tries`` column draws that is not the row itself,
    is live (``live_at(cols)`` -> bool, or in ``extra``), and differs from
    the row's earlier picks. Returns int32 [R, n_picks], -1 where no try
    qualified."""
    cols = (u * float(n)).to(I32).clamp(max=n - 1)
    live = live_at(cols)
    if extra is not None:
        live = live | extra[cols.long()]
    picks = []
    for p in range(n_picks):
        sel = torch.full(rows.shape, -1, dtype=I32, device=u.device)
        for t in range(tries):
            c = cols[:, p * tries + t]
            ok = (c != rows) & live[:, p * tries + t]
            for q in picks:
                ok = ok & (c != q)
            sel = torch.where((sel < 0) & ok, c, sel)
        picks.append(sel)
    return torch.stack(picks, 1)


def capped(mask: torch.Tensor, v: int) -> torch.Tensor:
    """``mask`` less every entry after its first ``v`` (in row order)."""
    return mask & (torch.cumsum(mask.to(I64), 0) <= v)


def register_suspicions(sus_key: torch.Tensor, sus_since: torch.Tensor, cand: torch.Tensor, tick: int):
    """Raise each subject's episode key to ``cand`` where higher, stamping
    ``tick`` there (in place)."""
    rise = cand > sus_key
    sus_key.copy_(torch.where(rise, cand, sus_key))
    sus_since.copy_(torch.where(rise, tick, sus_since).to(I32))


def scatter_max(size: int, idx: torch.Tensor, vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """int32 [size]: the highest of ``vals`` sent to each index where
    ``keep``, NO_CAND elsewhere."""
    out = torch.full((size + 1,), NO_CAND, dtype=I32, device=vals.device)
    out.scatter_reduce_(0, torch.where(keep, idx.to(I64), size), vals.to(I32), "amax", include_self=True)
    return out[:size]


def live_count(rows: torch.Tensor) -> torch.Tensor:
    """int32 count of each row's non-DEAD cells (an unknown cell, -1, has
    the DEAD rank)."""
    return ((rows & 3) != RANK_DEAD).sum(dim=1, dtype=I32)
