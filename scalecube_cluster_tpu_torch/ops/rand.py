"""Per-tick randomness: the stateless fetch hash and the draw layout.

Two kinds of randomness enter a tick:

* :func:`fetch_uniform` — the stateless counter-based hash behind the
  metadata-fetch gate. It is a pure function of (tick, salt, i, j), so the
  port computes it bit for bit as the JAX package does (uint32 arithmetic,
  carried here in int64 masked to 32 bits).
* the per-tick uniform draws — same names, shapes and dtype (float32 in
  [0, 1)) as the JAX package's: the rank draws of the dense engine's
  samplers (:class:`FdRandoms`, :class:`RoundRandoms`) and the rejection
  tries of the pview and sparse engines (:class:`SparseFdRandoms`,
  :class:`SparseRoundRandoms`). The tick takes them as an INPUT: the main
  path draws them from a ``torch.Generator`` (:func:`draw_fd_randoms`,
  :func:`draw_round_randoms`, :func:`draw_sparse_fd`,
  :func:`draw_sparse_round`); the parity tests hand the port the JAX
  package's own draws, so the two engines consume identical numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from .bitplane import MASK32

# Phase salts of the fetch hash (must differ per merge site so a cell's draw
# is independent across the phases of one tick). The salt enters the mixer
# additively before the row index, so fetch(s1, i, j) ==
# fetch(s2, i + (s1 - s2) mod 2^32, j): salts must differ (in either
# direction mod 2^32) by at least the max row count or one phase's draws are
# a row-shifted copy of another's. These sit exactly 2^30 / 2^31 apart, so
# no pair of rows below 2^30 can collide across phases.
SALT_GOSSIP = 0x40000000
SALT_SYNC_REQ = 0x80000000
SALT_SYNC_ACK = 0xC0000000
# Pull-reply delivery draws (the push-pull strategy): one salt per fanout
# slot — SALT_PULL + s * SALT_PULL_STRIDE for slot s. The stride (2^25)
# keeps slots' draws row-independent below 2^25 members per the shift rule
# above, and the whole family [0x20000000, 0x30000000) stays at least 2^28
# away from the merge-site salts for any fanout <= 8.
SALT_PULL = 0x20000000
SALT_PULL_STRIDE = 0x02000000


def fetch_uniform(tick: int, salt: int, i, j) -> torch.Tensor:
    """Uniform [0, 1) float32 draw for the metadata-fetch round trip of
    receiver ``i`` about subject ``j`` at ``tick``: Jenkins-style
    add/shift/xor rounds over the uint32 lanes, the i-side mixed fully
    before j enters. ``tick`` is a host int; ``i``/``j`` broadcast."""
    h0 = ((int(tick) & MASK32) * 0x9E3779B1 + int(salt)) & MASK32
    a = ((torch.as_tensor(i).to(torch.int64) & MASK32) + h0) & MASK32
    a = (a + (a << 10)) & MASK32
    a = a ^ (a >> 6)
    a = (a + (a << 3)) & MASK32
    a = a ^ (a >> 11)
    a = (a + (a << 15)) & MASK32
    b = (a + (torch.as_tensor(j, device=a.device).to(torch.int64) & MASK32)) & MASK32
    b = (b + (b << 10)) & MASK32
    b = b ^ (b >> 6)
    b = (b + (b << 3)) & MASK32
    b = b ^ (b >> 11)
    b = (b + (b << 15)) & MASK32
    return (b >> 8).to(torch.float32) * (1.0 / (1 << 24))


@dataclasses.dataclass
class FdRandoms:
    """Dense-engine FD draws of one tick: the probe target's and the
    relays' rank draws, the direct and the per-relay delivery draws."""

    fd_sel: torch.Tensor  # [N, 1+k]
    fd_direct: torch.Tensor  # [N]
    fd_relay: torch.Tensor  # [N, k]

    def to(self, device) -> "FdRandoms":
        return FdRandoms(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


@dataclasses.dataclass
class RoundRandoms:
    """Dense-engine gossip and SYNC draws of one tick."""

    gossip_sel: torch.Tensor  # [N, f]
    gossip_edge: torch.Tensor  # [N, f]
    gossip_delay: torch.Tensor  # [N, f]
    sync_sel: torch.Tensor  # [N]
    sync_edge: torch.Tensor  # [N]

    def to(self, device) -> "RoundRandoms":
        return RoundRandoms(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


@dataclasses.dataclass
class SparseFdRandoms:
    """FD draws of one tick: rejection-sampling tries + delivery draws."""

    fd_try: torch.Tensor  # [N, (1+k)*T]
    fd_direct: torch.Tensor  # [N]
    fd_relay: torch.Tensor  # [N, k]

    def to(self, device) -> "SparseFdRandoms":
        return SparseFdRandoms(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


@dataclasses.dataclass
class SparseRoundRandoms:
    """Gossip and SYNC draws of one tick."""

    gossip_try: torch.Tensor  # [N, f*T]
    gossip_edge: torch.Tensor  # [N, f]
    gossip_delay: torch.Tensor  # [N, f]
    sync_try: torch.Tensor  # [N, T]
    sync_fb: torch.Tensor  # [N]
    sync_edge: torch.Tensor  # [N]

    def to(self, device) -> "SparseRoundRandoms":
        return SparseRoundRandoms(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)


def draw_fd_randoms(gen: torch.Generator, n: int, ping_req_k: int, lead: tuple = ()) -> FdRandoms:
    """One dense tick's FD draws from ``gen``, on the generator's device."""
    return FdRandoms(
        fd_sel=_uniform(gen, (*lead, n, 1 + ping_req_k)),
        fd_direct=_uniform(gen, (*lead, n)),
        fd_relay=_uniform(gen, (*lead, n, ping_req_k)),
    )


def draw_round_randoms(gen: torch.Generator, n: int, fanout: int, lead: tuple = ()) -> RoundRandoms:
    """One dense tick's gossip/SYNC draws from ``gen``, on its device."""
    return RoundRandoms(
        gossip_sel=_uniform(gen, (*lead, n, fanout)),
        gossip_edge=_uniform(gen, (*lead, n, fanout)),
        gossip_delay=_uniform(gen, (*lead, n, fanout)),
        sync_sel=_uniform(gen, (*lead, n)),
        sync_edge=_uniform(gen, (*lead, n)),
    )


def draw_sparse_fd(gen: torch.Generator, n: int, ping_req_k: int, tries: int, lead: tuple = ()) -> SparseFdRandoms:
    """One tick's FD draws from ``gen``, on the generator's device."""
    return SparseFdRandoms(
        fd_try=_uniform(gen, (*lead, n, (1 + ping_req_k) * tries)),
        fd_direct=_uniform(gen, (*lead, n)),
        fd_relay=_uniform(gen, (*lead, n, ping_req_k)),
    )


def draw_sparse_round(gen: torch.Generator, n: int, fanout: int, tries: int, lead: tuple = ()) -> SparseRoundRandoms:
    """One tick's gossip/SYNC draws from ``gen``, on the generator's device."""
    return SparseRoundRandoms(
        gossip_try=_uniform(gen, (*lead, n, fanout * tries)),
        gossip_edge=_uniform(gen, (*lead, n, fanout)),
        gossip_delay=_uniform(gen, (*lead, n, fanout)),
        sync_try=_uniform(gen, (*lead, n, tries)),
        sync_fb=_uniform(gen, (*lead, n)),
        sync_edge=_uniform(gen, (*lead, n)),
    )


def draw_dense_tick(gen: torch.Generator, params, fd_due: bool, lead: tuple = ()):
    """A dense tick's ``(fd, round)`` draws (``fd`` None off FD ticks);
    ``lead`` prefixes every shape (a fleet's ``(S,)``: one draw per site
    for all its scenarios)."""
    n = params.capacity
    fd = draw_fd_randoms(gen, n, params.ping_req_k, lead) if fd_due else None
    return fd, draw_round_randoms(gen, n, params.fanout, lead)


def draw_sparse_tick(gen: torch.Generator, params, fd_due: bool, lead: tuple = ()):
    """A pview or sparse tick's ``(fd, round)`` draws (``fd`` None off FD
    ticks; ``lead`` as in :func:`draw_dense_tick`)."""
    n, t = params.capacity, params.sample_tries
    fd = draw_sparse_fd(gen, n, params.ping_req_k, t, lead) if fd_due else None
    return fd, draw_sparse_round(gen, n, params.fanout, t, lead)
