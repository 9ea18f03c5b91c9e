"""The JAX package's per-tick key chain, computed in torch.

The JAX windows draw every tick's uniforms from a threefry-2x32 key chain:
``key, tick_key = split(key)``, ``fd_key, round_key = split(tick_key)``, a
3-way split of ``fd_key`` and a 5-way (dense) or 6-way (pview, sparse) split
of ``round_key``, one ``uniform`` per draw site (``ops/rand.py`` of the JAX
package). The port's main path draws from a ``torch.Generator`` instead
(:mod:`.rand`); this module reproduces the JAX chain bit for bit — the
threefry hash, the partitionable ``split`` and ``random_bits`` layouts (a
counter per element, the two output words XOR-ed for 32-bit bits), and
``uniform``'s mantissa fill — so a run on the card can consume the
reference's own random stream and be compared with the JAX package's
records value for value.

:class:`KeyChain` holds one key per scenario ([S] chains, each
``PRNGKey(seeds[s])``, as the JAX ``fleet_keys``) and is a draw source of
the windows: ``chain(n_ticks, params)`` returns the per-tick ``(fd,
round)`` pairs with [S, ...] leaves (``serial=True``: one chain, no lead
axis), the FD draws on every tick as the JAX chain computes them. The
sequential part (each tick's split of the chain key) runs on the host in
uint32 numpy; the rest of a window — every tick's sub-key splits and every
draw site's counters — is three batched hashes on the device, int64 lanes
masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitplane import MASK32
from .rand import FdRandoms, RoundRandoms, SparseFdRandoms, SparseRoundRandoms

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry(k1, k2, x1, x2, mask, rotl):
    """The 20-round Threefry-2x32 schedule over any lane type: ``mask``
    wraps an add to 32 bits, ``rotl`` rotates."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = mask(x1 + ks[0]), mask(x2 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = mask(a + b)
            b = rotl(b, r) ^ a
        a = mask(a + ks[(i + 1) % 3])
        b = mask(b + ks[(i + 2) % 3] + (i + 1))
    return a, b


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pair ``(x1, x2)`` under the key ``(k1,
    k2)``: int64 tensors holding uint32 values, broadcast together. Returns
    the two output words."""
    return _threefry(k1, k2, x1, x2, lambda v: v & MASK32,
                     lambda v, r: ((v << r) | (v >> (32 - r))) & MASK32)


def _threefry_host(k1, k2, x1, x2):
    """:func:`threefry2x32` on uint32 numpy arrays (wrapping arithmetic)."""
    with np.errstate(over="ignore"):
        return _threefry(k1, k2, x1, x2, lambda v: v,
                         lambda v, r: (v << np.uint32(r)) | (v >> np.uint32(32 - r)))


def prng_keys(seeds, device) -> torch.Tensor:
    """[S, 2] keys, row s the JAX ``PRNGKey(seeds[s])`` of a 32-bit seed:
    (0, seed mod 2^32)."""
    lo = torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1) & MASK32, device=device)
    return torch.stack([torch.zeros_like(lo), lo], dim=1)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split`` of every key: [..., 2] -> [..., num, 2] (the
    partitionable layout: key i hashes the counter (0, i))."""
    idx = torch.arange(num, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., :1], keys[..., 1:], torch.zeros_like(idx), idx)
    return torch.stack([a, b], dim=-1)


def _bits_to_uniform(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """32 random bits (the XOR of the two words) as a float32 in [0, 1):
    the top 23 bits fill the mantissa of a float in [1, 2)."""
    return (((a ^ b) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` of every key: [S, 2] ->
    [S, *shape] in [0, 1), the row-major element counter hashed."""
    size = int(np.prod(shape)) if shape else 1
    idx = torch.arange(size, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(idx), idx)
    return _bits_to_uniform(a, b).reshape((keys.shape[0],) + tuple(shape))


def _sites(params):
    """The draw sites of the params' engine: (draw classes, [(sub-key
    group, index, field, shape)]) in the JAX split order."""
    from .state import SimParams

    n, k, f = params.capacity, params.ping_req_k, params.fanout
    if isinstance(params, SimParams):
        return (FdRandoms, RoundRandoms), 5, [
            (0, 0, "fd_sel", (n, 1 + k)), (0, 1, "fd_direct", (n,)), (0, 2, "fd_relay", (n, k)),
            (1, 0, "gossip_sel", (n, f)), (1, 1, "gossip_edge", (n, f)), (1, 4, "gossip_delay", (n, f)),
            (1, 2, "sync_sel", (n,)), (1, 3, "sync_edge", (n,)),
        ]
    t = params.sample_tries
    return (SparseFdRandoms, SparseRoundRandoms), 6, [
        (0, 0, "fd_try", (n, (1 + k) * t)), (0, 1, "fd_direct", (n,)), (0, 2, "fd_relay", (n, k)),
        (1, 0, "gossip_try", (n, f * t)), (1, 1, "gossip_edge", (n, f)), (1, 4, "gossip_delay", (n, f)),
        (1, 2, "sync_try", (n, t)), (1, 5, "sync_fb", (n,)), (1, 3, "sync_edge", (n,)),
    ]


class KeyChain:
    """[S] JAX key chains as a draw source: ``chain(n_ticks, params)`` ->
    ``n_ticks`` per-tick ``(fd, round)`` pairs, each leaf [S, ...] (or
    without the lead axis when ``serial``), advancing every chain as the
    JAX window does. The params pick the layout (dense rank draws, or the
    pview/sparse rejection tries) and the widths (its fanout may change
    between calls, as a controller's knobs do)."""

    def __init__(self, seeds, device="cuda", serial: bool = False):
        seeds = np.asarray(np.atleast_1d(seeds), np.int64) & MASK32
        self._keys = np.stack([np.zeros_like(seeds), seeds], axis=1).astype(np.uint32)  # [S, 2]
        self.device = torch.device(device)
        self.serial = serial

    @property
    def keys(self) -> torch.Tensor:
        """The chains' current keys, [S, 2] int64 (uint32 values)."""
        return torch.as_tensor(self._keys.astype(np.int64))

    def __call__(self, n_ticks: int, params) -> list:
        classes, n_round, sites = _sites(params)
        s = self._keys.shape[0]
        # the sequential chain on the host: key, tick_key = split(key)
        tick_keys = np.empty((s, n_ticks, 2), np.uint32)
        zero, one = np.zeros((1, 2), np.uint32), np.arange(2, dtype=np.uint32)[None, :]
        for t in range(n_ticks):
            a, b = _threefry_host(self._keys[:, :1], self._keys[:, 1:], zero, one)
            self._keys = np.stack([a[:, 0], b[:, 0]], axis=1)
            tick_keys[:, t] = np.stack([a[:, 1], b[:, 1]], axis=1)
        tk = torch.as_tensor(tick_keys.astype(np.int64), device=self.device)  # [S, T, 2]
        groups = split(tk, 2)  # [S, T, 2 (fd, round), 2]
        sub = split(groups, max(3, n_round))  # [S, T, 2, n_sub, 2]
        keys = torch.stack([sub[:, :, g, i] for g, i, _f, _shape in sites], dim=2)  # [S, T, sites, 2]
        sizes = [int(np.prod(shape)) for *_gi, shape in sites]
        idx = torch.arange(max(sizes), dtype=torch.int64, device=self.device)
        a, b = threefry2x32(keys[..., :1], keys[..., 1:], torch.zeros_like(idx), idx)
        u = _bits_to_uniform(a, b)  # [S, T, sites, max size]
        leaves = {f: u[:, :, j, :size].reshape((s, n_ticks) + shape)
                  for j, ((_g, _i, f, shape), size) in enumerate(zip(sites, sizes))}
        fd_cls, rd_cls = classes
        out = []
        for t in range(n_ticks):
            at = {f: (v[0, t] if self.serial else v[:, t]) for f, v in leaves.items()}
            fd = fd_cls(**{f.name: at[f.name] for f in fd_cls.__dataclass_fields__.values()})
            rd = rd_cls(**{f.name: at[f.name] for f in rd_cls.__dataclass_fields__.values()})
            out.append((fd, rd))
        return out
