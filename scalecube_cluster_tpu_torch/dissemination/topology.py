"""Topology-aware adjacency generators (r13) — circulant chord sets. A
copy of the JAX package's ``dissemination/topology.py`` (it imports no
JAX).

Every supported overlay is a CIRCULANT graph: node ``i``'s neighbors are
``(i + c) mod N`` for a static python chord set ``c in chords(spec, N)``.
That representation is the whole design: adjacency is a closed-form
function of (row, chord), so

* no engine ever materializes an [N, N] adjacency plane (the pview
  O(N·k) guarantee and its ``forbid_wide_values`` audit contract hold
  unchanged — selection is O(N·fanout) integer math),
* the chord set is embedded in the traced program as a tiny [C] constant
  (static per spec, like every other protocol knob), and
* the scalar oracles mirror selection with the same integer arithmetic.

Chord sets are ASCENDING: the ``accelerated`` strategy walks them in
order (the doubling schedule), so order is part of the contract.
"""

from __future__ import annotations

import functools


def _ceil_log2(n: int) -> int:
    return int(n - 1).bit_length() if n > 1 else 0


def auto_torus_rows(n: int) -> int:
    """Largest divisor of ``n`` at or below sqrt(n) (>= 2)."""
    r = int(n**0.5)
    while r > 1 and n % r:
        r -= 1
    return r


def torus_dims(spec, n: int) -> tuple:
    rows = spec.torus_rows or auto_torus_rows(n)
    if rows < 2 or n % rows or n // rows < 2:
        raise ValueError(
            f"torus needs rows >= 2 dividing N with cols >= 2: rows={rows}, "
            f"N={n} (set DissemSpec.torus_rows to a proper divisor)"
        )
    return rows, n // rows


def zone_size(spec, n: int) -> int:
    z = spec.geo_zones
    if n % z or n // z < 4:
        raise ValueError(
            f"geo topology needs geo_zones ({z}) dividing N ({n}) with at "
            "least 4 members per zone"
        )
    return n // z


def zone_of(spec, n: int, i):
    """Zone index of row(s) ``i`` (works on ints and arrays)."""
    return i // zone_size(spec, n)


def _doubling_chords(n: int, cap: int, odd: bool) -> list:
    """Ascending geometric chords below ``n``: the doubling chain that
    makes deterministic dissemination cover an interval of size 2^C in C
    steps. ``odd=True`` forces every chord past 1 to be odd ((2^j)|1) so
    the set never traps a parity class when used alone (the pview warm-
    overlay lesson); the plain powers-of-two set always contains chord 1,
    which already generates all residues."""
    out = [1]
    j = 1
    while len(out) < cap:
        c = (1 << j) | 1 if odd else (1 << j)
        if c >= n:
            break
        if c not in out:
            out.append(c)
        j += 1
    return out


@functools.lru_cache(maxsize=None)
def _chords_cached(spec, n: int) -> tuple:
    if n < 4:
        raise ValueError(f"structured topologies need N >= 4 (got {n})")
    topo = spec.topology
    if topo == "ring":
        return (1, n - 1)
    if topo == "torus":
        rows, cols = torus_dims(spec, n)
        # {±1, ±cols} — the 4-neighbor wrap; dedup keeps N=4-ish corners sane
        return tuple(dict.fromkeys((1, cols, n - cols, n - 1)))
    if topo == "expander":
        cap = spec.degree or max(2, _ceil_log2(n))
        return tuple(_doubling_chords(n, cap, odd=True))
    if topo == "geo":
        zs = zone_size(spec, n)
        cap = spec.degree or max(2, _ceil_log2(zs))
        local = _doubling_chords(zs, cap, odd=True)
        # the WAN chord: the same slot of the NEXT zone — zones form a
        # delay ring; ascending order puts it last, so the accelerated
        # schedule fills the zone before hopping
        return tuple(local + [zs])
    # full + a deterministic strategy: the virtual-hypercube doubling set
    return tuple(_doubling_chords(n, max(2, _ceil_log2(n)), odd=False))


def chords(spec, n: int) -> tuple:
    """The spec's static chord set for capacity ``n`` (python ints,
    ascending). ``full`` + a uniform strategy has no chord set (the engine
    sampler is used); asking for one is a caller bug."""
    if spec.uniform_selection:
        raise ValueError(
            "uniform selection (push/push_pull on 'full') has no chord set"
        )
    return _chords_cached(spec, n)


def connectivity_ok(spec, n: int) -> bool:
    """Chord set generates Z_n (the overlay is connected): gcd check."""
    import math

    g = n
    for c in chords(spec, n):
        g = math.gcd(g, c)
    return g == 1


def apply_geo_wan_delay(state, spec, ops, n: int):
    """Host-side WAN delay rings for the ``geo`` topology (dense engine):
    every cross-zone directed link gets the spec's mean delay (in ticks)
    through the engine's ``set_link_delay`` mutator. Requires
    ``params.delay_slots > 0``; called between ticks like every other
    link mutation. O(Z^2) block mutations — arm-time cost, not tick cost."""
    if spec.topology != "geo" or spec.geo_wan_delay_ticks <= 0:
        return state
    zs = zone_size(spec, n)
    zones = [list(range(z * zs, (z + 1) * zs)) for z in range(spec.geo_zones)]
    for a in range(len(zones)):
        for b in range(len(zones)):
            if a != b:
                state = ops.set_link_delay(
                    state, zones[a], zones[b], float(spec.geo_wan_delay_ticks)
                )
    return state
