"""Tensor idioms the JAX spelling gets from ``jnp`` and PyTorch lacks.

* fixed-size ascending compaction (``jnp.nonzero(size=K, fill_value=f)``)
  without a host sync;
* first-true index along an axis (``jnp.argmax`` on bool);
* a scatter-set with dropped entries (``.at[...].set(mode="drop")``) that
  stays deterministic on CUDA;
* scatter-max/min into a buffer with one spare slot for dropped indices
  (``.at[...].max/min(mode="drop")``): ``scatter_reduce_`` with amax/amin is
  deterministic whatever the duplicates, which ``index_put_`` is not;
* the host decisions the JAX tick takes with ``lax.cond`` on data: each
  costs one device-to-host read, counted in :data:`HOST_SYNCS`;
* row chunks for reductions over the [N, M] membership planes, so that no
  [N, M] temporary wider than a byte exists at a million rows; and row
  chunks bounded by a cell count for passes over the sparse engine's
  [N, N] view plane and its per-cell [N, M] arithmetic.
"""

from __future__ import annotations

import torch


class _SyncCounter:
    """Count of host reads taken by data-dependent branches of the tick."""

    def __init__(self):
        self.count = 0


HOST_SYNCS = _SyncCounter()

#: rows per chunk of the [N, M] reductions
ROW_CHUNK = 1 << 16


def row_chunks(n: int):
    """``(lo, hi)`` bounds of consecutive row chunks covering ``range(n)``."""
    for lo in range(0, n, ROW_CHUNK):
        yield lo, min(n, lo + ROW_CHUNK)


#: cells per chunk of a row-chunked pass over a wide plane
PLANE_CHUNK_CELLS = 1 << 26


def plane_chunks(n: int, width: int):
    """``(lo, hi)`` bounds of consecutive row chunks of an [n, width] plane,
    each of at most :data:`PLANE_CHUNK_CELLS` cells (one row at least)."""
    step = max(1, PLANE_CHUNK_CELLS // max(1, width))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def host_flags(*flags: torch.Tensor) -> list:
    """Read 0-d bool tensors to the host in ONE transfer."""
    HOST_SYNCS.count += 1
    if len(flags) == 1:
        return [bool(flags[0])]
    return [bool(v) for v in torch.stack(flags).tolist()]


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Ascending indices of the True entries of the 1-D ``mask``: the first
    ``size`` of them, padded with ``fill``. int64 [size]."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    return out[:size]


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where none) — int64."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def scatter_reduce_1d(size: int, idx, vals, reduce: str, init, dtype) -> torch.Tensor:
    """``full(size + 1, init).at[idx].<reduce>(vals)[:size]`` — ``idx`` may
    hold ``size`` for entries to drop (the spare slot)."""
    out = torch.full((size + 1,), init, dtype=dtype, device=vals.device)
    out.scatter_reduce_(0, idx.long(), vals.to(dtype), reduce, include_self=True)
    return out[:size]


def put_drop_(t: torch.Tensor, index: tuple, vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """In place: ``t[index[e]] = vals[e]`` for every entry with ``ok[e]``;
    entries without are dropped. The ok entries must name distinct targets
    (as the JAX call sites guarantee). Dropped entries are redirected onto
    the first ok entry's target with its value (or, if there is none, onto
    one cell with that cell's own value), so no two writes to one cell
    differ and the result does not depend on write order."""
    # a one-element index, not a 0-d one: indexing with a 0-d tensor reads
    # it to the host
    first = first_true(ok, 0).reshape(1)
    index = tuple(ix.long().clamp(0, t.shape[d] - 1) for d, ix in enumerate(index))
    tgt0 = tuple(ix[first] for ix in index)
    fill = torch.where(ok.any(), vals[first], t[tgt0])
    index = tuple(torch.where(ok, ix, ix[first]) for ix in index)
    okb = ok.view(ok.shape + (1,) * (vals.dim() - ok.dim()))
    t.index_put_(index, torch.where(okb, vals, fill))
    return t
