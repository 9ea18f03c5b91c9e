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
  [N, N] view plane and its per-cell [N, M] arithmetic;
* byte-wise AND / OR over bool planes through an int64 view
  (:func:`bytes64`), eight cells a word;
* the fleet seams (:mod:`.fleet`): while a fleet window runs the tick under
  ``torch.func.vmap`` over S scenarios (:func:`fleet_scope`), a chunk
  counts the cells of all S scenarios, a host flag opens its gate when any
  scenario's flag is set (one read per fleet tick, whatever S), and the
  few in-place spellings vmap cannot batch (``out=``, ``index_reduce_``)
  take their out-of-place or ``scatter_reduce_`` twins. Outside a fleet
  window every helper runs the serial spelling.

The fleet seams lean on private functorch calls, checked on torch 2.11
(the card's build) and 2.13 (the CPU build):
``torch._C._functorch.maybe_current_level`` and ``_add_batch_dim`` (a
factory's result batched per scenario), ``is_batchedtensor`` and
``get_unwrapped`` (a flag reduced over the scenarios).
``tests/test_torch_fleet.py::test_fleet_scope_batching_rules`` pins what
they must do.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C import _functorch
from torch.overrides import TorchFunctionMode

from . import sharding


class _SyncCounter:
    """Count of host reads taken by data-dependent branches of the tick."""

    def __init__(self):
        self.count = 0


HOST_SYNCS = _SyncCounter()

#: the scenario count of the fleet window running the tick (0: none)
_FLEET = [0]

_FACTORIES = frozenset({torch.zeros, torch.ones, torch.full, torch.empty})


class _ScenarioFactories(TorchFunctionMode):
    """Inside the fleet's vmap, a tensor made by ``torch.zeros`` / ``ones`` /
    ``full`` / ``empty`` is made once per scenario (batched at the current
    vmap level), so the tick's accumulators and scatter targets take the
    in-place updates of batched values as they do serially."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _FACTORIES and _FLEET[0] > 0:
            level = _functorch.maybe_current_level()
            if level is not None:
                s = _FLEET[0]
                out = _functorch._add_batch_dim(out.expand((s,) + tuple(out.shape)).clone(), 0, level)
        return out


@contextlib.contextmanager
def fleet_scope(s: int):
    """Mark a fleet tick over ``s`` scenarios (the window runs the tick under
    ``torch.func.vmap`` inside this scope); ``s`` 0 marks code inside that
    works on the whole ``[S, ...]`` planes again (the kernel's vmap rule)."""
    prev, _FLEET[0] = _FLEET[0], int(s)
    try:
        if s > 0 and prev == 0:
            with _ScenarioFactories():
                yield
        else:
            yield
    finally:
        _FLEET[0] = prev


def in_fleet() -> bool:
    """Whether the tick runs batched over a fleet's scenarios."""
    return _FLEET[0] > 0


#: rows per chunk of the [N, M] reductions
ROW_CHUNK = 1 << 16


def row_chunks(n: int):
    """``(lo, hi)`` bounds of consecutive row chunks covering ``range(n)``
    (in a fleet, a chunk's rows of every scenario count)."""
    step = max(1, ROW_CHUNK // max(1, _FLEET[0]))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


#: cells per chunk of a row-chunked pass over a wide plane
PLANE_CHUNK_CELLS = 1 << 26


def plane_chunks(n: int, width: int):
    """``(lo, hi)`` bounds of consecutive row chunks of an [n, width] plane,
    each of at most :data:`PLANE_CHUNK_CELLS` cells (one row at least; in a
    fleet, the cells of every scenario count)."""
    step = max(1, PLANE_CHUNK_CELLS // max(1, width * max(1, _FLEET[0])))
    for lo in range(0, n, step):
        yield lo, min(n, lo + step)


def _any_scenario(flag: torch.Tensor) -> torch.Tensor:
    """A flag of the vmapped tick, one per scenario, reduced to one: set
    when any scenario's flag is set."""
    while _functorch.is_batchedtensor(flag):
        flag = _functorch.get_unwrapped(flag).any()
    return flag


def host_flags(*flags: torch.Tensor) -> list:
    """Read 0-d bool tensors to the host in ONE transfer. In a fleet tick a
    flag is set when it is set in any scenario: a gated branch then runs for
    every scenario, and is a no-op for a scenario whose own flag is clear.
    In a member-sharded tick a flag is set when it is set on any rank, so
    every rank takes the same branch."""
    HOST_SYNCS.count += 1
    flags = [_any_scenario(f) for f in flags]
    ctx = sharding.active()
    if ctx is not None:
        flags = ctx.flags(flags)
    if len(flags) == 1:
        return [bool(flags[0])]
    return [bool(v) for v in torch.stack(flags).tolist()]


def maximum_into_(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum(a, b, out=out)`` (vmap batches no ``out=``: a fleet
    tick writes the result through ``copy_``)."""
    if in_fleet():
        return out.copy_(torch.maximum(a, b))
    return torch.maximum(a, b, out=out)


def scatter_(t: torch.Tensor, dim: int, index: torch.Tensor, src) -> torch.Tensor:
    """``t.scatter_(dim, index, src)`` — in a fleet tick through the
    out-of-place ``scatter`` and ``copy_`` (vmap batches no ``scatter_``)."""
    if in_fleet():
        return t.copy_(t.scatter(dim, index, src))
    return t.scatter_(dim, index, src)


def index_amax_(t: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t.index_reduce_(0, index, src, "amax")`` — in a fleet tick as the
    same ``scatter_reduce_`` over the index broadcast along the rows (vmap
    has no batching rule for ``index_reduce_``)."""
    if in_fleet():
        idx = index.view((-1,) + (1,) * (src.dim() - 1)).expand(src.shape)
        return t.scatter_reduce_(0, idx, src, "amax", include_self=True)
    return t.index_reduce_(0, index, src, "amax")


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Ascending indices of the True entries of the 1-D ``mask``: the first
    ``size`` of them, padded with ``fill``. int64 [size]."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    return scatter_(out, 0, slot, torch.arange(n, device=mask.device))[:size]


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


def bytes64(t: torch.Tensor):
    """An int64 view of a contiguous bool or uint8 tensor whose last axis is
    a multiple of 8 bytes, or None (in a fleet tick too: vmap batches no
    dtype view on every torch build). A byte-wise AND or OR
    through it moves a word per eight cells, at the memory rate where a
    bool kernel runs well below it."""
    if in_fleet() or not t.is_contiguous() or t.shape[-1] % 8 or t.storage_offset() % 8:
        return None
    return t.view(torch.uint8).view(torch.int64)


def keep_columns_(ring: torch.Tensor, keep: torch.Tensor) -> None:
    """``ring &= keep`` in place along the last axis: [D, N, M] bool ring
    cells of the columns outside ``keep`` [M] are cleared."""
    ring64 = bytes64(ring)
    if ring64 is None:
        ring.logical_and_(keep)
    else:
        ring64.bitwise_and_((keep.to(torch.uint8) * 255).view(torch.int64))
