"""The engine-interface spelling the driver resolves through.

A port of the JAX package's ``ops/engine_api.py``, cut to the fields the
driver reads: an engine is one :class:`EngineOps` descriptor, and
:func:`resolve` picks it by the params type. The partial-view ("pview") and
sparse engines are ported; the dense engine is refused by name until its
slice lands (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class EngineOps:
    """One engine's plug surface, as the driver sees it."""

    name: str
    ops: object  # host-mutator module (join/crash/leave/links/snapshot/...)
    init_state: Callable  # (params, n_initial, warm, dense_links, device) -> state
    make_run: Callable  # (params, n_ticks) -> window run(state, draws, watch_rows=None)
    view_row: Callable  # (state, row) -> [N] int32 key row
    remembered_rows: Callable  # state -> [N] bool
    staleness: Callable  # state -> (stale [N] int32, up count)
    key_plane: Callable  # state -> the packed-key plane (its dtype is the layout)
    pool_slots: Callable  # params -> bounded pool size
    dense_links_default: bool


def _pview_engine() -> EngineOps:
    from . import pview as PV

    def _init(p, n, warm, dense_links, device):
        if dense_links:
            raise ValueError(
                "the pview engine has no [N, N] link plane — partitions use "
                "the group model (dense_links must be False/None)"
            )
        return PV.init_pview_state(p, n, warm=warm, device=device)

    return EngineOps(
        name="pview",
        ops=PV,
        init_state=_init,
        make_run=PV.make_pview_run,
        view_row=lambda state, row: PV.view_rows(state, [row])[0],
        remembered_rows=PV.remembered_rows,
        staleness=PV.staleness,
        key_plane=lambda state: state.nbr_key,
        pool_slots=lambda params: params.mr_pool,
        dense_links_default=False,
    )


def _sparse_engine() -> EngineOps:
    from . import sparse as SP

    def _init(p, n, warm, dense_links, device):
        return SP.init_sparse_state(p, n, warm=warm, dense_links=dense_links, device=device)

    return EngineOps(
        name="sparse",
        ops=SP,
        init_state=_init,
        make_run=SP.make_sparse_run,
        view_row=lambda state, row: state.view_key[row],
        remembered_rows=SP.remembered_rows,
        staleness=SP.staleness,
        key_plane=lambda state: state.view_key,
        pool_slots=lambda params: params.mr_slots,
        dense_links_default=False,
    )


_PORTED = {"pview": _pview_engine, "sparse": _sparse_engine}
_NOT_PORTED = {"dense": "A6"}


def engine(name: str) -> EngineOps:
    """The :class:`EngineOps` of the engine ``name``."""
    if name in _PORTED:
        return _PORTED[name]()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} engine is not ported yet (ROADMAP {_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown engine {name!r}; one of ['dense', 'pview', 'sparse']")


def resolve(params) -> EngineOps:
    """The engine a params object selects, by type (``PviewParams`` →
    pview, ``SparseParams`` → sparse)."""
    from .pview import PviewParams
    from .sparse import SparseParams

    if isinstance(params, PviewParams):
        return engine("pview")
    if isinstance(params, SparseParams):
        return engine("sparse")
    raise TypeError(
        f"params {type(params).__name__} selects no ported engine (expected PviewParams or "
        "SparseParams; the dense engine is ROADMAP A6)"
    )

