"""The engine-interface spelling the driver resolves through.

A port of the JAX package's ``ops/engine_api.py``, cut to the fields the
driver, the chaos runner, the telemetry and the trace planes read (the
member-mesh fields are filled for pview, the one engine on a mesh): an
engine is one :class:`EngineOps` descriptor, and :func:`resolve` picks it
by the params type. All three engines are ported: dense (``SimParams``), sparse (``SparseParams``) and
partial-view (``PviewParams``). The seams over the one [N, N] view plane
that dense and sparse share (``plane_*``, the sentinel initialiser) are
written once here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class EngineOps:
    """One engine's plug surface, as the driver sees it."""

    name: str
    ops: object  # host-mutator module (join/crash/leave/links/snapshot/...)
    init_state: Callable  # (params, n_initial, warm, dense_links, device) -> state
    make_run: Callable  # (params, n_ticks) -> window run(state, draws, watch_rows=None)
    # (params, n_ticks) -> adaptive window run(state, ad, draws, watch_rows=None);
    # refuses a default AdaptiveSpec. The fused name is the same window.
    make_adaptive_run: Callable
    sentinel_init: Callable  # (state, SentinelSpec) -> accumulator dict
    sentinel_reduce: Callable  # (state, sent, spec arrays) -> sent
    view_row: Callable  # (state, row) -> [N] int32 key row
    remembered_rows: Callable  # state -> [N] bool
    staleness: Callable  # state -> (stale [N] int32, up count)
    key_plane: Callable  # state -> the packed-key plane (its dtype is the layout)
    pool_slots: Callable  # params -> bounded pool size, or None (no pool)
    dense_links_default: bool
    telemetry_series: tuple = ()  # the metric ring's engine columns
    telemetry_window_vector: Callable = None  # (ms, state) -> [len(series)] f32
    # (params, n_ticks) -> fleet window run(fleet_state, draws, watch_rows=None)
    # over a leading [S] scenario axis (ops/fleet.py), and its adaptive twin
    # run(fleet_state, ad, draws, watch_rows=None); the fused name is the same
    make_fleet_run: Callable = None
    make_fleet_adaptive_run: Callable = None
    #: a fleet window's peak-memory budget factor, peak / (S x one state);
    #: None inherits the serial budget (the JAX engines' declared values)
    fleet_memory_factor: float | None = None
    # (params, n_ticks, TraceSpec) -> traced window run(state, ring, draws,
    # watch_rows=None): the trace ring appended in place each tick
    make_traced_run: Callable = None
    # (state, tracer_rows) -> [N, K] int32 view-key columns of the tracers
    # (the trace plane's window-boundary diff feed)
    tracer_view_cols: Callable = None
    # the member mesh (ops/sharding.py; None where the engine is not ported
    # to one): (mesh, params, n_ticks, dense_links) -> window, its adaptive
    # twin (mesh, params, n_ticks), its traced twin (mesh, params, n_ticks,
    # TraceSpec), and (state, mesh) -> this rank's shard / the whole state
    make_sharded_run: Callable = None
    make_sharded_adaptive_run: Callable = None
    make_sharded_traced_run: Callable = None
    shard_state: Callable = None
    gather_state: Callable = None
    # (mesh2d, params, n_ticks) -> fleet window on a 2-D scenarios x members
    # mesh, run(fleet_state, draws, watch_rows=None) over this rank's block
    make_sharded_fleet_run: Callable = None

    @property
    def supports_mesh(self) -> bool:
        """Whether the engine runs on a member mesh."""
        return self.make_sharded_run is not None

    @property
    def make_sharded_fused_run(self) -> Callable:
        """The JAX name of the fused sharded window: the same window."""
        return self.make_sharded_run

    @property
    def has_pool(self) -> bool:
        """Whether the engine carries a membership-rumor pool."""
        return self.pool_slots is not None

    @property
    def make_fused_adaptive_run(self) -> Callable:
        """The JAX name of the fused adaptive window: the same window."""
        return self.make_adaptive_run

    @property
    def make_fused_fleet_run(self) -> Callable:
        """The JAX name of the fused fleet window: the same window."""
        return self.make_fleet_run


# -- the seams of the two engines that hold the full [N, N] view plane (dense
# -- and sparse keep the same view_key / up leaves) ----------------------------


def plane_view_rows(state, rows) -> torch.Tensor:
    """[W, N] view rows of ``rows``, in the plane's key dtype."""
    from ._tick import row_index

    return state.view_key[row_index(rows, state.device)]


def plane_view_row(state, row: int) -> torch.Tensor:
    """[N] int32 view row of ``row``."""
    return state.view_key[row].to(torch.int32)


def plane_tracer_view_cols(state, tracer_rows) -> torch.Tensor:
    """The tracers' [N, K] int32 view-key columns of the [N, N] plane."""
    from ..trace.capture import gather_tracer_cols

    return gather_tracer_cols(state.view_key, tracer_rows)


def plane_remembered_rows(state) -> torch.Tensor:
    """[N] bool — rows some up member still holds a record about (row
    chunks)."""
    from ._tensor import plane_chunks

    n = state.capacity
    held = torch.zeros((n,), dtype=torch.bool, device=state.device)
    for lo, hi in plane_chunks(n, n):
        held |= ((state.view_key[lo:hi] >= 0) & state.up[lo:hi, None]).any(dim=0)
    return held


def plane_staleness(state):
    """Per-subject count of up observers holding a stale record (identity/
    incarnation below the subject's own diagonal; unknown counts stale),
    over row chunks in int32. Returns (int32 [N], the up count)."""
    from ._tensor import plane_chunks

    n = state.capacity
    up = state.up
    own = state.view_key.diagonal() >> 2
    stale = torch.zeros((n,), dtype=torch.int32, device=state.device)
    for lo, hi in plane_chunks(n, n):
        blk = (up[lo:hi, None] & up[None, :]) & ((state.view_key[lo:hi] >> 2) < own[None, :])
        stale += blk.sum(dim=0, dtype=torch.int32)
    return stale, up.sum()


def _plane_sentinel_init(sparse: bool) -> Callable:
    """The sentinel initialiser of the two view-plane engines (``sparse``
    adds the ``n_live`` drift counter)."""
    from ..chaos.sentinels import init_sentinel_state

    return lambda state, spec: init_sentinel_state(state.view_key, spec, sparse=sparse)


def _dense_engine() -> EngineOps:
    from . import kernel as K
    from . import state as S

    def _init(p, n, warm, dense_links, device):
        return S.init_state(p, n, warm=warm, dense_links=dense_links, device=device)

    return EngineOps(
        name="dense",
        ops=S,
        init_state=_init,
        make_run=K.make_run,
        make_adaptive_run=K.make_adaptive_run,
        sentinel_init=_plane_sentinel_init(sparse=False),
        sentinel_reduce=K.sentinel_reduce,
        view_row=plane_view_row,
        remembered_rows=plane_remembered_rows,
        staleness=plane_staleness,
        key_plane=lambda state: state.view_key,
        pool_slots=None,
        dense_links_default=True,
        telemetry_series=tuple(K.TELEMETRY_SERIES),
        telemetry_window_vector=K.telemetry_window_vector,
        make_fleet_run=K.make_fleet_run,
        make_fleet_adaptive_run=K.make_fleet_adaptive_run,
        make_traced_run=K.make_traced_run,
        tracer_view_cols=K.tracer_view_cols,
    )


def _pview_engine() -> EngineOps:
    from . import pview as PV
    from . import sharding as SH

    def _sharded(mesh, params, n_ticks, dense_links=False):
        if dense_links:
            raise ValueError("the pview engine has no [N, N] link plane (dense_links must be False/None)")
        return SH.make_sharded_pview_run(mesh, params, n_ticks)

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
        make_adaptive_run=PV.make_pview_adaptive_run,
        sentinel_init=PV.sentinel_init,
        sentinel_reduce=PV.sentinel_reduce,
        view_row=lambda state, row: PV.view_rows(state, [row])[0],
        remembered_rows=PV.remembered_rows,
        staleness=PV.staleness,
        key_plane=lambda state: state.nbr_key,
        pool_slots=lambda params: params.mr_pool,
        dense_links_default=False,
        telemetry_series=tuple(PV.TELEMETRY_SERIES),
        telemetry_window_vector=PV.telemetry_window_vector,
        make_fleet_run=PV.make_pview_fleet_run,
        make_fleet_adaptive_run=PV.make_pview_fleet_adaptive_run,
        fleet_memory_factor=5.5,
        make_traced_run=PV.make_pview_traced_run,
        tracer_view_cols=PV.tracer_view_cols,
        make_sharded_run=_sharded,
        make_sharded_adaptive_run=SH.make_sharded_pview_adaptive_run,
        make_sharded_traced_run=SH.make_sharded_pview_traced_run,
        shard_state=SH.shard_pview_state,
        gather_state=SH.gather_pview_state,
        make_sharded_fleet_run=SH.make_sharded_pview_fleet_run,
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
        make_adaptive_run=SP.make_sparse_adaptive_run,
        sentinel_init=_plane_sentinel_init(sparse=True),
        sentinel_reduce=SP.sentinel_reduce,
        view_row=plane_view_row,
        remembered_rows=plane_remembered_rows,
        staleness=plane_staleness,
        key_plane=lambda state: state.view_key,
        pool_slots=lambda params: params.mr_slots,
        dense_links_default=False,
        telemetry_series=tuple(SP.TELEMETRY_SERIES),
        telemetry_window_vector=SP.telemetry_window_vector,
        make_fleet_run=SP.make_sparse_fleet_run,
        make_fleet_adaptive_run=SP.make_sparse_fleet_adaptive_run,
        fleet_memory_factor=6.0,
        make_traced_run=SP.make_sparse_traced_run,
        tracer_view_cols=SP.tracer_view_cols,
    )


_ENGINES = {"dense": _dense_engine, "pview": _pview_engine, "sparse": _sparse_engine}


def engine(name: str) -> EngineOps:
    """The :class:`EngineOps` of the engine ``name``."""
    if name not in _ENGINES:
        raise ValueError(f"unknown engine {name!r}; one of {sorted(_ENGINES)}")
    return _ENGINES[name]()


def resolve(params) -> EngineOps:
    """The engine a params object selects, by type (``SimParams`` → dense,
    ``SparseParams`` → sparse, ``PviewParams`` → pview)."""
    from .pview import PviewParams
    from .sparse import SparseParams
    from .state import SimParams

    for cls, name in ((SimParams, "dense"), (SparseParams, "sparse"), (PviewParams, "pview")):
        if isinstance(params, cls):
            return engine(name)
    raise TypeError(
        f"params {type(params).__name__} selects no engine (expected SimParams, SparseParams "
        "or PviewParams)"
    )

