"""Member-axis sharding of the partial-view engine over ``torch.distributed``.

A port of the JAX package's ``ops/sharding.py`` for the pview engine. JAX
row-shards every ``[N, ...]`` state tensor over a ``"members"`` mesh axis
and lets GSPMD insert the collectives. PyTorch has no GSPMD: here each rank
of a process group holds its own rows, and every access across rows is an
explicit collective, spelled once in :class:`ShardContext` and called from
the tick at each such site (``ops/pview.py``). The rules:

* **Rows.** Rank r of W holds rows ``[r·L, (r+1)·L)``, L = N / W, of every
  member-axis leaf (:func:`pview_state_shardings` tags each leaf); the
  rumor pools, the partition cells, the link scalars and the tick stay
  whole and identical on every rank. Row ids on the tick are global.
* **Delivery** is the ragged record exchange (:mod:`.ragged_a2a`), one
  ``all_to_all_single`` a gossip tick; the delivery kernel is not called
  on a mesh (JAX refuses Pallas there: its ``sharding.py:328-336``).
* **Reads of another member's row** are an ``all_gather`` of what the
  phase reads (the ``up`` / ``part_id`` / ``self_key`` / suspicion
  vectors, the tracer rows), gathered once per tensor and tick.
* **Writes to another member's row** (the per-subject elections and
  evidence counts) are a global ``[N]`` table built on each rank, combined
  with ``all_reduce`` MAX / MIN / SUM, of which each rank keeps its rows.
* **SYNC** compacts its K callers over all N rows, so it runs on every rank
  over the gathered tables it reads (replicated work, as GSPMD's gathers
  would make it), and each rank keeps its rows of what it wrote.
* **Global reductions** (metrics, the early-free cover test, the flag
  reads) are ``all_reduce``; integer metric sums cross in int64.
* **The pool** stays replicated: the phases' re-gossip proposals are
  gathered in global row order, so every rank allocates the same slots.
* **Draws.** Every rank draws the full ``[N, ...]`` uniforms from the same
  seeded generator and keeps its rows (SYNC reads the callers' rows).

Collectives cross as int32, int64, uint8 or float32 only (gloo and NCCL
have no int16 or uint32): narrow keys and bool planes travel as bytes.

* **Late and pulled rows** cross in exact exchanges (:mod:`.ragged_a2a`):
  one ``all_to_all_single`` of the per-destination counts, then the
  records with those splits. The delay rings' late contacts go to their
  receivers' ranks (each rank writes its own rows of the rings), and the
  push-pull leg's peer rows come back in request order. Neither drops a
  record, as JAX's global gathers drop none.
* **The 2-D mesh.** :func:`make_pview_mesh2d` composes the fleet's
  ``"scenarios"`` axis with ``"members"``: each rank holds its scenarios'
  rows, the scenario axis carries no collective, and every member
  collective runs on the member sub-group. Every collective is a
  ``torch.library.custom_op`` with a vmap rule, so a fleet tick under
  ``torch.func.vmap`` makes one collective per site for all its
  scenarios, as a serial tick does.

Sharded windows (:func:`make_sharded_pview_run` and its fused, adaptive
and traced twins, and the fleet's :func:`make_sharded_pview_fleet_run`)
are bit-identical to the one-process port under the default exchange
budget, with and without the delay rings and the push-pull leg; a starved
budget drops on-time records as JAX's sharded run does and counts them in
``delivery_overflow``.

Not ported yet, and refused by name: the sparse and dense sharded windows
and states (ROADMAP A12 item 5).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

MEMBER_AXIS = "members"

#: the member-axis dimension of a leaf, by its tag (None: replicated)
ROW, RING, REPLICATED = 0, 1, None


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP A12 item 5)")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def make_mesh(devices=None):
    """A 1-D ``"members"`` device mesh over every rank of the default
    process group (:func:`.dcn.initialize` starts it: gloo for CPU tensors,
    NCCL for CUDA ones). ``devices`` is the device type, ``"cuda"`` by
    default as for every entry point of the port, or ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call ops.dcn.initialize first")
    device_type = "cuda" if devices is None else str(devices)
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(MEMBER_AXIS,))


def member_mesh_size(mesh) -> int:
    """The member-axis extent of ``mesh``: the ``"members"`` dimension's
    size, or the whole mesh's for a mesh without named dimensions."""
    names = mesh.mesh_dim_names or ()
    if MEMBER_AXIS in names:
        return mesh.size(names.index(MEMBER_AXIS))
    return mesh.size()


def _is_mesh2d(mesh) -> bool:
    from .fleet import FLEET_AXIS

    return tuple(getattr(mesh, "mesh_dim_names", None) or ()) == (FLEET_AXIS, MEMBER_AXIS)


def _check_member_mesh(mesh, fleet: bool = False) -> None:
    """A serial window, state or driver takes a 1-D ``"members"`` mesh; with
    ``fleet`` the 2-D scenarios x members mesh is taken too."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or (MEMBER_AXIS,))
    if getattr(mesh, "ndim", None) == 1 and names == (MEMBER_AXIS,):
        return
    if fleet and _is_mesh2d(mesh):
        return
    raise ValueError(
        f"a mesh with dimensions {getattr(mesh, 'mesh_dim_names', None)}: the serial sharded windows, states and "
        f"drivers take a 1-D '{MEMBER_AXIS}' mesh (make_mesh); a 2-D scenarios x members mesh "
        "(make_pview_mesh2d) runs the fleet (make_sharded_pview_fleet_run)")


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a mesh (the flight dump's and the profiler's
    stamp)."""
    names = mesh.mesh_dim_names or tuple(f"dim{i}" for i in range(mesh.ndim))
    return {str(k): int(mesh.size(i)) for i, k in enumerate(names)}


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_pview_word_alignment(mesh, params) -> None:
    """Pview mesh preconditions, as JAX states them: plain row divisibility,
    and the 32-row word rule (the packed member-axis bit planes must split
    on word boundaries)."""
    size = member_mesh_size(mesh)
    if params.capacity % size != 0:
        raise ValueError(f"capacity {params.capacity} not divisible by mesh size {size}")
    if params.capacity % (32 * size) != 0:
        raise ValueError(
            f"capacity {params.capacity} must be divisible by 32 * mesh size "
            f"({32 * size}): the pview packed bit planes must align "
            "with the row shards (pad capacity up and leave the extra rows "
            "up=False — masks make padding free)"
        )


# ---------------------------------------------------------------------------
# leaf placement
# ---------------------------------------------------------------------------


def pview_state_shardings(mesh, dense_links: bool = False, delay_slots: int = 0):
    """A ``PviewState``-shaped record of each leaf's placement: :data:`ROW`
    (split on dim 0), :data:`RING` (the ``[D, N, ...]`` rings, split on dim
    1) or :data:`REPLICATED` (whole on every rank: the pools, the scalar
    link model, the partition cells, the tick). ``dense_links`` must be
    falsy: the engine has no [N, N] link plane."""
    from .pview import PviewState

    if dense_links:
        raise ValueError("the pview engine has no [N, N] link plane (dense_links must be False/None)")
    ring = RING if delay_slots else REPLICATED
    tags = {f.name: ROW for f in dataclasses.fields(PviewState)}
    for name in ("tick", "mr_active", "mr_subject", "mr_key", "mr_created", "mr_origin",
                 "rumor_active", "rumor_origin", "rumor_created", "loss", "delay_q", "part_loss"):
        tags[name] = REPLICATED
    for name in ("pending_minf", "pending_inf", "pending_src"):
        tags[name] = ring
    return PviewState(**tags)


def _rank_rows(mesh, n: int) -> tuple[int, int]:
    size = member_mesh_size(mesh)
    if n % size:
        raise ValueError(f"capacity {n} not divisible by member-mesh size {size}")
    L = n // size
    r = mesh.get_local_rank(MEMBER_AXIS) if MEMBER_AXIS in (mesh.mesh_dim_names or ()) else mesh.get_rank()
    return r * L, (r + 1) * L


def shard_pview_state(state, mesh):
    """This rank's shard of a whole pview state (on any device): its rows of
    every member-axis leaf, the replicated leaves whole, all copied onto
    the mesh's device."""
    _check_member_mesh(mesh)
    tags = pview_state_shardings(mesh, False, state.pending_minf.shape[0])
    lo, hi = _rank_rows(mesh, state.capacity)
    dev = mesh_device(mesh)
    out = {}
    for f in dataclasses.fields(state):
        leaf, tag = getattr(state, f.name), getattr(tags, f.name)
        if not isinstance(leaf, torch.Tensor):
            out[f.name] = leaf
            continue
        if tag is not REPLICATED:
            leaf = leaf[lo:hi] if tag == ROW else leaf[:, lo:hi]
        out[f.name] = leaf.to(device=dev, memory_format=torch.contiguous_format, copy=True)
    return type(state)(**out)


def gather_pview_state(state, mesh):
    """The whole state from its shards, identical on every rank (an
    ``all_gather`` per member-axis leaf): what the driver's host mutators
    and host reads run on."""
    _check_member_mesh(mesh)
    group = mesh.get_group(MEMBER_AXIS)
    tags = pview_state_shardings(mesh, False, state.pending_minf.shape[0])
    out = {}
    for f in dataclasses.fields(state):
        leaf, tag = getattr(state, f.name), getattr(tags, f.name)
        if tag is REPLICATED or not isinstance(leaf, torch.Tensor):
            out[f.name] = leaf
        elif tag == ROW:
            out[f.name] = gather_rows(leaf, group)
        else:
            out[f.name] = gather_rows(leaf.transpose(0, 1), group).transpose(0, 1).contiguous()
    return type(state)(**out)


def shard_adaptive_state(ad, mesh):
    """This rank's rows of a whole adaptive state (its three planes are [N]
    member-axis tensors)."""
    from ..adaptive import AdaptiveState

    lo, hi = _rank_rows(mesh, ad.lh.shape[0])
    dev = mesh_device(mesh)
    return AdaptiveState(*(getattr(ad, k)[lo:hi].to(device=dev, copy=True) for k in ("lh", "conf_key", "conf")))


def replicated_sharding(mesh):
    """The placement of every telemetry tensor: whole on every rank."""
    return REPLICATED


def place_replicated(x, mesh):
    """``x`` on the mesh's device, whole on every rank."""
    return x.to(mesh_device(mesh))


# ---------------------------------------------------------------------------
# collectives (gloo and NCCL take int32, int64, uint8 and float32)
# ---------------------------------------------------------------------------
#
# Each collective is a ``torch.library.custom_op`` whose vmap rule issues ONE
# collective over the whole batch: under the fleet's ``torch.func.vmap`` a
# member collective carries every scenario of the rank's block at once (the
# scenario axis rides inside the rows), so a fleet tick makes as many
# collectives as a serial tick. The ops take the group by a registry index.

_WIRE = (torch.int32, torch.int64, torch.uint8, torch.float32)

#: process groups the collective ops name by index
_GROUPS: list = []


def group_index(group) -> int:
    """The registry index of ``group`` (registered on first use)."""
    for i, g in enumerate(_GROUPS):
        if g is group:
            return i
    _GROUPS.append(group)
    return len(_GROUPS) - 1


def group_of(index: int):
    return _GROUPS[index]


def _plain():
    """Inside an op's body the tensors are whole: a factory makes one tensor,
    not one per scenario."""
    from ._tensor import fleet_scope

    return fleet_scope(0)


@torch.library.custom_op("scalecube_port::gather_rows", mutates_args=())
def _gather_rows_op(x: torch.Tensor, group: int) -> torch.Tensor:
    with _plain():
        g = group_of(group)
        world = dist.get_world_size(g)
        x = x.contiguous()
        wire = x if x.dtype in _WIRE else x.view(torch.uint8)
        out = torch.empty((world * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype, device=x.device)
        # the list form exists and is current on every torch the port runs on
        dist.all_gather(list(out.view((world,) + tuple(wire.shape)).unbind(0)), wire, group=g)
        if wire is x:
            return out
        return out.view(x.dtype).reshape((world * x.shape[0],) + tuple(x.shape[1:]))


@_gather_rows_op.register_vmap
def _gather_rows_vmap(info, in_dims, x, group):
    """The batch rides behind the rows: ``[L, S, ...]`` gathers to ``[W·L,
    S, ...]`` in one collective."""
    (d, _g) = in_dims
    if d is None:
        return _gather_rows_op(x, group), None
    return _gather_rows_op(x.movedim(d, 1), group), 1


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` of each rank's ``[L, ...]`` rows into ``[W·L, ...]``
    in rank order. A dtype the collectives lack crosses as its bytes."""
    return _gather_rows_op(x, group_index(group))


_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}


@torch.library.custom_op("scalecube_port::all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, op: str, group: int) -> torch.Tensor:
    with _plain():
        g = group_of(group)
        if x.dtype == torch.bool:
            y = x.to(torch.uint8)
            dist.all_reduce(y, op=_OPS[op], group=g)
            return y.bool()
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=_OPS[op], group=g)
        return y


@_all_reduce_op.register_vmap
def _all_reduce_vmap(info, in_dims, x, op, group):
    """Elementwise: the batched tensor reduces whole, in one collective."""
    return _all_reduce_op(x, op, group), in_dims[0]


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """A reduced copy of ``x`` (``op``: max, min or sum); bools reduce as
    bytes (max = any, min = all)."""
    if x.dtype != torch.bool and x.dtype not in _WIRE:
        raise TypeError(f"all_reduce of {x.dtype}: widen it first")
    return _all_reduce_op(x, op, group_index(group))


class ShardContext:
    """This rank's view of a member-sharded tick: its rows ``[lo, hi)`` of N,
    the group, the exchange budget, and per tick the full draws and the
    gathered tensors (each gathered once per tick)."""

    def __init__(self, mesh, capacity: int, budget: Optional[int] = None):
        _check_member_mesh(mesh, fleet=True)
        self.mesh = mesh
        self.group = mesh.get_group(MEMBER_AXIS)
        self.group_id = group_index(self.group)
        self.size = member_mesh_size(mesh)
        self.n = int(capacity)
        self.lo, self.hi = _rank_rows(mesh, self.n)
        self.L = self.hi - self.lo
        self.rank = self.lo // self.L
        self.budget = budget
        self.draws = (None, None)
        self._cache: dict = {}
        self._rows: dict = {}

    # -- per tick ----------------------------------------------------------
    def begin_tick(self, fd, rd) -> None:
        self.draws = (fd, rd)
        self._cache.clear()

    def local_draws(self, r):
        """This rank's rows of a draw block (every leaf is [N, ...])."""
        if r is None:
            return None
        return type(r)(*(getattr(r, f.name)[self.lo:self.hi] for f in dataclasses.fields(r)))

    def rows(self, device) -> torch.Tensor:
        """int32 [L]: this rank's global row ids."""
        key = torch.device(device)
        if key not in self._rows:
            self._rows[key] = torch.arange(self.lo, self.hi, dtype=torch.int32, device=key)
        return self._rows[key]

    # -- collectives ---------------------------------------------------------
    def full(self, x: torch.Tensor) -> torch.Tensor:
        """All N rows of a member-axis tensor (gathered once per tick)."""
        hit = self._cache.get(id(x))
        if hit is not None and hit[0] is x:
            return hit[1]
        out = gather_rows(x, self.group)
        self._cache[id(x)] = (x, out)
        return out

    def reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        return all_reduce(x, op, self.group)

    def mine(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global [N, ...] table."""
        return x[self.lo:self.hi]

    def reduce_mine(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """A global [N, ...] table built on each rank, combined, and this
        rank's rows of it."""
        return self.mine(self.reduce(x, op))

    def offset(self, count: torch.Tensor) -> torch.Tensor:
        """The sum of ``count`` over the ranks before this one (int64)."""
        counts = gather_rows(count.reshape(1).to(torch.int64), self.group)
        return counts[: self.rank].sum()

    def flags(self, flags: list) -> list:
        """Host flags OR-ed over the ranks (one collective for all of them),
        so every rank takes the same branch."""
        return list(self.reduce(torch.stack([f.reshape(()) for f in flags]), "max").unbind(0))

    # -- the exact exchanges ---------------------------------------------------
    def late_exchange(self, payload, p_all, ok_late, d_all):
        """The delay rings' late contacts, delivered where the receivers live
        and elected there (:func:`.ragged_a2a.late_exchange`)."""
        from .ragged_a2a import late_exchange

        return late_exchange(payload, p_all, ok_late, d_all, self.lo, self.L, self.size, self.group_id)

    def fetch_rows(self, table, want):
        """Rows of the ``[L, C]`` member-axis ``table`` at the global ids
        ``want`` (-1: none), wherever they live (:func:`.ragged_a2a.fetch_rows`)."""
        from .ragged_a2a import fetch_rows

        return fetch_rows(table, want, self.L, self.size, self.group_id)


#: the armed context of the tick running here (None: unsharded)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("member_mesh", default=None)


def active() -> Optional[ShardContext]:
    """The :class:`ShardContext` of the sharded tick running here, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def _armed(ctx: Optional[ShardContext]):
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)


def ragged_delivery_context(mesh, capacity: int, budget: Optional[int] = None):
    """Arm the member-sharded tick on this rank (the JAX context of the same
    name): the pview tick's cross-row sites take their collectives, its
    host flags are OR-ed over the ranks, and its delivery takes the ragged
    exchange with the per-(src, dst) ``budget`` (None: the lossless
    default). The driver arms it around its host reads of the rows too."""
    return _armed(ShardContext(mesh, capacity, budget))


def unsharded():
    """Suspend the armed context: code inside runs on whole tensors."""
    return _armed(None)


# ---------------------------------------------------------------------------
# the sharded pview windows
# ---------------------------------------------------------------------------


def _sharded_tick(state, fd, rd, params, **kw):
    """The fused pview tick on this rank's rows: the full draws go to the
    context (SYNC and the structured peers read them), the rows' slices to
    the tick."""
    from .pview import pview_tick_fused

    ctx = active()
    ctx.begin_tick(fd, rd)
    return pview_tick_fused(state, ctx.local_draws(fd), ctx.local_draws(rd), params, **kw)


def _builder_checks(mesh, params, budget) -> None:
    from .ragged_a2a import check_budget

    _check_member_mesh(mesh)
    _check_pview_word_alignment(mesh, params)
    check_budget(params.fanout, params.capacity, member_mesh_size(mesh), budget)


def _window(mesh, params, n_ticks: int, budget, **kw):
    from ._tick import run_window
    from .pview import view_rows
    from .rand import draw_sparse_tick

    def run(state, draws, watch_rows=None, ad=None, ring=None):
        with ragged_delivery_context(mesh, params.capacity, budget):
            return run_window(_sharded_tick, view_rows, draw_sparse_tick, state, draws, n_ticks, params,
                              watch_rows, ad=ad, ring=ring, **kw)

    return run


def make_sharded_pview_run(mesh, params, n_ticks: int, a2a_budget: Optional[int] = None):
    """The sharded pview window ``run(state, draws, watch_rows=None) ->
    (state, metrics, watched)`` over ``mesh``: ``state`` is this rank's
    shard (:func:`shard_pview_state`), ``draws`` the generator or the
    per-tick full draws every rank shares; metrics and watched rows come
    out whole and identical on every rank, with ``delivery_overflow``
    added. ``a2a_budget`` is the exchange's per-(src, dst) record budget
    (None: the lossless default). The port has one tick spelling, so the
    unfused and fused windows are this one."""
    _builder_checks(mesh, params, a2a_budget)
    win = _window(mesh, params, n_ticks, a2a_budget)
    return lambda state, draws, watch_rows=None: win(state, draws, watch_rows)


make_sharded_pview_fused_run = make_sharded_pview_run


def make_sharded_pview_adaptive_run(mesh, params, n_ticks: int, a2a_budget: Optional[int] = None):
    """The sharded adaptive window ``run(state, ad, draws, watch_rows=None)
    -> (state, ad, metrics, watched)``; ``ad`` is this rank's rows
    (:func:`shard_adaptive_state`). Refuses a default spec."""
    _builder_checks(mesh, params, a2a_budget)
    if params.adaptive.is_default:
        raise ValueError(
            "make_sharded_pview_adaptive_run needs an enabled AdaptiveSpec on params — the default "
            "spec's program is make_sharded_pview_run's"
        )
    win = _window(mesh, params, n_ticks, a2a_budget)
    return lambda state, ad, draws, watch_rows=None: win(state, draws, watch_rows, ad=ad)


def make_sharded_pview_traced_run(mesh, params, n_ticks: int, trace, a2a_budget: Optional[int] = None):
    """The sharded trace-armed window ``run(state, ring, draws,
    watch_rows=None)``: the trace ring stays whole on every rank, and each
    tick appends the same record block on every rank (built from the
    gathered tracer rows)."""
    _builder_checks(mesh, params, a2a_budget)
    if not params.adaptive.is_default:
        raise ValueError("trace-armed adaptive windows are not supported")
    win = _window(mesh, params, n_ticks, a2a_budget, trace=trace)
    return lambda state, ring, draws, watch_rows=None: win(state, draws, watch_rows, ring=ring)


# ---------------------------------------------------------------------------
# the telemetry row on a mesh
# ---------------------------------------------------------------------------


def make_sharded_metric_append(mesh):
    """The ring append on a mesh: the row is whole on every rank, so each
    rank writes its own copy of the ring in place (no collective)."""
    return lambda ring, row: ring.append(row)


def make_sharded_telemetry_row(mesh, row_fn):
    """``row_fn`` (the plane's window row) on a mesh: its inputs are the
    sharded window's all-reduced metrics and the replicated pool leaves,
    so the row is the same on every rank; an ``all_reduce`` MAX pins it
    there (a no-op on equal rows)."""
    group = mesh.get_group(MEMBER_AXIS)

    def row(*args, **kwargs):
        return all_reduce(row_fn(*args, **kwargs), "max", group)

    return row


# ---------------------------------------------------------------------------
# the 2-D scenarios x members mesh (the fleet on row-sharded members)
# ---------------------------------------------------------------------------

_MESHES2D: dict = {}


def make_pview_mesh2d(n_scenarios: int, devices=None):
    """A 2-D ``("scenarios", "members")`` mesh over every rank of the default
    process group: ``n_scenarios`` scenario rows of W / n_scenarios member
    ranks each. The scenario axis carries no collective; the member
    collectives run on each row's member sub-group. ``devices`` is the
    device type (``"cuda"`` by default, or ``"cpu"``). Made once per device
    type, world and row count (a mesh makes its sub-groups collectively)."""
    from torch.distributed.device_mesh import init_device_mesh

    from .fleet import FLEET_AXIS

    if not dist.is_initialized():
        raise RuntimeError("make_pview_mesh2d needs a process group: call ops.dcn.initialize first")
    world = dist.get_world_size()
    if n_scenarios <= 0 or world % n_scenarios:
        raise ValueError(f"{world} devices do not factor into {n_scenarios} scenario rows")
    device_type = "cuda" if devices is None else torch.device(devices).type
    key = (device_type, world, int(n_scenarios))
    if key not in _MESHES2D:
        _MESHES2D[key] = init_device_mesh(device_type, (n_scenarios, world // n_scenarios),
                                          mesh_dim_names=(FLEET_AXIS, MEMBER_AXIS))
    return _MESHES2D[key]


def _check_mesh2d(mesh, what: str) -> None:
    if not _is_mesh2d(mesh):
        raise ValueError(f"{what} needs a 2-D scenarios x members mesh (make_pview_mesh2d); got axes "
                         f"{getattr(mesh, 'mesh_dim_names', None)}")


def shard_pview_fleet(fleet_state, mesh):
    """This rank's block of a whole ``[S, ...]`` pview fleet on a 2-D mesh:
    its scenario rows on dim 0 of every leaf (the fleet's split), its member
    rows on dim 1 of the member-axis leaves and on dim 2 of the ``[S, D, N,
    ...]`` rings; the pools, the link scalars and the zero-size rings of a
    fleet without delay whole per scenario."""
    from .fleet import _fleet_rows, fleet_size

    _check_mesh2d(mesh, "shard_pview_fleet")
    tags = pview_state_shardings(mesh, False, fleet_state.pending_minf.shape[1])
    s_lo, s_hi = _fleet_rows(mesh, fleet_size(fleet_state))
    lo, hi = _rank_rows(mesh, fleet_state.up.shape[1])
    dev = mesh_device(mesh)
    out = {}
    for f in dataclasses.fields(fleet_state):
        leaf, tag = getattr(fleet_state, f.name), getattr(tags, f.name)
        if not isinstance(leaf, torch.Tensor):
            out[f.name] = leaf
            continue
        leaf = leaf[s_lo:s_hi]
        if tag is not REPLICATED:
            leaf = leaf[:, lo:hi] if tag == ROW else leaf[:, :, lo:hi]
        out[f.name] = leaf.to(device=dev, memory_format=torch.contiguous_format, copy=True)
    return type(fleet_state)(**out)


def gather_pview_fleet(fleet_state, mesh):
    """The whole ``[S, ...]`` fleet from every rank's block (the inverse of
    :func:`shard_pview_fleet`), identical on every rank."""
    from .fleet import FLEET_AXIS

    _check_mesh2d(mesh, "gather_pview_fleet")
    members, scenarios = mesh.get_group(MEMBER_AXIS), mesh.get_group(FLEET_AXIS)
    tags = pview_state_shardings(mesh, False, fleet_state.pending_minf.shape[1])
    out = {}
    for f in dataclasses.fields(fleet_state):
        leaf, tag = getattr(fleet_state, f.name), getattr(tags, f.name)
        if not isinstance(leaf, torch.Tensor):
            out[f.name] = leaf
            continue
        if not leaf.numel():
            out[f.name] = leaf.new_empty((leaf.shape[0] * mesh.size(0),) + tuple(leaf.shape[1:]))
            continue
        if tag is not REPLICATED:
            dim = 1 if tag == ROW else 2
            leaf = gather_rows(leaf.movedim(dim, 0), members).movedim(0, dim)
        out[f.name] = gather_rows(leaf, scenarios).contiguous()
    return type(fleet_state)(**out)


def make_sharded_pview_fleet_run(mesh, params, n_ticks: int, a2a_budget: Optional[int] = None):
    """The fleet window on a 2-D scenarios x members mesh: ``run(fleet_state,
    draws, watch_rows=None) -> (fleet_state, metrics [S_r, T], watched)``
    over this rank's block (:func:`shard_pview_fleet`) of S_r scenarios.
    Each fleet tick is the sharded tick under ``torch.func.vmap`` over the
    scenarios; every collective's vmap rule carries the whole block at
    once, so the scenario axis adds none. ``draws`` gives each tick's full
    ``[S_r, N, ...]`` blocks: ``fleet.fleet_draws(gen, mesh, S)`` (the
    one-process fleet's draws, this rank's scenarios) or a per-tick
    sequence. Row s equals scenario s's serial sharded window."""
    from .fleet import run_fleet_window
    from .pview import view_rows
    from .rand import draw_sparse_tick
    from .ragged_a2a import check_budget

    _check_mesh2d(mesh, "make_sharded_pview_fleet_run")
    _check_pview_word_alignment(mesh, params)
    check_budget(params.fanout, params.capacity, member_mesh_size(mesh), a2a_budget)

    def run(fleet_state, draws, watch_rows=None):
        with ragged_delivery_context(mesh, params.capacity, a2a_budget):
            return run_fleet_window(_sharded_tick, view_rows, draw_sparse_tick, fleet_state, draws, n_ticks,
                                    params, watch_rows)

    return run


# ---------------------------------------------------------------------------
# refused by name (ROADMAP A12 item 5)
# ---------------------------------------------------------------------------


def state_shardings(mesh, dense_links: bool = True, delay_slots: int = 0):
    _not_ported("the dense engine's sharded state (state_shardings)")


def shard_state(state, mesh):
    _not_ported("the dense engine's sharded state (shard_state)")


def make_sharded_tick(mesh, params, dense_links: bool = True):
    _not_ported("the dense engine's sharded tick (make_sharded_tick)")


def make_sharded_run(mesh, params, n_ticks: int, dense_links: bool = True):
    _not_ported("the dense engine's sharded window (make_sharded_run)")


def sparse_state_shardings(mesh, dense_links: bool = False, delay_slots: int = 0):
    _not_ported("the sparse engine's sharded state (sparse_state_shardings)")


def shard_sparse_state(state, mesh):
    _not_ported("the sparse engine's sharded state (shard_sparse_state)")


def make_sharded_sparse_tick(mesh, params, dense_links: bool = False):
    _not_ported("the sparse engine's sharded tick (make_sharded_sparse_tick)")


def make_sharded_sparse_run(mesh, params, n_ticks: int):
    _not_ported("the sparse engine's sharded window (make_sharded_sparse_run)")
