"""The fleet engine: S independent clusters advanced by one window.

A port of the JAX package's ``ops/fleet.py``. A fleet state is the engine's
own state dataclass (``SimState``, ``SparseState``, ``PviewState``) with
every tensor leaf stacked to ``[S, ...]`` and ONE host-int ``tick`` shared
by all rows. The contract is the JAX one: row ``s`` of a fleet window equals
the serial window run on row ``s``'s state with row ``s``'s draws — every
state leaf, every per-tick metric, the same draws consumed.

How the batching is spelled: each tick is the engine's own serial tick under
``torch.func.vmap`` over the scenario axis (:func:`fleet_tick`), one vmapped
call per tick, inside :func:`._tensor.fleet_scope`. What that asks of the
tick, and what the port's tick does about it:

* **Host flag reads.** The quiet-tick gates read flags on the host
  (:func:`._tensor.host_flags`). In a fleet tick the flag of every scenario
  is reduced to one: the gate opens when any row's gate is open, one read per
  fleet tick whatever S. A row whose own gate is closed then runs the open
  branch, which is a no-op for it: the dense gates by construction (JAX's
  ``quiet_gates=False`` proves it, ``tests/test_fleet.py``), the sparse and
  pview gates (the suspicion/maintenance sweep with no suspect, the gossip
  phase with no live rumor, the pool's eviction with no priority proposal
  and its allocation with no valid proposal, the segmentation scan) because
  every write they make is masked by the quantity the flag reduces (the
  gossip phase's ``mr_any`` branch ages ``minf_age`` for every column; a
  freed column's age is 0, which each engine's rumor sweep sets, and an age of
  0 stays 0). The CPU tests hold each engine's fleet against JAX's
  ``lax.cond``-under-vmap select, row by row, and see each sparse and pview
  gate open in one row and closed in the other, the closed row equal to its
  serial window (``tests/test_torch_fleet.py``).
* **The kernel.** :func:`.delivery.delivery_combine` is a
  ``torch.library.custom_op`` whose vmap rule launches the scenario-axis
  variant of ``csrc/delivery_combine.cu``: one launch per fleet gossip tick.
* **In place.** Plane updates that vmap batches (``index_put_``,
  ``scatter_reduce_``, ``masked_fill_``, ``copy_``) address the ``[S, ...]``
  leaves as they are. A buffer the tick makes with ``torch.zeros`` /
  ``ones`` / ``full`` / ``empty`` is made once per scenario, so in-place
  updates of batched values land in it as they do serially. What vmap
  does not batch (``out=``, ``index_reduce_``, ``scatter_``, the bit
  planes' dtype views) takes its twin in a fleet tick (:mod:`._tensor`,
  :mod:`.bitplane`).
* **Row chunks** count the cells of all S scenarios.

**Draws.** A window takes a ``torch.Generator`` or a per-tick sequence of
``(fd, round)`` pairs with ``[S, ...]`` leaves. The generator draws each
site's ``[S, ...]`` block in ONE call (the engine's draw with an ``(S,)``
lead), one launch per site per tick whatever S. Row ``s`` of a generator-driven fleet therefore
equals a serial run fed row ``s``'s draws, not a serial run seeded with
``s``; per-row equality with JAX is tested by feeding the JAX fleet's
per-row draws through the sequence form.

**The scenario mesh.** :func:`fleet_mesh` spans every rank of the process
group with a ``"scenarios"`` axis; :func:`shard_fleet` gives each rank its
S / W scenarios of a fleet state, a draw block, a fold accumulator or a
seed list (a keyed scenario's chain is then made on its rank only). The
window runs each rank's scenarios with no collective inside: a generator
wrapped by :func:`fleet_draws` draws the whole ``[S, ...]`` blocks on every
rank and hands each rank its rows, so row s equals the one-process fleet's.
The Monte Carlo folds are combined once at the end
(:func:`fleet_fold_sum`, :func:`fleet_gather`).

**The 2-D scenarios x members mesh** (:func:`.sharding.make_pview_mesh2d`,
the pview engine): each rank holds its scenarios' member rows, and the
fleet tick is the member-sharded tick under the same vmap
(:func:`.sharding.make_sharded_pview_fleet_run`). Its collectives are
custom ops whose vmap rules carry the rank's whole scenario block in one
collective on the member sub-group; the scenario axis carries none.
:func:`fleet_draws` and :func:`fleet_gather` split and join the scenario
axis of such a mesh as they do a 1-D scenario mesh's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from ._tensor import fleet_scope

# ---------------------------------------------------------------------------
# fleet-state plumbing
# ---------------------------------------------------------------------------


def _leaf_names(state) -> tuple:
    """The tensor leaves of an engine state, in field order (every field but
    the host ``tick``)."""
    return tuple(f.name for f in dataclasses.fields(state) if f.name != "tick")


def fleet_size(fleet_state) -> int:
    """S, the scenario-axis length of a fleet state."""
    return fleet_state.up.shape[0]


def fleet_stack(states: Sequence):
    """Stack per-scenario states (same class, same shapes, same tick) into one
    fleet state; an adaptive state stacks the same way. Refuses states whose
    ticks differ: a fleet shares one."""
    states = list(states)
    ticks = {getattr(st, "tick", None) for st in states}
    if len(ticks) != 1:
        raise ValueError(f"fleet_stack: the states' ticks differ ({sorted(ticks)}); a fleet shares one tick")
    first = states[0]
    return dataclasses.replace(first, **{k: torch.stack([getattr(st, k) for st in states])
                                         for k in _leaf_names(first)})


def fleet_broadcast(state, s: int):
    """One state replicated to an ``[S, ...]`` fleet (the Monte Carlo start).
    Materialized copies: the fleet window updates its planes in place."""
    return dataclasses.replace(state, **{
        k: getattr(state, k)[None].expand((s,) + tuple(getattr(state, k).shape)).clone()
        for k in _leaf_names(state)
    })


def fleet_row(fleet_state, s: int):
    """Scenario ``s`` as an engine state of its own (copies: a serial window
    consumes the state it is given)."""
    return dataclasses.replace(fleet_state, **{k: getattr(fleet_state, k)[s].clone()
                                               for k in _leaf_names(fleet_state)})


def fleet_generator(seed: int, device="cuda") -> torch.Generator:
    """The fleet's draw source: one generator on ``device`` seeded with
    ``seed``, from which each tick draws every site's ``[S, ...]`` block in
    one call (the module docstring's choice, in place of JAX's ``fleet_keys``)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _vmap_state(fn: Callable, fleet_state, *args):
    """``fn(state, *args) -> state`` applied to every scenario of the fleet in
    one vmapped call, each of ``args`` with its own leading [S]."""
    names = _leaf_names(fleet_state)
    tick = fleet_state.tick
    cls = type(fleet_state)
    box = {}

    def one(leaves, *a):
        st = fn(cls(tick=tick, **dict(zip(names, leaves))), *a)
        box["tick"] = st.tick
        return tuple(getattr(st, k) for k in names)

    with fleet_scope(fleet_size(fleet_state)):
        leaves = vmap(one)(tuple(getattr(fleet_state, k) for k in names), *args)
    return fleet_state.replace(tick=box.get("tick", tick), **dict(zip(names, leaves)))


def fleet_inject_rumor(ops, fleet_state, slot: int, origins):
    """Per-scenario ``spread_rumor``: scenario ``s`` starts the rumor in
    ``slot`` at row ``origins[s]``."""
    origins = torch.as_tensor(np.asarray(origins, np.int64).reshape(-1), device=fleet_state.up.device)
    if origins.shape[0] != fleet_size(fleet_state):
        raise ValueError(f"{origins.shape[0]} origins for a fleet of {fleet_size(fleet_state)}")
    return _vmap_state(lambda st, o: ops.spread_rumor(st, int(slot), o), fleet_state, origins)


def fleet_uniform_loss(ops, fleet_state, floors, floor: bool = True):
    """Per-scenario uniform loss: scenario ``s`` gets ``floors[s]`` (a
    fraction), floored onto its links when ``floor``."""
    dev = fleet_state.up.device
    floors = torch.as_tensor(np.asarray(floors, np.float32), device=dev)
    return _vmap_state(lambda st, p: ops.set_uniform_loss(st, p, floor=floor), fleet_state, floors)


# ---------------------------------------------------------------------------
# the fleet window
# ---------------------------------------------------------------------------


def _fields(x) -> Optional[tuple]:
    return None if x is None else tuple(getattr(x, f.name) for f in dataclasses.fields(x))


def fleet_tick(tick: Callable, fleet_state, fd, rd, params, ad=None, view_rows=None, watch_rows=None):
    """One tick of every scenario: the engine's serial ``tick(state, fd, rd,
    params[, ad=])`` under ``torch.func.vmap``. ``fd`` (or None off FD ticks)
    and ``rd`` carry ``[S, ...]`` draws. Returns ``(fleet_state, [ad,]
    metrics [S], watched)``; ``watched`` is ``view_rows(state, watch_rows)``
    per scenario, or None."""
    names = _leaf_names(fleet_state)
    cls = type(fleet_state)
    t0 = fleet_state.tick
    fd_cls, rd_cls = (None if fd is None else type(fd)), type(rd)
    ad_cls = None if ad is None else type(ad)
    box = {}

    def one(leaves, fd_t, rd_t, ad_t):
        st = cls(tick=t0, **dict(zip(names, leaves)))
        f = None if fd_t is None else fd_cls(*fd_t)
        r = rd_cls(*rd_t)
        if ad_t is None:
            st, m = tick(st, f, r, params)
            ad_out = ()
        else:
            st, a, m = tick(st, f, r, params, ad=ad_cls(*ad_t))
            ad_out = _fields(a)
        box["tick"] = st.tick
        w = view_rows(st, watch_rows) if watch_rows is not None else ()
        return tuple(getattr(st, k) for k in names), ad_out, m, w

    in_dims = (0, None if fd is None else 0, 0, None if ad is None else 0)
    with fleet_scope(fleet_size(fleet_state)):
        leaves, ad_out, m, w = vmap(one, in_dims=in_dims)(
            tuple(getattr(fleet_state, k) for k in names), _fields(fd), _fields(rd), _fields(ad)
        )
    fleet_state = fleet_state.replace(tick=box["tick"], **dict(zip(names, leaves)))
    w = w if watch_rows is not None else None
    if ad is None:
        return fleet_state, m, w
    return fleet_state, ad_cls(*ad_out), m, w


def run_fleet_window(tick: Callable, view_rows: Callable, draw: Callable, fleet_state, draws,
                     n_ticks: int, params, watch_rows=None, ad=None):
    """Run ``n_ticks`` fleet ticks (the fleet twin of :func:`._tick.run_window`).

    ``draws`` is a ``torch.Generator`` on the fleet's device (each tick draws
    ``[S, ...]`` blocks with the engine's ``draw``) or ``n_ticks`` ``(fd,
    round)`` pairs with ``[S, ...]`` leaves. Returns ``(fleet_state, metrics
    [S, n_ticks], watched [S, n_ticks, W, N] or None)``, with ``ad`` (a fleet
    adaptive state) ``(fleet_state, ad, metrics, watched)``. Consumes
    ``fleet_state`` (and ``ad``)."""
    s = fleet_size(fleet_state)
    dev = fleet_state.up.device
    sliced = draws if isinstance(draws, ScenarioDraws) else None
    gen = draws if isinstance(draws, torch.Generator) else None
    if sliced is not None:
        if sliced.hi - sliced.lo != s:
            raise ValueError(f"draws for {sliced.hi - sliced.lo} scenarios, fleet of {s}")
        gen = sliced.gen
    if gen is not None and gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, fleet on {dev}")
    if gen is None and len(draws) != n_ticks:
        raise ValueError(f"{len(draws)} per-tick draws for a {n_ticks}-tick window")
    per_tick, watched = [], []
    for t in range(n_ticks):
        if sliced is not None:
            fd, rd = sliced.draw(draw, params, (fleet_state.tick + 1) % params.fd_every == 0)
        elif gen is not None:
            fd, rd = draw(gen, params, (fleet_state.tick + 1) % params.fd_every == 0, lead=(s,))
        else:
            fd, rd = draws[t]
            fd = None if fd is None else fd.to(dev)
            rd = rd.to(dev)
        if ad is None:
            fleet_state, m, w = fleet_tick(tick, fleet_state, fd, rd, params, None, view_rows, watch_rows)
        else:
            fleet_state, ad, m, w = fleet_tick(tick, fleet_state, fd, rd, params, ad, view_rows, watch_rows)
        per_tick.append(m)
        if watch_rows is not None:
            watched.append(w)
    ms = {k: torch.stack([m[k] for m in per_tick], dim=1) for k in per_tick[0]} if per_tick else {}
    watched = torch.stack(watched, dim=1) if watch_rows is not None else None
    return (fleet_state, ms, watched) if ad is None else (fleet_state, ad, ms, watched)


def make_fleet_window(tick: Callable, view_rows: Callable, draw: Callable, params, n_ticks: int,
                      adaptive: bool = False):
    """An engine's fleet window as a callable: ``run(fleet_state, draws,
    watch_rows=None) -> (fleet_state, metrics [S, T], watched)``, or with
    ``adaptive`` ``run(fleet_state, ad, draws, watch_rows=None) ->
    (fleet_state, ad, metrics, watched)``. The counterpart of JAX's
    ``jit(vmap(core))``; S is read from the state at each call."""
    if adaptive:
        if params.adaptive.is_default:
            raise ValueError(
                "make_fleet_adaptive_run needs an enabled AdaptiveSpec on params — the default "
                "spec's fleet window is make_fleet_run's"
            )

        def run_ad(fleet_state, ad, draws, watch_rows=None):
            return run_fleet_window(tick, view_rows, draw, fleet_state, draws, n_ticks, params,
                                    watch_rows, ad=ad)

        return run_ad

    def run(fleet_state, draws, watch_rows=None):
        return run_fleet_window(tick, view_rows, draw, fleet_state, draws, n_ticks, params, watch_rows)

    return run


def make_fleet_run(params, n_ticks: int):
    """The engine-resolving fleet window builder (``SimParams`` → dense,
    ``SparseParams`` → sparse, ``PviewParams`` → pview)."""
    from . import engine_api

    return engine_api.resolve(params).make_fleet_run(params, n_ticks)


def make_fleet_adaptive_run(params, n_ticks: int):
    """Fleet twin of the engines' ``make_adaptive_run``: the adaptive state
    rides stacked to ``[S, N]``. Refuses a default spec."""
    from . import engine_api

    return engine_api.resolve(params).make_fleet_adaptive_run(params, n_ticks)


#: the scenario mesh axis (orthogonal to ``sharding.MEMBER_AXIS``)
FLEET_AXIS = "scenarios"


def fleet_mesh(devices=None):
    """A 1-D ``"scenarios"`` mesh over every rank of the default process
    group (``devices``: the device type, ``"cuda"`` by default, or
    ``"cpu"``). Scenarios are independent: the fleet window needs no
    collective on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("fleet_mesh needs a process group: call ops.dcn.initialize first")
    kind = "cuda" if devices is None else str(devices)
    return init_device_mesh(kind, (dist.get_world_size(),), mesh_dim_names=(FLEET_AXIS,))


def _fleet_rows(mesh, s: int) -> tuple:
    """This rank's scenarios ``[lo, hi)`` of ``s``: the split of the
    ``"scenarios"`` axis (dim 0; of a 2-D scenarios x members mesh too)."""
    w = mesh.size(0)
    if s % w:
        raise ValueError(f"fleet size {s} does not divide over the {w}-device scenario mesh")
    per = s // w
    r = mesh.get_local_rank(0)
    return r * per, (r + 1) * per


def shard_fleet(tree, mesh):
    """This rank's scenarios of ``tree``, whose leaves all lead with the same
    [S] (S must divide over the mesh): a fleet state (the host ``tick``
    kept), an adaptive or draw dataclass, a tensor, a numpy array or a
    sequence of per-scenario values (e.g. the seeds of a ``KeyChain``), or
    a tuple / list / dict of them. Tensors are copied onto the mesh's
    device; zero-size leaves pass whole."""
    from .sharding import mesh_device

    def is_leaf(x) -> bool:
        if isinstance(x, torch.Tensor) and x.dim() == 0:
            return False  # a shared scalar passes whole
        return isinstance(x, (torch.Tensor, np.ndarray)) or (
            isinstance(x, (tuple, list)) and not any(isinstance(v, (torch.Tensor, np.ndarray, dict, tuple, list))
                                                     or dataclasses.is_dataclass(v) for v in x))

    def walk(x, fn):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name), fn)
                                             for f in dataclasses.fields(x) if f.name != "tick"})
        if isinstance(x, dict):
            return {k: walk(v, fn) for k, v in x.items()}
        if not is_leaf(x) and not isinstance(x, (tuple, list)):
            return x.to(mesh_device(mesh)) if isinstance(x, torch.Tensor) else x
        if is_leaf(x):
            return fn(x)
        return type(x)(walk(v, fn) for v in x)

    sizes = set()

    def note(x):
        if len(x):
            sizes.add(len(x))
        return x

    walk(tree, note)
    if len(sizes) != 1:
        raise ValueError(f"shard_fleet: the leaves lead with different scenario counts {sorted(sizes)}")
    lo, hi = _fleet_rows(mesh, sizes.pop())
    dev = mesh_device(mesh)

    def cut(x):
        if isinstance(x, torch.Tensor):
            x = x[lo:hi] if len(x) else x
            return x.to(device=dev, memory_format=torch.contiguous_format, copy=True)
        return x[lo:hi] if len(x) else x

    return walk(tree, cut)


class ScenarioDraws:
    """A fleet window's draw source on the scenario mesh: each tick draws the
    whole ``[S, ...]`` blocks from ``gen`` (every rank the same) and hands
    the window this rank's rows."""

    def __init__(self, gen: torch.Generator, mesh, s: int):
        self.gen = gen
        self.s = int(s)
        self.lo, self.hi = _fleet_rows(mesh, self.s)

    def draw(self, draw: Callable, params, fd_due: bool):
        blocks = draw(self.gen, params, fd_due, lead=(self.s,))
        return tuple(None if b is None else type(b)(*(getattr(b, f.name)[self.lo:self.hi]
                                                      for f in dataclasses.fields(b))) for b in blocks)


def fleet_draws(gen: torch.Generator, mesh, s: int) -> ScenarioDraws:
    """The draw source of a sharded fleet of ``s`` scenarios in all: the
    one-process fleet's draws, each rank's rows."""
    return ScenarioDraws(gen, mesh, s)


def fleet_fold_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A Monte Carlo fold summed over the ranks' scenarios (``all_reduce``;
    integers cross as int64)."""
    from .sharding import all_reduce

    wide = x.to(torch.int64) if not x.is_floating_point() else x
    return all_reduce(wide, "sum", mesh.get_group(FLEET_AXIS)).to(x.dtype)


def fleet_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Per-scenario values ``[S / W, ...]`` of every rank, in scenario order."""
    from .sharding import gather_rows

    return gather_rows(x, mesh.get_group(FLEET_AXIS))


# ---------------------------------------------------------------------------
# the batched StateTimeline fold
# ---------------------------------------------------------------------------

#: engine ops-module callables the chaos StateTimeline replays
_TIMELINE_MUTATORS = frozenset({
    "crash_rows", "crash_row", "join_row", "join_rows", "begin_leave",
    "set_link_loss", "set_link_delay", "set_uniform_loss",
    "block_partition", "heal_partition", "spread_rumor", "update_metadata",
    "heal_partition_pair", "set_link_delay_q",
    "block_partition_assign", "heal_partition_assign", "drop_refutes",
})


@dataclasses.dataclass(frozen=True)
class FleetVary:
    """Per-scenario arguments of a shared chaos schedule (the JAX
    ``FleetVary``): ``crash_rows`` [S] (the one Crash event's row per
    scenario), ``loss_pct`` [S] percent (every uniform-loss FLOOR write),
    ``delay_ticks`` [S] (every positive scheduled link-delay write; dense
    delay rings only) and ``partition_assign`` [S, N] (the one Partition's
    group assignment, ``-1`` a bystander; dense links only)."""

    crash_rows: Optional[object] = None
    loss_pct: Optional[object] = None
    delay_ticks: Optional[object] = None
    partition_assign: Optional[object] = None

    def validate(self, scenario) -> None:
        from ..chaos.events import Crash, Partition, ScenarioError, SlowEpoch, SlowMember, ZoneOutage

        if self.crash_rows is not None:
            crashes = [e for e in scenario.events if isinstance(e, Crash)]
            if len(crashes) != 1 or len(crashes[0].rows) != 1:
                raise ScenarioError(
                    "FleetVary.crash_rows needs a scenario with exactly one Crash event naming one "
                    f"row (the per-scenario subject it replaces); {scenario.name!r} schedules "
                    f"{[list(c.rows) for c in crashes]}"
                )
        if self.delay_ticks is not None:
            if not [e for e in scenario.events if isinstance(e, (SlowMember, SlowEpoch))]:
                raise ScenarioError(
                    "FleetVary.delay_ticks varies the scheduled link-delay writes, but "
                    f"{scenario.name!r} schedules no SlowMember/SlowEpoch event — nothing to vary"
                )
        if self.partition_assign is not None:
            parts = [e for e in scenario.events if isinstance(e, Partition)]
            zones = [e for e in scenario.events if isinstance(e, ZoneOutage)]
            if len(parts) != 1 or zones:
                raise ScenarioError(
                    "FleetVary.partition_assign needs a scenario with exactly one Partition event "
                    "and no ZoneOutage (every block/heal in the schedule is replaced by the "
                    f"per-scenario assignment); {scenario.name!r} schedules {len(parts)} Partition "
                    f"+ {len(zones)} ZoneOutage"
                )


class FleetOps:
    """The chaos-mutator surface of an engine ops module, applied to every
    scenario of a fleet in one vmapped call per action, the scheduled
    arguments broadcast; a :class:`FleetVary` swaps the crash row, the
    uniform-loss floor, the delay or the partition shape per scenario.
    Non-mutator attributes pass through."""

    def __init__(self, ops, vary: Optional[FleetVary] = None):
        self._ops = ops
        self._vary = vary

    def __getattr__(self, name):
        target = getattr(self._ops, name)
        if name not in _TIMELINE_MUTATORS or not callable(target):
            return target
        vary = self._vary

        def dev_of(fs):
            return fs.up.device

        if name == "crash_rows" and vary is not None and vary.crash_rows is not None:
            def crash(fs, _rows, **kwargs):
                rows_s = torch.as_tensor(np.asarray(vary.crash_rows, np.int64), device=dev_of(fs))
                return _vmap_state(lambda st, r: target(st, r.reshape(1)), fs, rows_s)

            return crash

        if name == "set_link_delay" and vary is not None and vary.delay_ticks is not None:
            from .state import delay_mean_to_q

            target_q = getattr(self._ops, "set_link_delay_q")

            def delay(fs, src, dst, mean, **kwargs):
                if float(mean) > 0:
                    q_s = torch.as_tensor(
                        np.asarray([delay_mean_to_q(float(m)) for m in vary.delay_ticks], np.float32),
                        device=dev_of(fs),
                    )
                    return _vmap_state(lambda st, q: target_q(st, src, dst, q), fs, q_s)
                return _vmap_state(lambda st: target(st, src, dst, mean), fs)

            return delay

        if name in ("block_partition", "heal_partition_pair") and vary is not None \
                and vary.partition_assign is not None:
            def assign_of(fs):
                return torch.as_tensor(np.asarray(vary.partition_assign, np.int32), device=dev_of(fs))

            if name == "block_partition":
                block = getattr(self._ops, "block_partition_assign")

                def blk(fs, _a, _b, **kwargs):
                    return _vmap_state(block, fs, assign_of(fs))

                return blk
            heal = getattr(self._ops, "heal_partition_assign")

            def hl(fs, _a, _b, clear=0.0, **kwargs):
                return _vmap_state(lambda st, g: heal(st, g, clear=clear), fs, assign_of(fs))

            return hl

        if name == "set_uniform_loss" and vary is not None and vary.loss_pct is not None:
            def uniform(fs, loss, floor=False):
                if not floor:
                    return _vmap_state(lambda st: target(st, loss, floor=floor), fs)
                frac_s = torch.as_tensor(np.asarray(vary.loss_pct, np.float32), device=dev_of(fs)) / 100.0
                return _vmap_state(lambda st, p: target(st, p, floor=True), fs, frac_s)

            return uniform

        def broadcast(fs, *args, **kwargs):
            return _vmap_state(lambda st: target(st, *args, **kwargs), fs)

        return broadcast


def _fleet_timeline_class():
    from ..chaos.engine import StateTimeline

    class FleetStateTimeline(StateTimeline):
        """:class:`StateTimeline` over a fleet state: the storm stash holds
        the ``[S, ...]`` loss planes, and the storm's end restores each
        scenario's (a per-scenario uniform loss through the ops module, a
        per-scenario plane with its round-trip plane)."""

        def _storm_end(self, state):
            from ..chaos.events import ScenarioError

            if self._storm_stash is None:
                raise ScenarioError("storm_end without an active storm")
            loss = self._storm_stash
            self._storm_stash = None
            if loss.dim() == 1:
                state = _vmap_state(lambda st, l: self._ops._ops.set_uniform_loss(st, l), state, loss)
            else:
                from .state import _roundtrip

                state = state.replace(loss=loss, fetch_rt=_roundtrip(loss))
            for fn in self._storm_replay:
                state = fn(state)
            self._storm_replay = []
            return state

    return FleetStateTimeline


def fleet_timeline(scenario, ops, dense_links: bool, horizon=None, vary: Optional[FleetVary] = None):
    """A chaos ``StateTimeline`` whose schedule replays onto a FLEET state:
    the same validation, the same ordered fold, the same loss-storm
    stash/replay semantics, each action one vmapped call over all S
    scenarios. ``vary`` makes the crash row / loss floor / delay /
    partition shape per-scenario arguments (:class:`FleetVary`)."""
    if vary is not None:
        from ..chaos.events import ScenarioError

        vary.validate(scenario)
        if vary.delay_ticks is not None and (not dense_links or not hasattr(ops, "set_link_delay_q")):
            raise ScenarioError(
                "FleetVary.delay_ticks needs the dense delay plane and an ops module with "
                f"set_link_delay_q (the precomputed-q write); {getattr(ops, '__name__', ops)!r} with "
                f"dense_links={dense_links} cannot batch per-scenario delays"
            )
        if vary.partition_assign is not None and (not dense_links or not hasattr(ops, "block_partition_assign")):
            raise ScenarioError(
                "FleetVary.partition_assign needs dense [N, N] links and an ops module with the "
                "assign-vector partition spellings (block/heal_partition_assign); "
                f"{getattr(ops, '__name__', ops)!r} with dense_links={dense_links} cannot batch "
                "per-scenario partition shapes"
            )
    return _fleet_timeline_class()(scenario, FleetOps(ops, vary), dense_links=dense_links, horizon=horizon)


def fleet_sentinel_init(eng, fleet_state, spec) -> dict:
    """The chaos sentinels' accumulators of every scenario: the engine's
    ``sentinel_init`` under ``vmap`` (each leaf [S, ...])."""
    names = _leaf_names(fleet_state)
    cls, tick = type(fleet_state), fleet_state.tick

    def one(leaves):
        return eng.sentinel_init(cls(tick=tick, **dict(zip(names, leaves))), spec)

    with fleet_scope(fleet_size(fleet_state)):
        return vmap(one)(tuple(getattr(fleet_state, k) for k in names))


def fleet_sentinel_reduce(eng, fleet_state, sent: dict, spec_dev: dict) -> dict:
    """One sentinel check of every scenario in one batched call: the
    engine's ``sentinel_reduce`` under ``vmap`` over the fleet state and
    the [S, ...] accumulators, the spec arrays shared. On the device;
    nothing is read back."""
    names = _leaf_names(fleet_state)
    cls, tick = type(fleet_state), fleet_state.tick

    def one(leaves, sent_s):
        return eng.sentinel_reduce(cls(tick=tick, **dict(zip(names, leaves))), sent_s, spec_dev)

    with fleet_scope(fleet_size(fleet_state)):
        return vmap(one)(tuple(getattr(fleet_state, k) for k in names), sent)


# ---------------------------------------------------------------------------
# on-device fleet reductions (the Monte Carlo folds)
# ---------------------------------------------------------------------------


def fold_first_full_coverage(hit_tick: torch.Tensor, coverage: torch.Tensor, window_start: int) -> torch.Tensor:
    """Latch per-scenario first-full-coverage ticks from one window's
    coverage curves: ``hit_tick`` [S] int32 (-1: not yet), ``coverage``
    [S, T] (one rumor slot), ``window_start`` the absolute tick at window
    entry. On device; nothing is read back."""
    hit = coverage >= 1.0
    any_hit = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.uint8), dim=1).to(torch.int32)
    cand = first + (int(window_start) + 1)
    return torch.where((hit_tick < 0) & any_hit, cand, hit_tick)


def fleet_false_dead(fleet_state, watch_up_mask: torch.Tensor) -> torch.Tensor:
    """[S] int32: per scenario, how many watched rows (``watch_up_mask`` [N]
    bool, and up) some up observer holds DEAD (rank 3, known key) — the
    chaos false-positive sentinel's check. Dense and sparse states."""
    vk = fleet_state.view_key
    up = fleet_state.up
    dead = (vk >= 0) & ((vk & 3) == 3)
    watched = watch_up_mask.to(up.device)[None, :] & up
    return (dead & up[:, :, None] & watched[:, None, :]).any(dim=1).sum(dim=1, dtype=torch.int32)


def _crash_detected(fleet_state, rows: torch.Tensor) -> torch.Tensor:
    vk = fleet_state.view_key
    up = fleet_state.up
    s, n = up.shape
    col = vk.gather(2, rows.view(s, 1, 1).expand(s, n, 1))[..., 0]
    others_up = up & (torch.arange(n, device=up.device)[None, :] != rows[:, None])
    return (~others_up | ((col & 3) == 3)).all(dim=1)


def fleet_crash_detected(fleet_state, crash_row: int) -> torch.Tensor:
    """[S] bool: per scenario, does every up observer read ``crash_row`` at
    rank DEAD (an unknown key reads rank 3 too)?"""
    s = fleet_size(fleet_state)
    rows = torch.full((s,), int(crash_row), dtype=torch.int64, device=fleet_state.up.device)
    return _crash_detected(fleet_state, rows)


def fleet_crash_detected_varied(fleet_state, crash_rows) -> torch.Tensor:
    """[S] bool twin of :func:`fleet_crash_detected` for a varied fleet: the
    subject of scenario ``s`` is ``crash_rows[s]``."""
    dev = fleet_state.up.device
    if isinstance(crash_rows, torch.Tensor):
        rows = crash_rows.to(device=dev, dtype=torch.int64)
    else:
        rows = torch.as_tensor(np.asarray(crash_rows, np.int64), device=dev)
    return _crash_detected(fleet_state, rows)
