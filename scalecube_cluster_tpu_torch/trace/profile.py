"""Tick-phase profiler: a window re-run with every protocol phase timed.

The production window runs each tick's phases back to back, so a slow
window does not say which phase (FD selection, the gossip merge, SYNC's
compacted exchange, the suspicion sweep, the metrics) paid for it. This
module runs the same tick — the engine's own ``tick(..., timer=)``, which
scopes each phase, so there is one spelling of the tick and the final
state equals the window's bit for bit — with every phase:

* timed on the device between two CUDA events (on the CPU with
  ``perf_counter``), the device drained at each phase's end so the next
  phase starts on an idle stream — the price of the microscope, and why
  this is a mode and not the production path;
* under a ``torch.profiler.record_function`` of the JAX phase name
  (``scalecube/<phase>``), so a surrounding ``torch.profiler`` capture
  shows the phases on the timeline under their protocol names.

The phase times sum to within 20% of the split window's wall time (the
coverage check), and the ``timeline`` renders through
:func:`.export.profile_to_events`. The port of the JAX package's
``trace/profile.py``, whose result dict this keeps key for key.

On a mesh (``mesh=``) the phases are the member-sharded tick's
(:func:`..ops.sharding.ragged_delivery_context` armed), so the final state
equals the sharded window's; a 2-D scenarios x members mesh profiles the
sharded fleet. Each rank times its own phases: the result carries rank 0's
times (the same dict on every rank), the maximum over the ranks beside
them (``phases_s_max_over_ranks``, ``wall_s_max_over_ranks``), and
``"mesh": {axis: size}``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Tuple

import torch

#: phase names in execution order, per engine (the sparse tick has the pool
#: allocation phase the dense tick lacks)
DENSE_PHASES = (
    "rand", "fd", "suspicion", "gossip", "sync", "refute", "sweep",
    "telemetry",
)
SPARSE_PHASES = (
    "rand", "fd", "suspicion", "gossip", "sync", "refute", "sweep", "alloc",
    "telemetry",
)
#: pview shares the sparse phase list — its "suspicion" phase is the
#: maintenance sweep (expiry, tombstone purge, active-view promotion)
PVIEW_PHASES = SPARSE_PHASES


class _Timer:
    """Accumulates per-phase time and the flat event timeline. ``tick`` is
    the index the timeline records; the caller sets it per tick."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.totals: Dict[str, float] = {}
        self.timeline: List[Dict] = []
        self.tick = 0
        self.t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        with torch.profiler.record_function(f"scalecube/{name}"):
            if self.cuda:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                yield
                ev1.record()
                ev1.synchronize()
                dur = ev0.elapsed_time(ev1) / 1e3
            else:
                yield
                dur = time.perf_counter() - start
        self.totals[name] = self.totals.get(name, 0.0) + dur
        self.timeline.append({
            "phase": name, "tick": self.tick,
            "start_s": round(start - self.t0, 7), "dur_s": round(dur, 7),
        })


def _engine_of(params) -> Tuple[str, Callable, Callable]:
    """(engine name, its tick, its draw function)."""
    from ..ops.pview import PviewParams
    from ..ops.rand import draw_dense_tick, draw_sparse_tick
    from ..ops.sparse import SparseParams

    if isinstance(params, PviewParams):
        from ..ops.pview import pview_tick_fused

        return "pview", pview_tick_fused, draw_sparse_tick
    if isinstance(params, SparseParams):
        from ..ops.sparse import sparse_tick_fused

        return "sparse", sparse_tick_fused, draw_sparse_tick
    from ..ops.kernel import tick

    return "dense", tick, draw_dense_tick


def _draw_source(draws, n: int):
    """Per-tick draws from a generator, or from a sequence of ``n`` pairs."""
    if isinstance(draws, torch.Generator):
        return None
    if len(draws) != n:
        raise ValueError(f"{len(draws)} per-tick draws for {n} profiled ticks (warm-up included)")
    return list(draws)


def _run(step: Callable, draw: Callable, params, state, draws, n_ticks: int, warmup_ticks: int, device,
         lead=None):
    """Warm-up ticks with a throwaway timer, then the measured ticks:
    ``step(state, fd, round, timer) -> state``, its draws from ``draw`` on
    a generator, from a sharded fleet's draw source, or from the sequence
    ``draws``."""
    from ..ops.fleet import ScenarioDraws

    scen = draws if isinstance(draws, ScenarioDraws) else None
    seq = None if scen is not None else _draw_source(draws, warmup_ticks + n_ticks)
    timer = _Timer(device)

    def one(state, t, tm):
        tm.tick = t
        with tm.phase("rand"):
            if scen is not None:
                fd, rd = scen.draw(draw, params, (state.tick + 1) % params.fd_every == 0)
            elif seq is None:
                fd, rd = draw(draws, params, (state.tick + 1) % params.fd_every == 0, **(lead or {}))
            else:
                fd, rd = seq[t]
                fd = None if fd is None else fd.to(device)
                rd = rd.to(device)
        return step(state, fd, rd, tm)

    for t in range(warmup_ticks):
        state = one(state, t, _Timer(device))
    wall0 = time.perf_counter()
    for t in range(n_ticks):
        state = one(state, warmup_ticks + t, timer)
    if timer.cuda:
        torch.cuda.synchronize(device)
    return state, timer, time.perf_counter() - wall0


def _over_ranks(mesh, timer: _Timer, wall: float, phases) -> tuple:
    """Rank 0's phase totals and wall time, and the maxima over the ranks
    (int64 nanoseconds gathered over the member axis, then the scenario
    axis of a 2-D mesh)."""
    from ..ops.fleet import FLEET_AXIS
    from ..ops.sharding import MEMBER_AXIS, _is_mesh2d, gather_rows, mesh_device

    mine = torch.tensor([[round(timer.totals.get(k, 0.0) * 1e9) for k in phases] + [round(wall * 1e9)]],
                        dtype=torch.int64, device=mesh_device(mesh))
    every = gather_rows(mine, mesh.get_group(MEMBER_AXIS))
    if _is_mesh2d(mesh):
        every = gather_rows(every, mesh.get_group(FLEET_AXIS))
    every = every.cpu().double() / 1e9
    first, top = every[0].tolist(), every.max(dim=0).values.tolist()
    return dict(zip(phases, first[:-1])), first[-1], dict(zip(phases, top[:-1])), top[-1]


def _result(engine: str, n: int, n_ticks: int, warmup_ticks: int, wall: float, timer: _Timer, mesh=None,
            **extra) -> Dict:
    mesh_extra = {}
    if mesh is not None:
        from ..ops.sharding import mesh_axes

        phases = sorted(timer.totals)
        totals, wall, top, top_wall = _over_ranks(mesh, timer, wall, phases)
        timer.totals = totals
        mesh_extra = {"phases_s_max_over_ranks": {k: round(v, 6) for k, v in top.items()},
                      "wall_s_max_over_ranks": round(top_wall, 6)}
    phase_sum = sum(timer.totals.values())
    return {
        "engine": engine,
        "n": n,
        "mesh": None if mesh is None else mesh_axes(mesh),
        **extra,
        **mesh_extra,
        "ticks": n_ticks,
        "warmup_ticks": warmup_ticks,
        "wall_s": round(wall, 6),
        "phase_sum_s": round(phase_sum, 6),
        # phase coverage of the measured wall time — held within 20% of 1.0
        # (the loop is phases plus epsilon)
        "phase_coverage": round(phase_sum / wall, 4) if wall else None,
        "split_ticks_per_s": round(n_ticks / wall, 2) if wall else None,
        "phases_s": {k: round(v, 6) for k, v in sorted(timer.totals.items())},
        "phases_pct": {
            k: round(100.0 * v / phase_sum, 2) for k, v in sorted(timer.totals.items())
        } if phase_sum else {},
        "timeline": timer.timeline,
    }


def _mesh_checks(mesh, params, a2a_budget, fleet: bool = False):
    """The sharded window builders' preconditions (the three engines on a
    1-D mesh; pview's fleet on a 2-D one). Returns the sharded tick."""
    from ..ops import sharding as SH
    from ..ops.pview import PviewParams
    from ..ops.ragged_a2a import check_budget
    from ..ops.sparse import SparseParams

    if not isinstance(params, PviewParams):
        sparse = isinstance(params, SparseParams)
        if fleet:
            engine = "sparse" if sparse else "dense"
            raise ValueError(f"the {engine} engine has no fleet on a member mesh (as in JAX: no sharded "
                             f"{engine} fleet window)")
        SH._check_member_mesh(mesh)
        if sparse:
            SH._check_sparse_word_alignment(mesh, params)
            return SH._sparse_sharded_tick
        SH._check_dense_word_alignment(mesh, params)
        return SH._dense_sharded_tick
    if fleet:
        SH._check_mesh2d(mesh, "profile_fleet_ticks(mesh=)")
    else:
        SH._check_member_mesh(mesh)
    SH._check_pview_word_alignment(mesh, params)
    check_budget(params.fanout, params.capacity, SH.member_mesh_size(mesh), a2a_budget)
    return SH._sharded_tick


def _mesh_scope(mesh, params, a2a_budget):
    if mesh is None:
        return contextlib.nullcontext()
    from ..ops.sharding import ragged_delivery_context

    return ragged_delivery_context(mesh, params.capacity, a2a_budget)


def profile_ticks(params, state, draws, n_ticks: int, warmup_ticks: int = 1, mesh=None,
                  a2a_budget=None) -> Tuple[object, Dict]:
    """Run ``warmup_ticks + n_ticks`` ticks phase by phase; returns
    ``(state, result)``. ``draws`` is a ``torch.Generator`` on the state's
    device (advanced as a window advances it) or a sequence of
    ``warmup_ticks + n_ticks`` per-tick ``(fd, round)`` pairs. The state
    equals the window's over the same draws; the warm-up ticks are left out
    of the phase totals and the wall time. Consumes ``state``. With
    ``mesh`` (and, for pview, ``a2a_budget``) ``state`` is this rank's
    shard and the ticks are the engine's sharded window's
    (:mod:`..ops.sharding`)."""
    engine, tick, draw = _engine_of(params)
    if mesh is not None:
        tick = _mesh_checks(mesh, params, a2a_budget)

    def step(st, fd, rd, timer):
        return tick(st, fd, rd, params, timer=timer)[0]

    with _mesh_scope(mesh, params, a2a_budget):
        state, timer, wall = _run(step, draw, params, state, draws, n_ticks, warmup_ticks, state.device)
        result = _result(engine, params.capacity, n_ticks, warmup_ticks, wall, timer, mesh=mesh)
    return state, result


def profile_fleet_ticks(params, fleet_state, draws, n_ticks: int, warmup_ticks: int = 1, mesh=None,
                        a2a_budget=None) -> Tuple[object, Dict]:
    """Phase-split profile of a FLEET window (:mod:`..ops.fleet`): each
    fleet tick is the serial tick under ``vmap``, its phases timed once per
    fleet tick. ``draws`` is a generator on the fleet's device or a
    sequence of per-tick pairs with [S, ...] leaves. Same result schema as
    :func:`profile_ticks` plus the scenario count ``s``; the engine name is
    suffixed ``-fleet``. With ``mesh`` (a 2-D scenarios x members mesh)
    ``fleet_state`` is this rank's block and the fleet tick is the sharded
    fleet window's (:func:`..ops.sharding.make_sharded_pview_fleet_run`);
    ``draws`` is then ``fleet.fleet_draws(gen, mesh, S)`` or a sequence of
    this rank's scenarios' full draws. Returns ``(fleet_state, result)``."""
    from ..ops.engine_api import plane_view_rows
    from ..ops.fleet import fleet_size, fleet_tick
    from ..ops.pview import view_rows as pview_rows

    engine, tick, draw = _engine_of(params)
    if mesh is not None:
        tick = _mesh_checks(mesh, params, a2a_budget, fleet=True)
    s = fleet_size(fleet_state)
    rows_fn = pview_rows if engine == "pview" else plane_view_rows

    def step(fs, fd, rd, timer):
        return fleet_tick(functools.partial(tick, timer=timer), fs, fd, rd, params, None, rows_fn, None)[0]

    with _mesh_scope(mesh, params, a2a_budget):
        fleet_state, timer, wall = _run(step, draw, params, fleet_state, draws, n_ticks, warmup_ticks,
                                        fleet_state.up.device, lead={"lead": (s,)})
        result = _result(f"{engine}-fleet", params.capacity, n_ticks, warmup_ticks, wall, timer, mesh=mesh, s=s)
    return fleet_state, result


def profile_driver(driver, n_ticks: int = 32, warmup_ticks: int = 1) -> Dict:
    """Profile one driver's window WITHOUT touching its live state: the
    state and the generator are copied and the phase-split run happens on
    the copies. Returns the result dict. A driver fed by a caller's draw
    source is refused (that source's position is not the driver's to
    copy). On a sharded driver each rank copies its shard (the copy is the
    live state re-sharded, without the gather) and the profile runs the
    sharded ticks on the driver's mesh."""
    import dataclasses

    if driver._draws is not None:
        raise ValueError("profile_driver needs the driver's own generator, not a caller-supplied draws source")
    with driver._lock:
        st = driver.state
        state = st.replace(**{
            f.name: getattr(st, f.name).clone()
            for f in dataclasses.fields(st) if isinstance(getattr(st, f.name), torch.Tensor)
        })
        gen = torch.Generator(device=driver.device)
        gen.set_state(driver._gen.get_state())
        params = driver.params
    _st, result = profile_ticks(params, state, gen, n_ticks, warmup_ticks=warmup_ticks, mesh=driver.mesh)
    return result
