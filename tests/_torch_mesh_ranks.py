"""Rank-side functions of the member-mesh tests (``tests/test_torch_*``):
each runs on every rank of a :class:`scalecube_cluster_tpu_torch.ops.dcn.
LocalWorld` (gloo, one thread per rank) and returns plain numpy, whole and
identical on every rank. This module imports no JAX: the ranks never load
it."""

from __future__ import annotations

import numpy as np
import torch

from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.adaptive import init_adaptive_state
from scalecube_cluster_tpu_torch.ops import dcn, delivery
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sharding as SH

#: the traced windows' tracer rows: both sides of the 2-rank boundary at 256
TRACERS = (0, 1, 127, 128)


def _np(ms):
    return {k: v.numpy() for k, v in ms.items()}


def window(kind: str, params, state_np: dict, draws, n_ticks: int, budget=None, watch_rows=None,
           windows: int = 1, mutate=None):
    """Shard ``state_np`` over the group's member mesh and run ``windows``
    sharded windows of ``n_ticks`` (``kind``: run, fused, adaptive, traced;
    ``draws``: per-window lists of per-tick draws), applying ``mutate``
    (``(window, [(op name, args)])``) to the gathered state between them.
    Returns the whole state after each window, the stacked metrics, the
    watched rows, the adaptive planes, the trace ring and the delivery
    kernel's launches."""
    mesh = dcn.global_mesh("cpu")
    st = SH.shard_pview_state(convert.state_from_numpy(state_np, device="cpu"), mesh)
    ad = ring = None
    if kind == "adaptive":
        ad = SH.shard_adaptive_state(init_adaptive_state(params.capacity, device="cpu"), mesh)
        run = SH.make_sharded_pview_adaptive_run(mesh, params, n_ticks, a2a_budget=budget)
    elif kind == "traced":
        from scalecube_cluster_tpu_torch.trace.rings import TraceRing
        from scalecube_cluster_tpu_torch.trace.schema import TraceSpec

        spec = TraceSpec(tracer_rows=TRACERS, rumor_slots=(0, 1), ring_len=256, ping_req_k=params.ping_req_k)
        ring = TraceRing(spec, device="cpu")
        run = SH.make_sharded_pview_traced_run(mesh, params, n_ticks, spec, a2a_budget=budget)
    else:
        make = SH.make_sharded_pview_run if kind == "run" else SH.make_sharded_pview_fused_run
        run = make(mesh, params, n_ticks, a2a_budget=budget)
    watch = None if watch_rows is None else torch.tensor(watch_rows)
    delivery.delivery_combine.launches = 0
    out = []
    for w, dr in enumerate(draws):
        if mutate and w in mutate:
            full = SH.gather_pview_state(st, mesh)
            for name, args in mutate[w]:
                full = getattr(TPV, name)(full, *args)
            st = SH.shard_pview_state(full, mesh)
        if kind == "adaptive":
            st, ad, ms, watched = run(st, ad, dr, watch)
        elif kind == "traced":
            st, ms, watched = run(st, ring, dr, watch)
        else:
            st, ms, watched = run(st, dr, watch)
        # copies: the next window writes the rings and pools in place
        full = {k: v.copy() for k, v in convert.state_to_numpy(SH.gather_pview_state(st, mesh)).items()}
        rec = {"state": full, "metrics": _np(ms), "watched": None if watched is None else watched.numpy()}
        if ad is not None:
            group = mesh.get_group(SH.MEMBER_AXIS)
            rec["ad"] = {k: SH.gather_rows(getattr(ad, k), group).numpy() for k in ("lh", "conf_key", "conf")}
        if ring is not None:
            rec["ring"] = ring.buf.clone().numpy()
        out.append(rec)
    return {"windows": out, "launches": delivery.delivery_combine.launches}


def driver_script(d, n: int) -> None:
    """A driver script whose mutations sit on the rank boundaries of a
    2- and a 4-rank mesh: rumors, a crash wave, a join, a leave, a
    metadata bump, a partition and its heal, watched rows."""
    for row in (0, n // 2):
        d.watch(row)
    d.spread_rumor(n // 2 - 1, "a")
    d.spread_rumor(n // 2, "b")
    d.step(4)
    d.crash(n // 2 - 1)
    d.crash(n // 4)
    d.step(5)
    d.join((0, 1))
    d.leave(n // 2 + 1)
    d.update_metadata(3 * n // 4)
    d.step(6)
    a, b = list(range(0, n // 2)), list(range(n // 2, n))
    d.block_partition(a, b)
    d.step(4)
    d.heal_partition(a, b)
    d.step(5)


def driver_record(d, n: int) -> dict:
    """What the sharded and the unsharded driver must agree on."""
    from scalecube_cluster_tpu_torch.sim.driver import SimDriver  # noqa: F401

    whole = d._eng.gather_state(d.state, d.mesh) if d.mesh is not None else d.state
    rec = {
        "state": convert.state_to_numpy(whole),
        "events": {row: [(e.type.value, e.member.id) for e in d.events_of(row)] for row in (0, n // 2)},
        "views": {row: [v.tolist() for v in d.view_of(row)] for row in (0, n // 2, n - 1)},
        "status": str(d.status_of(0, n // 2 - 1)),
        "is_up": [d.is_up(r) for r in (n // 4, n // 2 - 1, n - 1)],
        "coverage": [d.rumor_coverage(s) for s in (0, 1)],
        "readbacks": d.dispatch_stats["readbacks"],
        "health": {k: v for k, v in d.health_snapshot().items() if k in ("n_up", "announce", "staleness", "pool")},
    }
    if d.adaptive_state is not None:
        ad = d.adaptive_state
        rec["ad"] = {k: d._whole(getattr(ad, k)).numpy() for k in ("lh", "conf_key", "conf")}
    if d.telemetry is not None:
        ring = d.telemetry.collect()["ring"]
        names = ring["names"]
        keep = [i for i, k in enumerate(names) if k != "shard_peak_mem_mb"]
        rec["telemetry"] = [[row[i] for i in keep] for row in ring["rows"]]
        rec["readbacks"] = d.dispatch_stats["readbacks"]
    if d.trace is not None:
        rec["trace"] = d.trace.ring.buf.numpy().copy()
    return rec


def sharded_driver(params, n: int, armed: str, seed: int = 3, **kw) -> dict:
    """The driver script on the group's member mesh with the telemetry plane
    and ``armed`` ("adaptive" or "trace") armed; ``kw`` goes to the
    driver."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    d = SimDriver(params, n - 8, seed=seed, mesh=dcn.global_mesh("cpu"), device="cpu", **kw)
    d.arm_telemetry()
    if armed == "trace":
        d.arm_trace(tracer_rows=(0, n // 2 - 1, n // 2, n - 1), rumor_slots=(0, 1))
    delivery.delivery_combine.launches = 0
    driver_script(d, n)
    rec = driver_record(d, n)
    rec["launches"] = delivery.delivery_combine.launches
    return rec


_FLEET_MESH = []


def fleet_window(params, fleet_np: dict, seed: int, n_ticks: int) -> dict:
    """The fleet window on the group's scenario mesh: each rank its S / W
    scenarios, the draws the one-process fleet's; returns the whole fleet,
    the metrics and the first-full-coverage fold, gathered, and the count
    of covered scenarios summed over the ranks."""
    from scalecube_cluster_tpu_torch.ops import fleet as FL

    if not _FLEET_MESH:
        _FLEET_MESH.append(FL.fleet_mesh("cpu"))
    mesh = _FLEET_MESH[0]
    fs = convert.fleet_from_numpy(fleet_np, device="cpu")
    s = FL.fleet_size(fs)
    mine = FL.shard_fleet(fs, mesh)
    gen = FL.fleet_generator(seed, device="cpu")
    delivery.delivery_combine_fleet.launches = 0
    mine, ms, _ = FL.make_fleet_run(params, n_ticks)(mine, FL.fleet_draws(gen, mesh, s))
    hit = FL.fold_first_full_coverage(torch.full((FL.fleet_size(mine),), -1, dtype=torch.int32),
                                      ms["rumor_coverage"][:, :, 0], 0)
    covered = FL.fleet_fold_sum((hit >= 0).sum().to(torch.int32), mesh)
    whole = mine.replace(**{k: FL.fleet_gather(getattr(mine, k), mesh) for k in FL._leaf_names(mine)})
    return {"fleet": convert.fleet_to_numpy(whole), "metrics": {k: FL.fleet_gather(v, mesh).numpy()
                                                                 for k, v in ms.items()},
            "hit": FL.fleet_gather(hit, mesh).numpy(), "covered": int(covered), "rows": FL.fleet_size(mine),
            "launches": delivery.delivery_combine_fleet.launches}


def refusals() -> dict:
    """What a mesh still refuses, tried on this rank: the exception's type
    and message by name ("none" where the call went through). The dense
    and sparse engines run there, without the trace plane or an adaptive
    ladder (JAX refuses both); the compile cache, the audit, the sim
    transport and the emulator runner run on a sharded driver; a 2-D mesh
    runs only the fleet."""
    from scalecube_cluster_tpu_torch.chaos.engine import EmulatorChaosRunner
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import sparse as SP
    from scalecube_cluster_tpu_torch.ops import state as ST
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.sim.cluster import SimNode
    from scalecube_cluster_tpu_torch.trace import profile as PR

    mesh = dcn.global_mesh("cpu")
    world = dcn.process_info()[1]
    p = TPV.PviewParams(capacity=256, seed_rows=(0, 1))
    sp = SP.SparseParams(capacity=64)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = ("none", "")
        except Exception as exc:  # noqa: BLE001 - the refusal is the result
            out[name] = (type(exc).__name__, str(exc))

    attempt("misaligned capacity", lambda: SH.make_sharded_pview_run(mesh, TPV.PviewParams(capacity=96), 1))
    mesh2d = SH.make_pview_mesh2d(1, "cpu")
    attempt("2-D mesh driver", lambda: SimDriver(p, 200, mesh=mesh2d, device="cpu"))
    attempt("2-D mesh window", lambda: SH.make_sharded_pview_run(mesh2d, p, 1))
    attempt("sparse driver", lambda: SimDriver(sp, 64, mesh=mesh, device="cpu"))
    attempt("dense driver", lambda: SimDriver(ST.SimParams(capacity=64), 64, mesh=mesh, device="cpu"))
    attempt("sparse window", lambda: SH.make_sharded_sparse_run(mesh, sp, 1))
    attempt("sparse tick", lambda: SH.make_sharded_sparse_tick(mesh, sp))
    attempt("sparse state", lambda: SH.shard_sparse_state(SP.init_sparse_state(sp, 64, device="cpu"), mesh))
    attempt("dense window", lambda: SH.make_sharded_run(mesh, ST.SimParams(capacity=64), 1))
    attempt("dense tick", lambda: SH.make_sharded_tick(mesh, ST.SimParams(capacity=64)))
    attempt("dense state", lambda: dcn.make_global_state(ST.SimParams(capacity=64), 64, mesh))
    dense = SimDriver(ST.SimParams(capacity=64), 48, mesh=mesh, device="cpu")
    attempt("dense trace capture", dense.arm_trace)
    attempt("dense adaptive ladder", dense.arm_control)
    sparse = SimDriver(sp, 48, mesh=mesh, device="cpu")
    attempt("sparse trace capture", sparse.arm_trace)
    attempt("sparse adaptive ladder", sparse.arm_control)
    attempt("sparse profile", lambda: PR.profile_ticks(sp, SH.shard_sparse_state(
        SP.init_sparse_state(sp, 64, device="cpu"), mesh), torch.Generator(), 1, mesh=mesh))
    import tempfile

    from scalecube_cluster_tpu_torch import compile_cache
    from scalecube_cluster_tpu_torch.chaos.events import Scenario
    from scalecube_cluster_tpu_torch.ops import _build

    keep = _build.BUILD_DIR, compile_cache._enabled_dir
    with tempfile.TemporaryDirectory() as tmp:
        attempt("compile cache", lambda: SimDriver(p, 200, mesh=mesh, device="cpu", compile_cache_dir=tmp))
    _build.BUILD_DIR, compile_cache._enabled_dir = keep
    d = SimDriver(p, 200, mesh=mesh, device="cpu")
    attempt("cache audit", d.jit_cache_audit)
    attempt("sim transport", lambda: SimNode(d, 0).transport())
    attempt("emulator chaos", lambda: EmulatorChaosRunner(Scenario(name="idle", events=(), horizon=4), [], []))
    attempt("fleet of 3", lambda: FL.shard_fleet(torch.zeros(3), FL.fleet_mesh("cpu")))
    attempt("2-D factoring", lambda: SH.make_pview_mesh2d(world + 1, "cpu"))
    attempt("2-D fleet on a 1-D mesh", lambda: SH.make_sharded_pview_fleet_run(mesh, p, 1))
    return out


def dcn_info(params, n_initial: int) -> dict:
    """The group as this rank sees it, its shard of the global initial
    state, and the collectives on the dtypes the wire lacks."""
    from scalecube_cluster_tpu_torch.ops import ragged_a2a as RA

    mesh = dcn.global_mesh("cpu")
    rank, world = dcn.process_info()
    st = dcn.make_global_pview_state(params, n_initial, mesh)
    group = mesh.get_group(SH.MEMBER_AXIS)
    i16 = (torch.arange(6, dtype=torch.int16).reshape(3, 2) - 3) * (rank + 1)
    flags = torch.tensor([rank == 0, False, True])
    rng = np.random.default_rng(5)
    n, F, Wm, R = params.capacity, 2, 2, 4
    payload = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(n, Wm + 1 + R), dtype=np.int64)
                               .astype(np.int32))
    p_all = torch.from_numpy(rng.integers(0, n, size=(F, n)).astype(np.int32))
    ok = torch.from_numpy(rng.random((F, n)) < 0.7)
    origin = torch.from_numpy(rng.integers(-1, n, size=(R,)).astype(np.int32))
    lo, hi = SH._rank_rows(mesh, n)
    out = RA.ragged_delivery_combine(payload[lo:hi], p_all[:, lo:hi], ok[:, lo:hi], origin, Wm, R, mesh=mesh,
                                     capacity=n, budget=3)
    # a state with delay rings ([D, N, ...], split on dim 1) shards and
    # gathers back whole
    import dataclasses

    ringed = TPV.init_pview_state(dataclasses.replace(params, delay_slots=2), n_initial, device="cpu",
                                  uniform_delay=1.0)
    ringed.pending_src[1, :, 0] = torch.arange(params.capacity, dtype=torch.int32)
    back = convert.state_to_numpy(SH.gather_pview_state(SH.shard_pview_state(ringed, mesh), mesh))
    whole = convert.state_to_numpy(ringed)
    return {
        "rings_round_trip": all(np.array_equal(back[k], v) for k, v in whole.items()),
        "ring_shard": tuple(SH.shard_pview_state(ringed, mesh).pending_src.shape),
        "rank": rank, "world": world, "names": tuple(mesh.mesh_dim_names), "size": SH.member_mesh_size(mesh),
        "rows": (lo, hi), "shard": convert.state_to_numpy(st), "device": str(SH.mesh_device(mesh)),
        "gathered_i16": SH.gather_rows(i16, group).numpy(),
        "any_all": (SH.all_reduce(flags, "max", group).tolist(), SH.all_reduce(flags, "min", group).tolist()),
        "combine": [x.numpy() for x in out[:3]], "cnt": int(out[3]), "overflow": int(out[4]),
    }


# ---------------------------------------------------------------------------
# the 2-D scenarios x members mesh
# ---------------------------------------------------------------------------


def _fleet_rows_of(draws, lo: int, hi: int) -> list:
    import dataclasses

    return [tuple(None if b is None else type(b)(*(getattr(b, f.name)[lo:hi] for f in dataclasses.fields(b)))
                  for b in d) for d in draws]


def fleet2d(params, fleet_np: dict, draws, n_rows: int, n_ticks: int) -> dict:
    """The fleet window on a 2-D ``n_rows`` x (W / n_rows) mesh: each rank
    its scenarios' member rows and their draws (the one-process fleet's);
    returns the whole fleet and metrics, gathered, and the kernels'
    launches."""
    from scalecube_cluster_tpu_torch.ops import fleet as FL

    mesh = SH.make_pview_mesh2d(n_rows, "cpu")
    fs = convert.fleet_from_numpy(fleet_np, device="cpu")
    s = FL.fleet_size(fs)
    lo, hi = FL._fleet_rows(mesh, s)
    delivery.delivery_combine.launches = delivery.delivery_combine_fleet.launches = 0
    mine, ms, _ = SH.make_sharded_pview_fleet_run(mesh, params, n_ticks)(SH.shard_pview_fleet(fs, mesh),
                                                                         _fleet_rows_of(draws, lo, hi))
    return {"fleet": convert.fleet_to_numpy(SH.gather_pview_fleet(mine, mesh)),
            "metrics": {k: FL.fleet_gather(v, mesh).numpy() for k, v in ms.items()},
            "rows": (lo, hi), "block": tuple(mine.nbr_id.shape),
            "launches": delivery.delivery_combine.launches + delivery.delivery_combine_fleet.launches}


def collectives(params, state_np: dict, draws, fleet_np: dict, fleet_draws, n_rows: int, n_ticks: int) -> dict:
    """The collectives (``all_gather``, ``all_reduce``, ``all_to_all_single``)
    of a serial sharded window on the 1-D mesh and of a fleet window of S
    scenarios on the 2-D mesh with the same member split, by kind."""
    import torch.distributed as dist

    from scalecube_cluster_tpu_torch.ops import fleet as FL

    kinds = ("all_gather", "all_reduce", "all_to_all_single")
    count = dict.fromkeys(kinds, 0)
    real = {k: getattr(dist, k) for k in kinds}

    def counted(k):
        def call(*a, **kw):
            count[k] += 1
            return real[k](*a, **kw)
        return call

    out = {}
    mesh, mesh2d = dcn.global_mesh("cpu"), SH.make_pview_mesh2d(n_rows, "cpu")
    st = SH.shard_pview_state(convert.state_from_numpy(state_np, device="cpu"), mesh)
    fs = convert.fleet_from_numpy(fleet_np, device="cpu")
    lo, hi = FL._fleet_rows(mesh2d, FL.fleet_size(fs))
    mine = SH.shard_pview_fleet(fs, mesh2d)
    try:
        for k in kinds:
            setattr(dist, k, counted(k))
        SH.make_sharded_pview_fused_run(mesh, params, n_ticks)(st, draws)
        out["serial"], count = dict(count), dict.fromkeys(kinds, 0)
        SH.make_sharded_pview_fleet_run(mesh2d, params, n_ticks)(mine, _fleet_rows_of(fleet_draws, lo, hi))
        out["fleet"] = dict(count)
    finally:
        for k in kinds:
            setattr(dist, k, real[k])
    out["scenarios"] = hi - lo
    return out


def mesh2d_refusals() -> dict:
    """The 2-D mesh's two refusals (JAX's): a world that does not factor
    into the scenario rows, and a fleet window on a 1-D mesh."""
    out = {}
    for name, fn in (("factor", lambda: SH.make_pview_mesh2d(3, "cpu")),
                     ("2-D", lambda: SH.make_sharded_pview_fleet_run(dcn.global_mesh("cpu"),
                                                                     TPV.PviewParams(capacity=256), 2))):
        try:
            fn()
            out[name] = ("none", "")
        except Exception as exc:  # noqa: BLE001 - the refusal is the result
            out[name] = (type(exc).__name__, str(exc))
    return out


# ---------------------------------------------------------------------------
# the driver's planes on a member mesh
# ---------------------------------------------------------------------------


class ListDraws:
    """A driver's ``draws=`` source over precomputed per-tick draws (a key
    chain's, which windowing does not change)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, n_ticks: int):
        out, self.draws = self.draws[:n_ticks], self.draws[n_ticks:]
        return out


def _driver(params, n: int, seed: int, sharded: bool, draws=None, **kw):
    from scalecube_cluster_tpu_torch.sim import SimDriver

    return SimDriver(params, n, seed=seed, mesh=dcn.global_mesh("cpu") if sharded else None, device="cpu",
                     draws=None if draws is None else ListDraws(draws), **kw)


def _whole_np(d) -> dict:
    whole = d._eng.gather_state(d.state, d.mesh) if d.mesh is not None else d.state
    return convert.state_to_numpy(whole)


def scenario_run(params, n: int, seed: int, scenario, draws=None, sharded: bool = True) -> dict:
    """``run_scenario`` on a (sharded) driver; the report without its host
    stamp, the whole final state and the member identities."""
    d = _driver(params, n, seed, sharded, draws)
    rep = d.run_scenario(scenario)
    rep.pop("host_cpus", None)
    return {"report": rep, "state": _whole_np(d), "members": {r: m.id for r, m in d.members.items()},
            "readbacks": d.dispatch_stats["readbacks"]}


def control_run(params, n: int, seed: int, spec, windows: int, per: int, loss: float = 0.0,
                armed: bool = True, sharded: bool = True) -> dict:
    """A (sharded) driver with the telemetry plane and (``armed``) the
    control plane, a uniform loss floor, ``windows`` steps of ``per``
    ticks: the state, the params, the controller's log and rung, the
    readbacks."""
    from scalecube_cluster_tpu_torch.config import TelemetryConfig

    d = _driver(params, n, seed, sharded)
    d.arm_telemetry(TelemetryConfig(ring_len=8))
    plane = d.arm_control(spec=spec) if armed else None
    if loss:
        d._apply(lambda st: TPV.set_uniform_loss(st, loss, floor=True))
    history = []
    for _ in range(windows):
        d.step(per)
        history.append(d.control_snapshot().get("rung") if armed else None)
    rec = {"state": _whole_np(d), "params": repr(d.params), "readbacks": d.dispatch_stats["readbacks"],
           "history": history}
    if plane is not None:
        snap = d.control_snapshot()
        rec.update(log=snap["decision_log"], rung=plane.state.rung, actuations=plane.state.actuations)
    if d.adaptive_state is not None:
        rec["ad"] = {k: d._whole(getattr(d.adaptive_state, k)).numpy() for k in ("lh", "conf_key", "conf")}
    return rec


def profile_window(params, state_np: dict, seed: int, n_ticks: int, warmup: int) -> dict:
    """``profile_ticks`` on the member mesh against the sharded fused window
    over the same generator: both whole final states and the result."""
    from scalecube_cluster_tpu_torch.trace import profile as PR

    mesh = dcn.global_mesh("cpu")
    start = convert.state_from_numpy(state_np, device="cpu")
    st, res = PR.profile_ticks(params, SH.shard_pview_state(start, mesh), torch.Generator().manual_seed(seed),
                               n_ticks, warmup_ticks=warmup, mesh=mesh)
    ref, _, _ = SH.make_sharded_pview_fused_run(mesh, params, warmup + n_ticks)(
        SH.shard_pview_state(start, mesh), torch.Generator().manual_seed(seed))
    res.pop("timeline")
    return {"profiled": convert.state_to_numpy(SH.gather_pview_state(st, mesh)),
            "window": convert.state_to_numpy(SH.gather_pview_state(ref, mesh)), "result": res}


def profile_driver_run(params, n: int, seed: int, before: int, after: int) -> dict:
    """``profile_driver`` between two steps of a sharded driver: the result
    and the whole final state (the profile must not move the driver)."""
    from scalecube_cluster_tpu_torch.trace import profile as PR

    d = _driver(params, n, seed, True)
    d.step(before)
    res = PR.profile_driver(d, n_ticks=2, warmup_ticks=1)
    d.step(after)
    res.pop("timeline")
    return {"result": res, "state": _whole_np(d)}


def checkpoint_run(params, n: int, seed: int, path: str, foreign: str, steps: int) -> dict:
    """A sharded driver with telemetry: steps, a checkpoint to ``path``,
    more steps, the restore, the same steps again; then a restore of the
    unsharded driver's archive ``foreign`` and the same steps. The whole
    states after each, the counters' exposition at each point, the
    readbacks."""
    from scalecube_cluster_tpu_torch.config import TelemetryConfig

    d = _driver(params, n, seed, True)
    d.arm_telemetry(TelemetryConfig(ring_len=4))
    d.watch(3)
    d.step(steps)
    d.spread_rumor(params.capacity // 2 + 1, "x")
    d.step(steps)
    text = [d.telemetry.metrics_text()]
    d.checkpoint(path)
    d.step(steps)
    text.append(d.telemetry.metrics_text())
    ahead = _whole_np(d)
    d.restore(path)
    d.step(steps)
    text.append(d.telemetry.metrics_text())
    again = _whole_np(d)
    d.restore(foreign)
    d.step(steps)
    return {"ahead": ahead, "again": again, "foreign": _whole_np(d), "text": text,
            "events": [(e.type.value, e.member.id) for e in d.events_of(3)]}


def flight_run(params, n: int, seed: int, flight_dir: str, scenario) -> dict:
    """A sharded driver's flight dumps: one after a scenario (the
    reconstruction section stamped with the mesh) and, from a second
    driver with no runner armed, one that stays partial. Rank 0's paths."""
    from scalecube_cluster_tpu_torch.config import TelemetryConfig

    rank = dcn.process_info()[0]
    d = _driver(params, n, seed, True)
    d.arm_telemetry(TelemetryConfig(ring_len=8, flight_dir=flight_dir))
    d.run_scenario(scenario, max_window=8)
    armed = d.telemetry.flight_record("mesh-armed")
    p = _driver(params, n, seed + 1, True)
    p.arm_telemetry(TelemetryConfig(ring_len=8, flight_dir=flight_dir))
    p.step(4)
    return {"armed": armed, "partial": p.telemetry.flight_record("mesh-partial"), "params": repr(d.params)}


def profile_fleet2d(params, fleet_np: dict, seed: int, n_rows: int, n_ticks: int, warmup: int) -> dict:
    """``profile_fleet_ticks`` on a 2-D mesh against the sharded fleet window
    on the same fleet generator: both whole fleets and the result."""
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.trace import profile as PR

    mesh = SH.make_pview_mesh2d(n_rows, "cpu")
    fs = convert.fleet_from_numpy(fleet_np, device="cpu")
    s = FL.fleet_size(fs)
    got, res = PR.profile_fleet_ticks(params, SH.shard_pview_fleet(fs, mesh),
                                      FL.fleet_draws(FL.fleet_generator(seed, "cpu"), mesh, s), n_ticks,
                                      warmup_ticks=warmup, mesh=mesh)
    ref, _, _ = SH.make_sharded_pview_fleet_run(mesh, params, warmup + n_ticks)(
        SH.shard_pview_fleet(fs, mesh), FL.fleet_draws(FL.fleet_generator(seed, "cpu"), mesh, s))
    res.pop("timeline")
    return {"profiled": convert.fleet_to_numpy(SH.gather_pview_fleet(got, mesh)),
            "window": convert.fleet_to_numpy(SH.gather_pview_fleet(ref, mesh)), "result": res}


def exit_on_rank(rank_to_exit: int, code: int) -> int:
    """Rank ``rank_to_exit`` dies at once with exit code ``code``; every other
    rank waits for it in a barrier that never completes."""
    import os

    import torch.distributed as dist

    rank = dcn.process_info()[0]
    if rank == rank_to_exit:
        os._exit(code)
    dist.barrier()
    return rank
