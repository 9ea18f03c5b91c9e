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
        full = convert.state_to_numpy(SH.gather_pview_state(st, mesh))
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


def sharded_driver(params, n: int, armed: str, seed: int = 3) -> dict:
    """The driver script on the group's member mesh with the telemetry plane
    and ``armed`` ("adaptive" or "trace") armed."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    d = SimDriver(params, n - 8, seed=seed, mesh=dcn.global_mesh("cpu"), device="cpu")
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
    """Every part of the mesh still to port, tried on this rank: the
    exception's type and message by name."""
    import dataclasses

    from scalecube_cluster_tpu_torch.chaos import Scenario
    from scalecube_cluster_tpu_torch.dissemination.spec import DissemSpec
    from scalecube_cluster_tpu_torch.ops import fleet as FL
    from scalecube_cluster_tpu_torch.ops import sparse as SP
    from scalecube_cluster_tpu_torch.ops import state as ST
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.trace import profile as PR
    from torch.distributed.device_mesh import init_device_mesh

    mesh = dcn.global_mesh("cpu")
    p = TPV.PviewParams(capacity=256, seed_rows=(0, 1))
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = ("none", "")
        except Exception as exc:  # noqa: BLE001 - the refusal is the result
            out[name] = (type(exc).__name__, str(exc))

    attempt("misaligned capacity", lambda: SH.make_sharded_pview_run(mesh, TPV.PviewParams(capacity=96), 1))
    attempt("delay_slots", lambda: SH.make_sharded_pview_run(mesh, dataclasses.replace(p, delay_slots=4), 1))
    attempt("pull leg", lambda: SH.make_sharded_pview_run(
        mesh, dataclasses.replace(p, dissem=DissemSpec(strategy="push_pull")), 1))
    mesh2d = init_device_mesh("cpu", (1, dcn.process_info()[1]), mesh_dim_names=("scenarios", SH.MEMBER_AXIS))
    attempt("2-D mesh driver", lambda: SimDriver(p, 200, mesh=mesh2d, device="cpu"))
    attempt("2-D mesh window", lambda: SH.make_sharded_pview_run(mesh2d, p, 1))
    attempt("mesh2d", lambda: SH.make_pview_mesh2d(1))
    attempt("shard_pview_fleet", lambda: SH.shard_pview_fleet(None, mesh2d))
    attempt("fleet run", lambda: SH.make_sharded_pview_fleet_run(mesh2d, p, 1))
    d = SimDriver(p, 200, mesh=mesh, device="cpu")
    attempt("control", d.arm_control)
    attempt("profile", lambda: PR.profile_driver(d))
    attempt("profile ticks", lambda: PR.profile_ticks(p, d.state, torch.Generator(), 1, mesh=mesh))
    attempt("run_scenario", lambda: d.run_scenario(Scenario(name="idle", events=(), horizon=4)))
    attempt("checkpoint", lambda: d.checkpoint("unused.npz"))
    attempt("restore", lambda: d.restore("unused.npz"))
    attempt("sparse driver", lambda: SimDriver(SP.SparseParams(capacity=64), 64, mesh=mesh, device="cpu"))
    attempt("dense driver", lambda: SimDriver(ST.SimParams(capacity=64), 64, mesh=mesh, device="cpu"))
    attempt("sparse window", lambda: SH.make_sharded_sparse_run(mesh, SP.SparseParams(capacity=64), 1))
    attempt("dense window", lambda: SH.make_sharded_run(mesh, ST.SimParams(capacity=64), 1))
    attempt("dense state", lambda: dcn.make_global_state(ST.SimParams(capacity=64), 64, mesh))
    attempt("fleet of 3", lambda: FL.shard_fleet(torch.zeros(3), FL.fleet_mesh("cpu")))
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
