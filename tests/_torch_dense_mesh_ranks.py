"""Rank-side functions of the dense member-mesh tests
(``tests/test_torch_dense_mesh.py``; the engine-generic ones serve
``tests/test_torch_sparse_mesh.py`` too): each runs on every rank of a
:class:`scalecube_cluster_tpu_torch.ops.dcn.LocalWorld` (gloo, one thread
per rank) and returns plain numpy, whole and identical on every rank. This
module imports no JAX: the ranks never load it."""

from __future__ import annotations

import torch

from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import sharding as SH
from scalecube_cluster_tpu_torch.ops import state as ST


def _whole(st, mesh) -> dict:
    # copies: the next window writes the planes and rings in place
    return {k: v.copy() for k, v in convert.state_to_numpy(SH.gather_state(st, mesh)).items()}


def window(params, state_np: dict, draws, n_ticks: int, watch_rows=None, mutate=None, cells=None) -> dict:
    """Shard ``state_np`` over the group's member mesh and run one sharded
    window of ``n_ticks`` per entry of ``draws`` (per-window lists of the
    per-tick full draws), applying ``mutate`` (``{window: [(op name,
    args)]}``, :mod:`scalecube_cluster_tpu_torch.ops.state`) to the
    gathered state before it; ``cells`` sets the row chunks' size
    (``_tensor.PLANE_CHUNK_CELLS``) for the call. The whole state, the
    stacked metrics and the watched rows after each window."""
    from scalecube_cluster_tpu_torch.ops import _tensor

    keep = _tensor.PLANE_CHUNK_CELLS
    _tensor.PLANE_CHUNK_CELLS = cells or keep
    try:
        return _window(params, state_np, draws, n_ticks, watch_rows, mutate)
    finally:
        _tensor.PLANE_CHUNK_CELLS = keep


def _window(params, state_np, draws, n_ticks, watch_rows, mutate) -> dict:
    mesh = dcn.global_mesh("cpu")
    st = SH.shard_state(convert.state_from_numpy(state_np, device="cpu"), mesh)
    run = SH.make_sharded_run(mesh, params, n_ticks)
    watch = None if watch_rows is None else torch.tensor(watch_rows)
    out = []
    for w, dr in enumerate(draws):
        if mutate and w in mutate:
            full = SH.gather_state(st, mesh)
            for name, args in mutate[w]:
                full = getattr(ST, name)(full, *args)
            st = SH.shard_state(full, mesh)
        st, ms, watched = run(st, dr, watch)
        out.append({"state": _whole(st, mesh), "metrics": {k: v.numpy() for k, v in ms.items()},
                    "watched": None if watched is None else watched.numpy()})
    return {"windows": out, "capacity": st.capacity, "rows": tuple(st.view_key.shape)}


def ticks(params, state_np: dict, draws) -> dict:
    """The sharded tick (``make_sharded_tick``) stepped once per draw pair:
    the whole state and the metrics after each step."""
    mesh = dcn.global_mesh("cpu")
    st = SH.shard_state(convert.state_from_numpy(state_np, device="cpu"), mesh)
    step = SH.make_sharded_tick(mesh, params)
    out = []
    for fd, rd in draws:
        st, ms = step(st, fd, rd)
        out.append({"state": _whole(st, mesh), "metrics": {k: v.numpy() for k, v in ms.items()}})
    return {"ticks": out, "rows": tuple(st.view_key.shape)}


def global_state_run(params, n_initial: int, seed: int, n_ticks: int) -> dict:
    """JAX's DCN script in torch: ``make_global_state``, then
    ``make_sharded_run`` for ``n_ticks`` from a generator seeded ``seed``."""
    mesh = dcn.global_mesh("cpu")
    st = dcn.make_global_state(params, n_initial, mesh)
    rows = tuple(st.view_key.shape)
    st, ms, _ = SH.make_sharded_run(mesh, params, n_ticks)(st, torch.Generator().manual_seed(seed))
    return {"state": _whole(st, mesh), "metrics": {k: v.numpy() for k, v in ms.items()}, "rows": rows}


def alignment(cases) -> dict:
    """The mesh preconditions: for each ``(label, params)`` of ``cases``,
    what the sharded window and tick raise (type and message; "none" where
    they build)."""
    mesh = dcn.global_mesh("cpu")
    out = {}
    for label, params in cases:
        for what, fn in (("run", lambda p=params: SH.make_sharded_run(mesh, p, 1)),
                         ("tick", lambda p=params: SH.make_sharded_tick(mesh, p))):
            try:
                fn()
                out[(label, what)] = ("none", "")
            except Exception as exc:  # noqa: BLE001 - the refusal is the result
                out[(label, what)] = (type(exc).__name__, str(exc))
    return out


def profile_window(params, state_np: dict, seed: int, n_ticks: int, warmup: int) -> dict:
    """``profile_ticks(mesh=)`` on the dense or sparse engine (by
    ``params``) against its sharded window over the same generator: both
    whole final states and the result's phase names."""
    from scalecube_cluster_tpu_torch.ops import engine_api
    from scalecube_cluster_tpu_torch.trace import profile as PR

    eng = engine_api.resolve(params)
    mesh = dcn.global_mesh("cpu")
    start = convert.state_from_numpy(state_np, device="cpu")
    st, res = PR.profile_ticks(params, eng.shard_state(start, mesh), torch.Generator().manual_seed(seed), n_ticks,
                               warmup_ticks=warmup, mesh=mesh)
    start = convert.state_from_numpy(state_np, device="cpu")
    ref, _, _ = eng.make_sharded_run(mesh, params, warmup + n_ticks)(eng.shard_state(start, mesh),
                                                                      torch.Generator().manual_seed(seed))

    def whole(s):
        return {k: v.copy() for k, v in convert.state_to_numpy(eng.gather_state(s, mesh)).items()}

    return {"profiled": whole(st), "window": whole(ref), "phases": sorted(res["phases_s"]),
            "mesh": res["mesh"], "engine": res["engine"], "ticks": res["ticks"]}


def scenario_report(params, n: int, seed: int, scenario, sharded: bool = True, **kw) -> dict:
    """``run_scenario`` on a (sharded) driver with the telemetry plane
    armed (``kw`` goes to the driver): the report without its host stamp,
    the ring, the whole final state."""
    from scalecube_cluster_tpu_torch.config import TelemetryConfig
    from scalecube_cluster_tpu_torch.sim import SimDriver

    d = SimDriver(params, n, seed=seed, mesh=dcn.global_mesh("cpu") if sharded else None, device="cpu", **kw)
    d.arm_telemetry(TelemetryConfig(ring_len=8))
    rep = d.run_scenario(scenario, max_window=6)
    rep.pop("host_cpus", None)
    ring = d.telemetry.collect()["ring"]
    whole = d._eng.gather_state(d.state, d.mesh) if d.mesh is not None else d.state
    return {"report": rep, "ring": ring["rows"], "names": ring["names"], "windows": ring["windows"],
            "state": convert.state_to_numpy(whole)}
