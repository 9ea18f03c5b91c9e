"""Rank-side functions of the sparse member-mesh tests
(``tests/test_torch_sparse_mesh.py``): each runs on every rank of a
:class:`scalecube_cluster_tpu_torch.ops.dcn.LocalWorld` (gloo, one thread
per rank) and returns plain numpy, whole and identical on every rank. This
module imports no JAX: the ranks never load it."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import dcn, delivery
from scalecube_cluster_tpu_torch.ops import sharding as SH
from scalecube_cluster_tpu_torch.ops import sparse as SP


def _whole(st, mesh) -> dict:
    # copies: the next window writes the plane and the rings in place
    return {k: v.copy() for k, v in convert.state_to_numpy(SH.gather_sparse_state(st, mesh)).items()}


def digest(state_np: dict) -> dict:
    """Each leaf's dtype, shape and SHA-1 of its bytes: a per-tick record
    small enough to send back from every rank."""
    out = {}
    for k, v in state_np.items():
        v = np.ascontiguousarray(v)
        out[k] = (str(v.dtype), v.shape, hashlib.sha1(v.tobytes()).hexdigest())
    return out


def window(params, state_np: dict, draws, n_ticks: int, watch_rows=None, mutate=None, cells=None) -> dict:
    """Shard ``state_np`` over the group's member mesh and run the sharded
    window over the ``n_ticks`` per-tick full draws of each entry of
    ``draws`` (per-window lists), one tick at a time, applying ``mutate``
    (``{window: [(op name, args)]}``, :mod:`scalecube_cluster_tpu_torch.
    ops.sparse`) to the gathered state before a window; ``cells`` sets the
    row chunks' size (``_tensor.PLANE_CHUNK_CELLS``, and ``ROW_CHUNK`` a
    cell row's worth) for the call. Per window: the digest of this rank's
    shard after every tick (its rows of the member-axis leaves, the rest
    whole), the stacked metrics and the watched rows; the delivery
    kernel's launches."""
    from scalecube_cluster_tpu_torch.ops import _tensor

    keep = _tensor.PLANE_CHUNK_CELLS, _tensor.ROW_CHUNK
    if cells:
        _tensor.PLANE_CHUNK_CELLS, _tensor.ROW_CHUNK = cells, max(1, cells // params.capacity)
    try:
        return _window(params, state_np, draws, n_ticks, watch_rows, mutate)
    finally:
        _tensor.PLANE_CHUNK_CELLS, _tensor.ROW_CHUNK = keep


def _window(params, state_np, draws, n_ticks, watch_rows, mutate) -> dict:
    mesh = dcn.global_mesh("cpu")
    st = SH.shard_sparse_state(convert.state_from_numpy(state_np, device="cpu"), mesh)
    run = SH.make_sharded_sparse_run(mesh, params, 1)
    watch = None if watch_rows is None else torch.tensor(watch_rows)
    delivery.delivery_combine.launches = 0
    out = []
    for w, dr in enumerate(draws):
        if mutate and w in mutate:
            full = SH.gather_sparse_state(st, mesh)
            for name, args in mutate[w]:
                full = getattr(SP, name)(full, *args)
            st = SH.shard_sparse_state(full, mesh)
        assert len(dr) == n_ticks
        digests, per_tick, watched = [], [], []
        for tick_draws in dr:
            st, ms, seen = run(st, [tick_draws], watch)
            digests.append(digest(convert.state_to_numpy(st)))
            per_tick.append(ms)
            watched.append(None if seen is None else seen.numpy())
        out.append({"digests": digests,
                    "metrics": {k: torch.cat([m[k] for m in per_tick]).numpy() for k in per_tick[0]},
                    "watched": None if watch is None else np.concatenate(watched)})
    return {"windows": out, "rows": tuple(st.view_key.shape), "launches": delivery.delivery_combine.launches}


def ticks(params, state_np: dict, draws) -> dict:
    """The sharded tick (``make_sharded_sparse_tick``) stepped once per draw
    pair: the whole state and the metrics after each step."""
    mesh = dcn.global_mesh("cpu")
    st = SH.shard_sparse_state(convert.state_from_numpy(state_np, device="cpu"), mesh)
    step = SH.make_sharded_sparse_tick(mesh, params)
    out = []
    for fd, rd in draws:
        st, ms = step(st, fd, rd)
        out.append({"state": _whole(st, mesh), "metrics": {k: v.numpy() for k, v in ms.items()}})
    return {"ticks": out, "rows": tuple(st.view_key.shape)}


def alignment(cases) -> dict:
    """The mesh preconditions: for each ``(label, params)`` of ``cases``,
    what the sharded window and tick raise (type and message; "none" where
    they build)."""
    mesh = dcn.global_mesh("cpu")
    out = {}
    for label, params in cases:
        for what, fn in (("run", lambda p=params: SH.make_sharded_sparse_run(mesh, p, 1)),
                         ("tick", lambda p=params: SH.make_sharded_sparse_tick(mesh, p))):
            try:
                fn()
                out[(label, what)] = ("none", "")
            except Exception as exc:  # noqa: BLE001 - the refusal is the result
                out[(label, what)] = (type(exc).__name__, str(exc))
    return out


def refusals(params) -> dict:
    """What a sparse sharded driver refuses, as JAX's does (type and
    message by name): an adaptive spec at construction, ``set_adaptive``,
    the trace plane and a control ladder whose rungs arm adaptive FD."""
    import dataclasses

    from scalecube_cluster_tpu_torch.adaptive import AdaptiveSpec
    from scalecube_cluster_tpu_torch.sim import SimDriver

    mesh = dcn.global_mesh("cpu")
    n = params.capacity
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = ("none", "")
        except Exception as exc:  # noqa: BLE001 - the refusal is the result
            out[name] = (type(exc).__name__, str(exc))

    spec = AdaptiveSpec(enabled=True)
    attempt("adaptive spec", lambda: SimDriver(dataclasses.replace(params, adaptive=spec), n - 8, mesh=mesh,
                                               device="cpu"))
    d = SimDriver(params, n - 8, mesh=mesh, device="cpu")
    attempt("set_adaptive", lambda: d.set_adaptive(spec))
    attempt("trace capture", d.arm_trace)
    attempt("adaptive ladder", d.arm_control)
    return out
