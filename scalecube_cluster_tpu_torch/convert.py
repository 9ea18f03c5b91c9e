"""Carry parameters and state across from the JAX package.

The converters take plain Python/numpy values — ``dataclasses.asdict`` of
the JAX ``SimParams``, ``SparseParams`` or ``PviewParams``, and the dict its
engine's ``snapshot(state)`` returns — so this module imports nothing of
JAX. The engine is told by the fields: a pview params dict has
``view_slots``, a sparse one ``mr_slots``, a dense one neither; a dense
state has ``changed_at``, a sparse one ``n_live``, a pview one ``nbr_key``.
The dense engine's packed infection words are uint32 in JAX and int32 in
the port (same bits); :func:`state_to_numpy` gives them back as uint32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .adaptive import AdaptiveSpec, AdaptiveState
from .dissemination.spec import DissemSpec
from .ops.pview import PviewParams, PviewState
from .ops.sparse import SparseParams, SparseState
from .ops.state import SimParams, SimState


def params_from_dict(d: dict):
    """Port params (``SimParams``, ``SparseParams`` or ``PviewParams``)
    from ``dataclasses.asdict(jax_params)``.

    The ``dissem`` and ``adaptive`` dicts become the port's own
    :class:`DissemSpec` and :class:`AdaptiveSpec`. Refuses what the port
    does not run (``delay_slots > 0`` on the pview and sparse engines),
    naming its ROADMAP item. A pview ``delivery_kernel`` is dropped: its
    two values compute the same function."""
    d = dict(d)
    d["dissem"] = DissemSpec(**(d.pop("dissem", None) or {}))
    d["adaptive"] = AdaptiveSpec(**(d.pop("adaptive", None) or {}))
    d.pop("delivery_kernel", None)
    d["seed_rows"] = tuple(int(s) for s in d.get("seed_rows", ()))
    if "mr_slots" not in d:
        return SimParams(**d)
    if d.get("delay_slots", 0):
        raise ValueError(
            "delay_slots > 0 on the pview and sparse engines (their pending delivery rings) "
            "is not ported yet (ROADMAP A2)"
        )
    return PviewParams(**d) if "view_slots" in d else SparseParams(**d)


def adaptive_from_numpy(arrays: dict, device="cuda") -> AdaptiveState:
    """The port's adaptive plane from the JAX ``AdaptiveState``'s leaves as
    numpy arrays (``{"lh", "conf_key", "conf"}``), copied onto ``device``."""
    return AdaptiveState(**{
        k: torch.from_numpy(np.array(arrays[k], dtype=np.int32, copy=True)).to(device)
        for k in ("lh", "conf_key", "conf")
    })


def adaptive_to_numpy(ad: AdaptiveState) -> dict:
    """The inverse of :func:`adaptive_from_numpy`."""
    return {k: getattr(ad, k).detach().cpu().numpy() for k in ("lh", "conf_key", "conf")}


def _state_class(arrays):
    if "changed_at" in arrays:
        return SimState
    return SparseState if "view_key" in arrays else PviewState


def state_from_numpy(arrays: dict, device="cuda"):
    """Port state from a snapshot dict of numpy arrays (uint32 leaves are
    reinterpreted as int32, same bits)."""
    leaves = {}
    for f in dataclasses.fields(_state_class(arrays)):
        v = np.asarray(arrays[f.name])
        if f.name == "tick":
            leaves["tick"] = int(v)
            continue
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        leaves[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return _state_class(arrays)(**leaves)


def state_to_numpy(state) -> dict:
    """The inverse of :func:`state_from_numpy`: the JAX package's snapshot
    layout, for comparisons and checkpoints."""
    out = {}
    u32 = getattr(state, "U32_LEAVES", ())
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "tick":
            out[f.name] = np.int32(v)
            continue
        a = v.detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in u32 else a
    return out


def fleet_from_numpy(arrays: dict, device="cuda"):
    """Port fleet state (:mod:`.ops.fleet`) from a JAX fleet state's leaves
    as numpy arrays, each stacked to [S, ...]; the [S] ticks must agree (a
    port fleet shares one host tick)."""
    ticks = np.unique(np.asarray(arrays["tick"]).reshape(-1))
    if ticks.size != 1:
        raise ValueError(f"a fleet shares one tick; these rows are at ticks {ticks.tolist()}")
    return state_from_numpy({**arrays, "tick": ticks[0]}, device)


def fleet_to_numpy(fleet_state) -> dict:
    """The inverse of :func:`fleet_from_numpy`: the JAX fleet layout, the
    shared tick repeated to [S] int32."""
    out = state_to_numpy(fleet_state)
    out["tick"] = np.full((fleet_state.up.shape[0],), fleet_state.tick, np.int32)
    return out
