"""Carry parameters and state across from the JAX package.

The converters take plain Python/numpy values — ``dataclasses.asdict`` of
the JAX ``PviewParams`` or ``SparseParams``, and the dict its engine's
``snapshot(state)`` returns — so this module imports nothing of JAX. The
engine is told by the fields: a pview params dict has ``view_slots``, a
pview state ``nbr_key``; a sparse state has ``view_key``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.pview import PviewParams, PviewState
from .ops.sparse import SparseParams, SparseState


def params_from_dict(d: dict):
    """Port params (``PviewParams`` or ``SparseParams``) from
    ``dataclasses.asdict(jax_params)``.

    Refuses what the port does not run (a non-default dissemination spec,
    an enabled adaptive spec, ``delay_slots > 0``), naming its ROADMAP
    item. A pview ``delivery_kernel`` is dropped: its two values compute
    the same function."""
    d = dict(d)
    dissem = d.pop("dissem", None) or {}
    if (dissem.get("strategy", "push"), dissem.get("topology", "full")) != ("push", "full"):
        raise ValueError(
            f"non-default dissemination {dissem.get('strategy')}/{dissem.get('topology')} "
            "is not ported yet (ROADMAP A8)"
        )
    adaptive = d.pop("adaptive", None) or {}
    if adaptive.get("enabled", False):
        raise ValueError("an enabled adaptive failure-detection spec is not ported yet (ROADMAP A8)")
    if d.get("delay_slots", 0):
        raise ValueError("delay_slots > 0 (the pending delivery rings) is not ported yet (ROADMAP A2)")
    d.pop("delivery_kernel", None)
    d["seed_rows"] = tuple(int(s) for s in d.get("seed_rows", ()))
    return PviewParams(**d) if "view_slots" in d else SparseParams(**d)


def _state_class(arrays):
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
    """The inverse of :func:`state_from_numpy`, for comparisons."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = np.int32(v) if f.name == "tick" else v.detach().cpu().numpy()
    return out
