"""Carry parameters and state across from the JAX package.

The converters take plain Python/numpy values — ``dataclasses.asdict`` of
the JAX ``PviewParams`` and the dict its ``ops.pview.snapshot(state)``
returns — so this module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.pview import PviewParams, PviewState


def params_from_dict(d: dict) -> PviewParams:
    """Port params from ``dataclasses.asdict(jax_params)``.

    Refuses what the port does not run (a non-default dissemination spec,
    an enabled adaptive spec, ``delay_slots > 0``). ``delivery_kernel`` is
    dropped: its two values compute the same function."""
    d = dict(d)
    dissem = d.pop("dissem", None) or {}
    if (dissem.get("strategy", "push"), dissem.get("topology", "full")) != ("push", "full"):
        raise ValueError(
            f"non-default dissemination {dissem.get('strategy')}/{dissem.get('topology')} "
            "is not ported yet"
        )
    adaptive = d.pop("adaptive", None) or {}
    if adaptive.get("enabled", False):
        raise ValueError("an enabled adaptive failure-detection spec is not ported yet")
    if d.get("delay_slots", 0):
        raise ValueError("delay_slots > 0 (the pending delivery rings) is not ported yet")
    d.pop("delivery_kernel", None)
    d["seed_rows"] = tuple(int(s) for s in d.get("seed_rows", ()))
    return PviewParams(**d)


def state_from_numpy(arrays: dict, device="cuda") -> PviewState:
    """Port state from a snapshot dict of numpy arrays (uint32 leaves are
    reinterpreted as int32, same bits)."""
    leaves = {}
    for f in dataclasses.fields(PviewState):
        v = np.asarray(arrays[f.name])
        if f.name == "tick":
            leaves["tick"] = int(v)
            continue
        if v.dtype == np.uint32:
            v = v.view(np.int32)
        leaves[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return PviewState(**leaves)


def state_to_numpy(state: PviewState) -> dict:
    """The inverse of :func:`state_from_numpy`, for comparisons."""
    out = {}
    for f in dataclasses.fields(PviewState):
        v = getattr(state, f.name)
        out[f.name] = np.int32(v) if f.name == "tick" else v.detach().cpu().numpy()
    return out
