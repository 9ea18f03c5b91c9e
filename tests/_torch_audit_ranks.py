"""Rank-side functions of the audit tests (``tests/test_torch_audit*.py``):
each runs on every rank of a :class:`scalecube_cluster_tpu_torch.ops.dcn.
LocalWorld` (gloo, one thread per rank) and returns plain Python. This
module imports no JAX: the ranks never load it."""

from __future__ import annotations

import dataclasses

import torch

from scalecube_cluster_tpu_torch.audit import audit_programs, build_engine_programs, build_matrix
from scalecube_cluster_tpu_torch.audit.contracts import applicable_contracts, check_donation_alias
from scalecube_cluster_tpu_torch.audit.programs import AuditProgram, _audit_params, _gen, start_state
from scalecube_cluster_tpu_torch.ops import engine_api, sharding


def matrix_listing() -> list:
    """(name, variant, applicable contracts) of every program of the port's
    matrix on this group's member mesh, built but not run."""
    mesh = sharding.make_mesh("cpu")
    return [(p.name, p.variant, tuple(applicable_contracts(p))) for p in build_matrix(device="cpu", mesh=mesh)]


def sharded_verdict(programs=None, key_dtypes=("i32",), engine: str = "pview") -> dict:
    """The audit verdict of ``engine``'s sharded programs (``programs``:
    their names, or all) on this group's member mesh."""
    mesh = sharding.make_mesh("cpu")
    progs = build_engine_programs(engine, device="cpu", variants=["sharded"], key_dtypes=list(key_dtypes),
                                  mesh=mesh)
    if programs is not None:
        progs = [p for p in progs if p.name in programs]
    return audit_programs(progs, device="cpu", engine_names=[engine])


def sharded_dropped_inplace() -> tuple:
    """The sharded pview window (delay rings armed, so it has in-place
    leaves) run on copies of its leaves — a builder that dropped its
    in-place update — and the shipped window: the donation contract's
    messages for each."""
    mesh = sharding.make_mesh("cpu")
    eng = engine_api.engine("pview")
    params = dataclasses.replace(_audit_params("pview", 256, "i32"), delay_slots=2)
    run = eng.make_sharded_run(mesh, params, 4)

    def copying(state, gen):
        fresh = state.replace(**{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
                                 if isinstance(getattr(state, f.name), torch.Tensor)})
        return run(fresh, gen)

    def program(name, fn):
        return AuditProgram(
            name=name, engine="pview", variant="sharded", key_dtype="i32", capacity=256, n_ticks=4, fn=fn,
            make_args=lambda: (eng.shard_state(start_state(eng, params, "cpu"), mesh), _gen("cpu")),
            inplace=((0, eng.inplace_leaves),), outputs=lambda args, out: ((out[0],), []),
            contracts=eng.contracts, budget_basis_bytes=1, wide_threshold=256, mesh_size=1, device="cpu")

    bad = [(v.message, v.where) for v in check_donation_alias(program("seeded/sharded-dropped", copying))]
    good = [(v.message, v.where) for v in check_donation_alias(program("shipped/sharded", run))]
    return bad, good
