"""The port's clean audit matrix on the CPU (``scalecube_cluster_tpu_torch/
audit/``): every engine's windows pass every applicable contract at JAX's
audit shapes, the member-mesh programs on spawned gloo ranks (one rank,
then two with the 2-D fleet), each verdict stamped as a CPU run.

The tier-1 lane runs the dense and sparse matrices whole, pview's
one-device programs for its primary key dtype but the fleets (the whole
pview matrix is ``-m slow``: ~40,000 recorded operations a pview window)
and pview's i16 window without its measured run, and pview's sharded
programs for the primary dtype at one rank and the sharded window and
the 2-D fleet at two. ``python -m scalecube_cluster_tpu_torch.audit --all
--device cpu`` runs everything.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scalecube_cluster_tpu_torch.audit import audit_all, build_engine_programs, run_contracts  # noqa: E402


def _flat(verdict) -> list:
    return [f"{e['program']}: {c}: {v['message']} [{v['where']}]" for e in verdict["programs"]
            for c, cv in e["contracts"].items() for v in cv["violations"]]


@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_clean_matrix_whole(engine):
    verdict = audit_all(engines=[engine], device="cpu")
    assert verdict["ok"], _flat(verdict)
    assert verdict["device"] == "cpu" and "CPU run" in verdict["instrument"]
    assert verdict["n_programs"] >= 12
    names = {e["program"] for e in verdict["programs"]}
    assert {f"{engine}/i32/unarmed", f"{engine}/i32/fleet", f"{engine}/i32/replay", f"{engine}/i32/fused"} <= names
    # both engines run on a member mesh: their sharded programs are audited
    # (on the one-rank group audit_all starts), none is missing
    assert "not_ported" not in verdict
    sharded = {f"{engine}/i32/sharded", f"{engine}/i32/sharded-telemetry-row",
               f"{engine}/i32/sharded-telemetry-append"}
    if engine == "dense":
        sharded.add("dense/i16/sharded")
    assert sharded <= names
    for e in verdict["programs"]:
        assert e["memory"]["peak_live_bytes"] <= e["memory"]["budget_bytes"]


@pytest.mark.parametrize("variants", [["unarmed", "traced", "telemetry", "bridge"], ["strategy", "adaptive"],
                                      ["fused"]], ids=["windows", "armed", "fused"])
def test_clean_matrix_pview(variants):
    progs = [p for p in build_engine_programs("pview", key_dtypes=["i32"], variants=variants, device="cpu")
             if not p.name.endswith("fleet")]
    from scalecube_cluster_tpu_torch.audit import audit_programs

    verdict = audit_programs(progs, device="cpu", engine_names=["pview"])
    assert verdict["ok"], _flat(verdict)
    for e in verdict["programs"]:
        assert "forbid_wide_values" in e["contracts"]


def test_pview_i16_window_has_no_wide_values():
    (prog,) = build_engine_programs("pview", key_dtypes=["i16"], variants=["unarmed"], device="cpu")
    verdict = run_contracts(prog, compile_programs=False)
    assert verdict == {"donation_alias": [], "transfer_free": [], "no_plane_materialization": [],
                       "forbid_wide_values": []}


def test_sharded_programs_one_rank():
    from _torch_audit_ranks import sharded_verdict

    from scalecube_cluster_tpu_torch.ops import dcn

    with dcn.LocalWorld(1, "cpu") as lw:
        (verdict,) = lw.run(sharded_verdict)
    assert verdict["ok"], _flat(verdict)
    assert {e["program"] for e in verdict["programs"]} == {
        "pview/i32/sharded", "pview/i32/sharded-fused", "pview/i32/sharded-telemetry-row",
        "pview/i32/sharded-telemetry-append", "pview/i32/sharded-profile-gossip"}
    assert all(e["mesh_size"] == 1 for e in verdict["programs"])


def test_sharded_programs_two_ranks():
    """The sharded window and the 2-D scenarios x members fleet on two gloo
    ranks: every rank's verdict clean."""
    from _torch_audit_ranks import sharded_verdict

    from scalecube_cluster_tpu_torch.ops import dcn

    with dcn.LocalWorld(2, "cpu") as lw:
        verdicts = lw.run(sharded_verdict, ["pview/i32/sharded", "pview/i32/sharded-mesh2d"])
    for verdict in verdicts:
        assert verdict["ok"], _flat(verdict)
        assert {e["program"] for e in verdict["programs"]} == {"pview/i32/sharded", "pview/i32/sharded-mesh2d"}
        assert all(e["mesh_size"] == 2 for e in verdict["programs"])


@pytest.mark.slow
def test_full_matrix_pview():
    verdict = audit_all(engines=["pview"], device="cpu")
    assert verdict["ok"], _flat(verdict)


@pytest.mark.slow
def test_sharded_programs_two_ranks_whole():
    from _torch_audit_ranks import sharded_verdict

    from scalecube_cluster_tpu_torch.ops import dcn

    with dcn.LocalWorld(2, "cpu") as lw:
        verdicts = lw.run(sharded_verdict, None, ("i32", "i16"))
    for verdict in verdicts:
        assert verdict["ok"], _flat(verdict)
