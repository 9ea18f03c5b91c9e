"""The port's program-audit plane against the JAX package's, and its
falsifiability (``scalecube_cluster_tpu_torch/audit/``).

1. **Parity with JAX.** Each engine's ``EngineContracts`` equals JAX's field
   for field (``restore_module`` names the port module where restore
   copies); the port's matrix has JAX's program names, variants and
   applicable-contract sets, compared without running (the port's listed
   on a two-rank gloo group, so the member-mesh programs are there), none
   set aside; the verdict has JAX's keys.
2. **Falsifiability.** One seeded violation for each of JAX's, each caught
   with a message naming its source line: a window rebinding a plane to a
   clone; a strategy, a fleet, a fused, a bridge and a sharded window each
   run on copies (their in-place update dropped); an output aliasing a
   plane; an unused in-place leaf; a host read behind a decorator; the
   dense window with ``watch_rows`` (JAX's in-scan gather seed); a second
   state copy and a fleet budget overflow; a host-alias restore module and
   an unregistered one; a wide captured constant in a pview window. The
   port's forms of JAX's two seeds that JAX's own tests find red
   (post-donation read, unused donated leaf) pass here.
3. **The CLI**: exit 0 on a clean matrix, 1 on a seeded violation.

The clean matrix itself is ``tests/test_torch_audit_matrix.py``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scalecube_cluster_tpu_torch.audit import (  # noqa: E402
    AuditProgram,
    check_donation_alias,
    check_forbid_wide_values,
    check_memory_budget,
    check_no_plane_materialization,
    check_restore_seams,
    check_transfer_free,
    run_contracts,
)
from scalecube_cluster_tpu_torch.audit.programs import (  # noqa: E402
    DEFAULT_FLEET_SCENARIOS,
    _audit_params,
    _fleet,
    _gen,
    start_state,
    tree_bytes,
)
from scalecube_cluster_tpu_torch.ops import engine_api  # noqa: E402
from scalecube_cluster_tpu_torch.ops.engine_api import EngineContracts  # noqa: E402

N_TICKS = 4
CAPACITY = 128
HERE = "tests/test_torch_audit.py"


# ---------------------------------------------------------------------------
# 1. parity with JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["dense", "sparse", "pview"])
def test_engine_contracts_equal_jax(engine):
    from scalecube_cluster_tpu.ops import engine_api as JEA

    port = dataclasses.asdict(engine_api.engine(engine).contracts)
    jax_c = dataclasses.asdict(JEA.engine(engine).contracts)
    assert port.pop("restore_module") == "scalecube_cluster_tpu_torch.convert"
    assert jax_c.pop("restore_module") == f"scalecube_cluster_tpu.ops.{ {'dense': 'state'}.get(engine, engine)}"
    assert port == jax_c


@pytest.fixture(scope="module")
def port_listing():
    from _torch_audit_ranks import matrix_listing

    from scalecube_cluster_tpu_torch.ops import dcn

    with dcn.LocalWorld(2, "cpu") as lw:
        listing = lw.run(matrix_listing)
    assert listing[0] == listing[1]
    return listing[0]


def test_matrix_names_variants_and_contracts_equal_jax(port_listing):
    """JAX's ``build_matrix()`` on its 8 virtual devices against the port's
    on two gloo ranks: the same programs, variants and contract sets, none
    missing. The sparse sharded three (``sparse/i32/sharded``,
    ``sparse/i32/sharded-telemetry-row``/``-append``) and the dense four
    are built and held."""
    from scalecube_cluster_tpu.audit import build_matrix as jax_matrix
    from scalecube_cluster_tpu.audit.contracts import applicable_contracts as jax_applicable

    import scalecube_cluster_tpu_torch.audit as port_audit

    jax_rows = {(p.name, p.variant, tuple(jax_applicable(p))) for p in jax_matrix()}
    port_rows = set(port_listing)
    assert port_rows == jax_rows
    assert {"sparse/i32/sharded", "sparse/i32/sharded-telemetry-row",
            "sparse/i32/sharded-telemetry-append"} <= {r[0] for r in port_rows}
    assert not hasattr(port_audit, "not_ported")


def test_verdict_has_jax_keys():
    from scalecube_cluster_tpu.audit import audit_programs as jax_audit
    from scalecube_cluster_tpu.audit.programs import build_engine_programs as jax_build

    from scalecube_cluster_tpu_torch.audit import audit_programs, build_engine_programs

    jax_v = jax_audit(jax_build("dense", key_dtypes=["i32"], variants=["telemetry"]), compile_programs=True)
    port_v = audit_programs(build_engine_programs("dense", key_dtypes=["i32"], variants=["telemetry"],
                                                  device="cpu"), device="cpu")
    assert port_v["ok"] and port_v["device"] == "cpu" and port_v["device_name"] == "cpu"
    assert "CPU run" in port_v["instrument"]
    assert set(jax_v) - {"jax_version"} <= set(port_v)
    assert {"device", "torch_version"} <= set(port_v) and "not_ported" not in port_v
    for jax_e, port_e in zip(jax_v["programs"], port_v["programs"]):
        assert set(port_e) == set(jax_e) | {"device"}
        assert port_e["program"] == jax_e["program"] and set(port_e["contracts"]) == set(jax_e["contracts"])
        assert {"argument_size_in_bytes", "peak_live_bytes", "budget_bytes"} <= set(port_e["memory"])
    assert set(port_v["restore_seams"]) == set(jax_v["restore_seams"])


# ---------------------------------------------------------------------------
# 2. falsifiability
# ---------------------------------------------------------------------------


def _program(name, fn, make_args, inplace=((0, ("view_key",)),), outputs=None, contracts=None, basis=1, **kw):
    return AuditProgram(
        name=name, engine="seeded", variant="seeded", key_dtype="i32", capacity=CAPACITY, n_ticks=N_TICKS,
        fn=fn, make_args=make_args, inplace=inplace,
        outputs=outputs or (lambda args, out: ((out[0],), [(f"metric {k}", v) for k, v in out[1].items()])),
        contracts=contracts or EngineContracts(), budget_basis_bytes=basis, wide_threshold=CAPACITY,
        device="cpu", **kw)


def _copying(run):
    """``run`` on copies of every state leaf: a builder whose in-place update
    was dropped (JAX's ``donate=False``)."""

    def copied(state, *rest, **kw):
        fresh = state.replace(**{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)
                                 if isinstance(getattr(state, f.name), torch.Tensor)})
        return run(fresh, *rest, **kw)

    return copied


def _dense(params=None):
    eng = engine_api.engine("dense")
    params = params or _audit_params("dense", CAPACITY, "i32")
    return eng, params, lambda: (start_state(eng, params, "cpu"), _gen("cpu"))


def _dropped(violations, leaf="view_key"):
    return [v for v in violations if leaf in v.message and ("NEW storage" in v.message or "WHOLE" in v.message)]


def test_seeded_plane_rebound_to_a_clone_is_caught():
    """A window that rebinds a plane to a clone of it before the ticks (the
    torch form of JAX's missing alias): the plane comes back in new
    storage, and the clone named at this file's line."""
    eng, params, args = _dense()
    run = eng.make_run(params, N_TICKS)

    def window(state, gen):
        return run(state.replace(view_key=state.view_key.clone()), gen)

    violations = check_donation_alias(_program("seeded/rebound", window, args, ((0, eng.inplace_leaves),)))
    got = _dropped(violations)
    assert got, violations
    assert any(HERE in v.where for v in got), [v.where for v in got]
    # the shipped window keeps every in-place leaf
    assert check_donation_alias(_program("shipped/dense", run, args, ((0, eng.inplace_leaves),))) == []


@pytest.mark.parametrize("kind", ["strategy", "fleet", "fused", "bridge"])
def test_seeded_builder_dropping_in_place_is_caught(kind):
    """A real strategy (dense ``accelerated/ring``), fleet (dense), fused
    (pview, its delay rings armed: the rings are its in-place leaves) and
    bridge-watched (dense) window run on copies of its leaves: every
    dropped in-place leaf is caught; the shipped builder stays clean."""
    from scalecube_cluster_tpu_torch.dissemination import DissemSpec

    if kind == "fused":
        eng = engine_api.engine("pview")
        params = dataclasses.replace(_audit_params("pview", CAPACITY, "i32"), delay_slots=2)
        run, leaf = eng.make_fused_run(params, N_TICKS), "pending_src"
        args = lambda: (start_state(eng, params, "cpu"), _gen("cpu"))  # noqa: E731
    elif kind == "fleet":
        eng, params, _ = _dense()
        run, leaf = eng.make_fleet_run(params, N_TICKS), "view_key"
        args = lambda: (_fleet(eng, params, "cpu"), _gen("cpu"))  # noqa: E731
    else:
        spec = DissemSpec(strategy="accelerated", topology="ring") if kind == "strategy" else DissemSpec()
        eng, params, args = _dense(dataclasses.replace(_audit_params("dense", CAPACITY, "i32"), dissem=spec))
        run, leaf = eng.make_run(params, N_TICKS), "view_key"
        if kind == "bridge":
            watch = torch.tensor([1, 2, 9])
            base = run
            run = lambda st, gen: base(st, gen, watch_rows=watch)  # noqa: E731
    inplace = ((0, eng.inplace_leaves),)
    bad = check_donation_alias(_program(f"seeded/{kind}-dropped", _copying(run), args, inplace))
    assert _dropped(bad, leaf), bad
    assert all(v.where for v in _dropped(bad, leaf) if "WHOLE" in v.message)
    assert check_donation_alias(_program(f"shipped/{kind}", run, args, inplace)) == []


def test_seeded_sharded_window_dropping_in_place_is_caught():
    """The sharded pview window (rings armed) run on copies, on a one-rank
    gloo group: caught; the shipped sharded window stays clean."""
    from _torch_audit_ranks import sharded_dropped_inplace

    from scalecube_cluster_tpu_torch.ops import dcn

    with dcn.LocalWorld(1, "cpu") as lw:
        ((bad, good),) = lw.run(sharded_dropped_inplace)
    assert any("pending_" in m and ("NEW storage" in m or "WHOLE" in m) for m, _ in bad), bad
    assert any("_torch_audit_ranks.py" in w for _, w in bad)
    assert good == []


def test_seeded_output_aliasing_a_plane_is_caught():
    """JAX's post-donation read (red in JAX's own tests): the window updates
    the plane in place and hands the same storage out as a metric."""

    def window(state, gen):
        state.view_key.add_(1)
        return state, {"leak": state.view_key}

    eng, params, args = _dense()
    violations = check_donation_alias(_program("seeded/post-update-read", window, args))
    assert any("UNCHANGED" in v.message and "'metric leak'" in v.message for v in violations), violations


@dataclasses.dataclass
class _Trio:
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor


def test_unused_in_place_leaf_is_flagged_and_only_it():
    """JAX's unused donated leaf (red in JAX's own tests): leaf ``a`` is
    declared in place but never read or written; ``b`` and ``c`` are
    updated in place and must not be flagged."""

    def window(st, scale):
        st.b[0] += 1.0
        st.c.mul_(scale)
        return st, {}

    def args():
        return _Trio(*(torch.zeros((32, 32)) for _ in range(3))), torch.tensor(2.0)

    violations = check_donation_alias(_program("seeded/unused-leaf", window, args, ((0, ("a", "b", "c")),)))
    msgs = "\n".join(v.message for v in violations)
    assert any("UNUSED" in v.message and "arg0.a" in v.message for v in violations), msgs
    assert not any("arg0.b" in v.message or "arg0.c" in v.message for v in violations), msgs


def test_seeded_host_read_behind_a_decorator_is_caught():
    """A ``.item()`` reached through a decorator under an innocuous name —
    no source pattern matches it — is a host read outside the sanctioned
    sites, reported at this file's line; the shipped window's reads are all
    sanctioned."""

    def _devicely(f):
        def wrapped(x):
            hatch = getattr(x.sum(), "it" + "em")
            return f(x) + hatch()

        return wrapped

    @_devicely
    def _mean_adjust(x):
        return x.float().mean()

    eng, params, args = _dense()
    run = eng.make_run(params, N_TICKS)

    def window(state, gen):
        out = run(state, gen)
        out[1]["adjust"] = torch.full((), _mean_adjust(state.changed_at))
        return out

    violations = check_transfer_free(_program("seeded/hidden-read", window, args))
    assert violations, "the hidden host read was missed"
    v = violations[0]
    assert "Tensor.item" in v.message and HERE in v.where, v
    assert check_transfer_free(_program("shipped/dense", run, args)) == []


def test_seeded_watch_rows_gather_is_caught():
    """JAX's in-scan gather seed, spelled by the real dense window: with
    ``watch_rows`` it gathers rows of the [N, N] view plane every tick and
    hands them only to the watched output. The unwatched window is clean."""
    eng, params, args = _dense()
    run = eng.make_run(params, N_TICKS)
    watch = torch.arange(4)
    violations = check_no_plane_materialization(
        _program("seeded/watch-gather", lambda st, gen: run(st, gen, watch_rows=watch), args,
                 outputs=lambda a, out: ((out[0],), [("watched rows", out[2])])))
    assert violations, "the watch gather was missed"
    v = violations[0]
    assert f"({CAPACITY}, {CAPACITY})" in v.message and "materialization" in v.message
    assert v.where.startswith("scalecube_cluster_tpu_torch/ops/"), v.where
    assert check_no_plane_materialization(_program("shipped/dense", run, args)) == []


@pytest.mark.parametrize("fleet", [False, True])
def test_seeded_second_state_copy_overflows_the_budget(fleet):
    """A window that keeps a second copy of its state (a fleet: of the whole
    stacked state) past a tight budget (factor 1.2 + 1/16 MiB)."""
    shape = (DEFAULT_FLEET_SCENARIOS, CAPACITY, CAPACITY) if fleet else (CAPACITY, CAPACITY)

    def window(state, key):
        state[..., 0, :].add_(1.0)
        return state, {"copy": state * 3.0 + key}

    tight = EngineContracts(memory_factor=1.2, memory_overhead_mib=1 / 16)
    prog = _program("seeded/budget-overflow", window, lambda: (torch.zeros(shape), torch.ones(())),
                    inplace=((0, None),), contracts=tight, basis=tree_bytes(torch.zeros(shape)))
    violations = check_memory_budget(prog)
    assert violations and "exceeds the declared budget" in violations[0].message, violations
    assert "CPU run" in violations[0].message


def test_seeded_host_alias_restore_is_caught(tmp_path):
    bad = tmp_path / "seeded_restore.py"
    bad.write_text(textwrap.dedent("""
        import numpy as np
        import torch

        def restore(arrays):
            return {k: torch.from_numpy(v).to("cpu") for k, v in arrays.items()}

        def load(path):
            with np.load(path) as npz:
                return restore(dict(npz))
    """))
    violations = check_restore_seams(modules={"seeded": str(bad)})
    assert violations, "the host-alias restore was missed"
    v = violations[0]
    assert v.program == "seeded" and "zero-copy" in v.message and "restore" in v.message
    assert str(bad) in v.where and v.where.endswith(":6")


def test_unregistered_or_vacuous_restore_module_is_flagged(tmp_path):
    assert "restore_module" in check_restore_seams(modules={"noseam": None})[0].message
    empty = tmp_path / "no_restore.py"
    empty.write_text("import torch\n\ndef step(x):\n    return torch.as_tensor(x)\n")
    (v,) = check_restore_seams(modules={"vacuous": str(empty)})
    assert "vacuously" in v.message


def test_restore_seams_are_registered_and_clean():
    assert check_restore_seams() == []


def test_wide_captured_constant_is_caught_in_a_pview_window():
    table = torch.zeros((CAPACITY, CAPACITY))

    def window(state, key):
        state.add_(table[0, 0] + key)
        return state, {}

    prog = _program("seeded/wide-constant", window, lambda: (torch.zeros(CAPACITY), torch.ones(())),
                    inplace=((0, None),), contracts=EngineContracts(forbid_wide_values=True))
    violations = check_forbid_wide_values(prog)
    assert any("CAPTURED CONSTANT" in v.message and HERE in v.where for v in violations), violations


# ---------------------------------------------------------------------------
# 3. the CLI
# ---------------------------------------------------------------------------


def test_cli_exits_0_clean_and_1_on_a_seeded_violation(monkeypatch, capsys):
    from scalecube_cluster_tpu_torch.audit.__main__ import main

    argv = ["--engine", "dense", "--variants", "telemetry", "--device", "cpu"]
    assert main(argv) == 0
    assert "program audit: PASS" in capsys.readouterr().out
    dense = engine_api._ENGINES["dense"]

    def starved():
        eng = dense()
        return dataclasses.replace(eng, contracts=dataclasses.replace(eng.contracts, memory_factor=0.0,
                                                                      memory_overhead_mib=0.0))

    monkeypatch.setitem(engine_api._ENGINES, "dense", starved)
    assert main(argv + ["--json"]) == 1
    assert '"ok": false' in capsys.readouterr().out


def test_run_contracts_fast_mode_skips_the_measured_run():
    eng, params, args = _dense()
    prog = _program("dense/fast", eng.make_run(params, N_TICKS), args, ((0, eng.inplace_leaves),))
    verdict = run_contracts(prog, compile_programs=False)
    assert set(verdict) == {"donation_alias", "transfer_free", "no_plane_materialization"}
    assert all(v == [] for v in verdict.values()) and prog._memory is None
