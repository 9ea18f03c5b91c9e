"""The port's dense engine on a member mesh, through a real gloo lane.

Two and four spawned processes (``ops/dcn.py: LocalWorld``, one module-
scoped group each, one thread per rank) run the dense sharded tick, window
and driver of ``ops/sharding.py``; every rank returns the whole state
(gathered), the stacked metrics and the watched rows. Each must equal, bit
for bit, the one-process port on the same draws, and the JAX package's
single-device tick fed the same key chain (the two f32 metrics against JAX
within 2 ulp, as every dense parity test holds them): with and without
the delay rings, with i16 keys, with the push-pull reply leg, with the
structured peer selections, with the namespace gate, with dense and
scalar links, and over several row chunks. The scenario puts its
rumors, crashes, a join and a leave on the rank boundaries. Held against
JAX's ``tests/test_sharding.py`` (sharded = one device, with delay, the
capacity rule), ``test_dcn.py`` (``make_global_state`` then
``make_sharded_run``), ``test_bitplane_engine.py`` (the i16 word rule),
``test_telemetry.py`` (the sharded driver's ring) and ``test_obs_mesh.py``
(a static control ladder arms, an adaptive one is refused).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_dense_mesh_ranks as DR
import _torch_mesh_ranks as RK
from scalecube_cluster_tpu.dissemination import DissemSpec
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import kernel as TK
from scalecube_cluster_tpu_torch.ops import state as TS
from test_torch_dense import _jax_window, _tparams, dense_draws
from test_torch_pview_fused import FLOAT_METRICS

torch.set_num_threads(1)

N, N_INITIAL, T, WINDOWS = 128, 120, 4, 3
WATCH = (0, 31, 32, 63, 64, 127)
# JAX tests/test_sharding.py's dense knobs, with the dense parity tests'
# short suspicion timeout so that expiry happens inside the windows
_KNOBS = dict(capacity=N, fanout=2, ping_req_k=1, fd_every=1, sync_every=8, suspicion_mult=1, rumor_slots=4,
              seed_rows=(0, 1))
# what each case changes: the params, whether the links are [N, N] planes,
# the start's uniform delay, the row chunks' size in the sharded run
CASES = {
    "links": ({}, True, 0.0, None),
    "rings": ({"delay_slots": 4}, True, 1.5, None),
    "i16": ({"key_dtype": "i16"}, True, 0.0, None),
    "push_pull": ({"dissem": DissemSpec(strategy="push_pull")}, True, 0.0, None),
    "scalar": ({}, False, 0.0, None),
    "chunks": ({"delay_slots": 4, "dissem": DissemSpec(strategy="push_pull")}, True, 1.5, 16 * N),
    # structured peer selection over all N rows, the deterministic chords
    # and the drawn ones, each rank keeping its rows' picks
    "ring": ({"dissem": DissemSpec(strategy="accelerated", topology="ring")}, True, 0.0, None),
    "tuneable": ({"dissem": DissemSpec(strategy="tuneable", topology="expander", tuneable_mix=0.5)}, True, 0.0,
                 None),
    # the gossip and SYNC gates on the gathered namespace ids
    "namespaces": ({"namespace_gate": True, "sync_every": 4}, True, 0.0, None),
}
_NAMESPACES = ("a", "a/x", "a/y", "b")
# the mutation batch before window 1, on the 2- and 4-rank boundaries
MUTATE = {1: [("crash_rows", ([63, 96],)), ("join_row", (121, (0, 1))), ("begin_leave", (33,)),
              ("spread_rumor", (2, 95))]}


@pytest.fixture(scope="module")
def lane2():
    with dcn.LocalWorld(2, "cpu") as lw:
        yield lw


@pytest.fixture(scope="module")
def lane4():
    with dcn.LocalWorld(4, "cpu") as lw:
        yield lw


def _lane(request, world: int):
    return request.getfixturevalue(f"lane{world}")


def _start(mod, params, dense_links: bool, delay: float, **kw):
    if params.namespace_gate:
        kw["namespaces"] = [_NAMESPACES[r % 4] for r in range(params.capacity)]
    st = mod.init_state(params, N_INITIAL, warm=True, dense_links=dense_links, uniform_delay=delay, **kw)
    if dense_links:
        st = mod.set_uniform_loss(st, 0.05)
    st = mod.spread_rumor(st, 0, 63)
    st = mod.spread_rumor(st, 1, 64)
    return mod.crash_rows(st, [31, 32])


def _mutate(mod, st, w: int):
    for name, args in MUTATE.get(w, ()):
        st = getattr(mod, name)(st, *args)
    return st


def _assert_np_equal(ref: dict, got: dict, label: str, ulp_floats: bool = False):
    assert set(ref) == set(got), f"{label}: names differ: {set(ref) ^ set(got)}"
    for k, v in ref.items():
        v, g = np.asarray(v), np.asarray(got[k])
        assert g.shape == v.shape, f"{label}: {k} shape {g.shape} != {v.shape}"
        if ulp_floats and k in FLOAT_METRICS:
            ulp = np.abs(g.view(np.int32).astype(np.int64) - v.view(np.int32).astype(np.int64))
            assert ulp.max(initial=0) <= 2, f"{label}: {k} off by {ulp.max()} ulp"
        else:
            assert np.array_equal(g, v), f"{label}: {k} diverged"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_window_matches_one_process_and_jax(request, world, case):
    """Three sharded windows of 4 ticks, the mutation batch before the
    second: every rank's whole state, metrics and watched rows equal the
    one-process port window's on the same draws, and the state and metrics
    equal JAX's single-device ticks on the key chain that drew them."""
    over, dense_links, delay, cells = CASES[case]
    params = JS.SimParams(**{**_KNOBS, **over})
    tparams = _tparams(params)
    jst = _start(JS, params, dense_links, delay)
    tst = _start(TS, tparams, dense_links, delay, device="cpu")
    start_np = {k: v.copy() for k, v in convert.state_to_numpy(tst).items()}
    key = jax.random.PRNGKey(7)
    draws, jax_states, jax_metrics = [], [], []
    for w in range(WINDOWS):
        jst = _mutate(JS, jst, w)
        key_w = key
        ms = []
        for _ in range(T):
            jst, key_w, jm, _ = _jax_window(params, False)(jst, key_w)
            ms.append(jm)
        key, dr = dense_draws(key, T, params)
        assert np.array_equal(np.asarray(key), np.asarray(key_w))
        draws.append(dr)
        jax_states.append(JS.snapshot(jst))
        jax_metrics.append({k: np.concatenate([np.asarray(m[k]) for m in ms]) for k in ms[0]})

    run = TK.make_run(tparams, T)
    watch = torch.tensor(WATCH)
    one = []
    for w in range(WINDOWS):
        tst = _mutate(TS, tst, w)
        tst, tms, watched = run(tst, draws[w], watch)
        one.append(({k: v.copy() for k, v in convert.state_to_numpy(tst).items()},
                    {k: v.numpy() for k, v in tms.items()}, watched.numpy()))

    got = _lane(request, world).run(DR.window, tparams, start_np, draws, T, WATCH, MUTATE, cells)
    busy = {"gossip_msgs": 0, "sync_roundtrips": 0, "fd_new_suspects": 0, "rumor_deliveries": 0}
    for w in range(WINDOWS):
        state, metrics, watched = one[w]
        label = f"{case}, W = {world}, window {w}"
        _assert_np_equal(jax_states[w], state, f"{label}: one process against JAX")
        _assert_np_equal(jax_metrics[w], metrics, f"{label}: one process against JAX", ulp_floats=True)
        for r, rank in enumerate(got):
            rw = rank["windows"][w]
            _assert_np_equal(state, rw["state"], f"{label}: rank {r} against one process")
            _assert_np_equal(metrics, rw["metrics"], f"{label}: rank {r} against one process")
            _assert_np_equal(jax_states[w], rw["state"], f"{label}: rank {r} against JAX")
            _assert_np_equal(jax_metrics[w], rw["metrics"], f"{label}: rank {r} against JAX", ulp_floats=True)
            assert np.array_equal(watched, rw["watched"]), f"{label}: rank {r} watched rows"
        for k in busy:
            busy[k] += int(metrics[k].sum())
    # each rank held its own rows: [L, N] planes
    assert all(rank["rows"] == (N // world, N) for rank in got)
    assert all(v > 0 for v in busy.values()), busy


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_tick_matches_one_process(request, world):
    """``make_sharded_tick`` stepped tick by tick (JAX's sharded tick test):
    the tick advances, each rank holds [L, N] rows, the alive-view fraction
    of a warm cluster is 1, and every state and metric equals the
    one-process tick's on the same draws."""
    params = TS.SimParams(capacity=64, fd_every=1, sync_every=8, rumor_slots=4, seed_rows=(0,))
    st = TS.spread_rumor(TS.init_state(params, 48, warm=True, device="cpu"), 0, 5)
    start_np = {k: v.copy() for k, v in convert.state_to_numpy(st).items()}
    _, draws = dense_draws(jax.random.PRNGKey(1), 5, JS.SimParams(capacity=64, fd_every=1, sync_every=8,
                                                                rumor_slots=4, seed_rows=(0,)))
    got = _lane(request, world).run(DR.ticks, params, start_np, draws)
    for t, (fd, rd) in enumerate(draws):
        st, ms = TK.tick(st, fd, rd, params)
        ref, ref_ms = convert.state_to_numpy(st), {k: v.numpy() for k, v in ms.items()}
        for r, rank in enumerate(got):
            _assert_np_equal(ref, rank["ticks"][t]["state"], f"tick {t + 1}, rank {r}")
            _assert_np_equal(ref_ms, rank["ticks"][t]["metrics"], f"tick {t + 1}, rank {r} metrics")
    assert st.tick == 5 and abs(float(got[0]["ticks"][0]["metrics"]["alive_view_fraction"]) - 1.0) < 1e-5
    assert all(rank["rows"] == (64 // world, 64) for rank in got)


def test_alignment_rules_raise_jax_value_errors(lane4):
    """The capacity rule (capacity % W) always, and in the packed i16 mode
    the word rule (capacity % 32·W), with JAX's ValueError texts; an
    aligned capacity builds."""
    got = lane4.run(DR.alignment, [
        ("rows", TS.SimParams(capacity=30)),
        ("words", TS.SimParams(capacity=64, key_dtype="i16")),
        ("i32 aligned", TS.SimParams(capacity=64)),
        ("i16 aligned", TS.SimParams(capacity=128, key_dtype="i16")),
    ])
    for rank in got:
        for what in ("run", "tick"):
            kind, msg = rank[("rows", what)]
            assert kind == "ValueError" and msg == "capacity 30 not divisible by mesh size 4", msg
            kind, msg = rank[("words", what)]
            assert kind == "ValueError" and "must be divisible by 32 * mesh size (128)" in msg, msg
            assert "plane_dtype='i16'" in msg, msg
            assert rank[("i32 aligned", what)] == ("none", "")
            assert rank[("i16 aligned", what)] == ("none", "")


@pytest.mark.parametrize("world", [2, 4])
def test_make_global_state_then_sharded_run(request, world):
    """JAX's DCN script: ``make_global_state`` on every rank, then five
    ticks of ``make_sharded_run``: the alive-view fraction ends above 0.99,
    and the run equals the one-process window from the same init and
    generator."""
    params = TS.SimParams(capacity=16, fd_every=1, sync_every=8, seed_rows=(0,))
    got = _lane(request, world).run(DR.global_state_run, params, 16, 0, 5)
    ref, ms, _ = TK.make_run(params, 5)(TS.init_state(params, 16, device="cpu"), torch.Generator().manual_seed(0))
    ref_np, ref_ms = convert.state_to_numpy(ref), {k: v.numpy() for k, v in ms.items()}
    for r, rank in enumerate(got):
        assert rank["rows"] == (16 // world, 16)
        assert float(rank["metrics"]["alive_view_fraction"][-1]) > 0.99
        _assert_np_equal(ref_np, rank["state"], f"rank {r}")
        _assert_np_equal(ref_ms, rank["metrics"], f"rank {r} metrics")


_DRIVER_PARAMS = TS.SimParams(capacity=64, fd_every=2, sync_every=8, suspicion_mult=2, rumor_slots=2,
                              seed_rows=(0, 1))
_DRIVER_WORLDS = [2, pytest.param(4, marks=pytest.mark.slow)]


@pytest.mark.parametrize("world", _DRIVER_WORLDS)
def test_sharded_driver_matches_unsharded(request, world):
    """The driver script (rumors, a crash wave, a join, a leave, a metadata
    bump, a partition healed, watched rows) on a sharded dense driver with
    the telemetry plane armed: the whole state, events, views, statuses,
    coverage, health, readbacks and the telemetry ring (JAX's
    ``test_telemetry.py`` sharded-ring test) equal the unsharded driver's;
    no delivery kernel is launched."""
    from scalecube_cluster_tpu_torch.sim import SimDriver

    n = _DRIVER_PARAMS.capacity
    got = _lane(request, world).run(RK.sharded_driver, _DRIVER_PARAMS, n, "none")
    d = SimDriver(_DRIVER_PARAMS, n - 8, seed=3, device="cpu")
    d.arm_telemetry()
    RK.driver_script(d, n)
    ref = RK.driver_record(d, n)
    assert len(ref["telemetry"]) == 5  # one ring row per step of the script
    for r, rank in enumerate(got):
        assert rank.pop("launches") == 0
        _assert_np_equal(ref["state"], rank["state"], f"rank {r} state")
        for k in ref:
            if k != "state":
                assert rank[k] == ref[k], (r, k)


@pytest.mark.parametrize("world", _DRIVER_WORLDS)
def test_sharded_driver_scenario_checkpoint_profile_control(request, world, tmp_path):
    """On a sharded dense driver: ``run_scenario`` (a crash on a rank
    boundary and a partition healed) gives the unsharded driver's report,
    telemetry ring and final state; a checkpoint round trip (and a restore
    of the unsharded driver's archive) continues as the unsharded driver
    does; ``profile_ticks(mesh=)`` times the dense tick's phases and ends
    on the sharded window's state; a static control ladder arms and steps
    as on the unsharded driver."""
    from scalecube_cluster_tpu_torch.chaos.events import Crash, Partition, Scenario
    from scalecube_cluster_tpu_torch.control import ControlSpec
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.trace import profile as PR

    lane = _lane(request, world)
    p, n = _DRIVER_PARAMS, _DRIVER_PARAMS.capacity
    scenario = Scenario(name="mesh-dense", horizon=24, check_interval=4, events=[
        Crash(rows=[n // 2 - 1, n // 4], at=2),
        Partition(groups=[range(0, n // 2), range(n // 2, n - 8)], at=4, heal_at=12)])
    ref = DR.scenario_report(p, n - 8, 5, scenario, sharded=False)
    for r, rank in enumerate(lane.run(DR.scenario_report, p, n - 8, 5, scenario)):
        assert rank["report"] == ref["report"], r
        assert rank["ring"] == ref["ring"] and rank["windows"] == ref["windows"] >= 2, r
        _assert_np_equal(ref["state"], rank["state"], f"rank {r} scenario state")

    foreign = str(tmp_path / "unsharded.npz")
    u = SimDriver(p, n - 8, seed=4, device="cpu")
    u.step(3)
    u.checkpoint(foreign)
    path = str(tmp_path / "sharded.npz")
    got = lane.run(RK.checkpoint_run, p, n - 8, 4, path, foreign, 3)
    u.step(3)
    for r, rank in enumerate(got):
        _assert_np_equal(rank["ahead"], rank["again"], f"rank {r}: the restore continues as before")
        _assert_np_equal(convert.state_to_numpy(u.state), rank["foreign"], f"rank {r}: the unsharded archive")

    st = TS.spread_rumor(TS.init_state(p, n - 8, warm=True, device="cpu"), 0, n // 2)
    start_np = {k: v.copy() for k, v in convert.state_to_numpy(st).items()}
    _, unsharded = PR.profile_ticks(p, st, torch.Generator().manual_seed(9), 3, warmup_ticks=1)
    assert {"fd", "suspicion", "gossip", "sync", "refute", "sweep"} <= set(unsharded["phases_s"])
    for rank in lane.run(DR.profile_window, p, start_np, 9, 3, 1):
        assert rank["engine"] == "dense" and rank["ticks"] == 3 and rank["mesh"] == {"members": world}
        assert rank["phases"] == sorted(unsharded["phases_s"])
        _assert_np_equal(rank["window"], rank["profiled"], "the profiled ticks against the sharded window")

    # JAX test_obs_mesh.py: a static-rung ladder arms on a dense mesh
    spec = ControlSpec(epoch_windows=1)
    spec = dataclasses.replace(spec, ladder=tuple(dataclasses.replace(r, adaptive=False) for r in spec.ladder))
    ref = RK.control_run(p, n - 8, 6, spec, 4, 3, sharded=False)
    for r, rank in enumerate(lane.run(RK.control_run, p, n - 8, 6, spec, 4, 3)):
        assert rank["history"] == ref["history"] and rank["params"] == ref["params"], r
        assert rank["log"] == ref["log"] and rank["rung"] == ref["rung"], r
        _assert_np_equal(ref["state"], rank["state"], f"rank {r} control state")


def test_sharded_dense_flight_dump_carries_mesh_axes_and_replays(lane2, tmp_path):
    """A sharded dense driver's flight dump after a scenario: every rank
    writes the same reconstruction, stamped with the mesh, and it rebuilds
    an unsharded incident that replays to the recorded verdict."""
    from scalecube_cluster_tpu_torch.chaos.events import Crash, Scenario
    from scalecube_cluster_tpu_torch.replay import incident_from_flight
    from scalecube_cluster_tpu_torch.sim import SimDriver
    from scalecube_cluster_tpu_torch.telemetry.flight import load_flight_dump

    p, n = _DRIVER_PARAMS, _DRIVER_PARAMS.capacity
    scenario = Scenario(name="mesh-dense-crash", events=[Crash(rows=[n // 2], at=4)], horizon=24, check_interval=8)
    docs = [load_flight_dump(rank["armed"]) for rank in lane2.run(RK.flight_run, p, n - 8, 21, str(tmp_path),
                                                                  scenario)]
    for dump in docs:
        assert dump["reconstruction"]["mesh_axes"] == {"members": 2}
        inc = incident_from_flight(dump)
        assert inc.engine == "dense" and inc.seed == 21 and inc.params == p
    assert docs[0]["reconstruction"] == docs[1]["reconstruction"]
    inc = incident_from_flight(docs[0])
    rep = SimDriver(inc.params, n - 8, seed=inc.seed, device="cpu").run_scenario(scenario, max_window=8)
    assert docs[0]["reconstruction"]["verdict"]["ok"] == rep["ok"]


def test_audit_dense_sharded_programs_clean(lane2):
    """The audit's four dense member-mesh programs (JAX's names) on two gloo
    ranks: every contract clean on every rank."""
    from _torch_audit_ranks import sharded_verdict

    names = {"dense/i32/sharded", "dense/i16/sharded", "dense/i32/sharded-telemetry-row",
             "dense/i32/sharded-telemetry-append"}
    for verdict in lane2.run(sharded_verdict, None, ("i32", "i16"), "dense"):
        assert verdict["ok"], verdict
        assert {e["program"] for e in verdict["programs"]} == names
        assert all(e["mesh_size"] == 2 for e in verdict["programs"])
