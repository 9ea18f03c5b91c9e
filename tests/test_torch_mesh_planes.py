"""The driver's planes on a member-sharded pview driver, through a real
gloo lane (``ops/dcn.py: LocalWorld(2, "cpu")``, one module-scoped group).

Each rank runs the same driver script on its rows; what comes back is
whole and must be identical on both ranks. Held against the one-process
port and the JAX package:

* ``run_scenario``: JAX ``tests/test_sharding.py``'s split-heal scenario
  at N = 64, the port's driver fed the JAX driver's key chain: the sharded
  report, final state and member identities equal the unsharded port's and
  JAX's;
* ``arm_control``: an armed idle controller leaves a sharded driver
  bit-equal to an unarmed one (one ring read per epoch), and a controller
  that climbs under a 25% loss floor has the rung history, decision log,
  params and adaptive planes of the unsharded driver's;
* the profiler: ``profile_ticks(mesh=)`` ends where the sharded fused
  window ends, and ``profile_driver`` leaves a sharded driver's trajectory
  untouched (JAX ``tests/test_obs_mesh.py:271, :298``);
* checkpoint and restore between sharded and unsharded drivers both ways,
  the exposition's counters monotone across a restore (``:123``);
* the flight dump's ``mesh_axes`` (a sibling of ``params``), its rebuild
  through ``replay.incident_from_flight``, and an unarmed dump that stays
  partial (``:448-500``).
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as RK
import scalecube_cluster_tpu.ops.pview as JPV
from scalecube_cluster_tpu.chaos import events as JEV
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import control as TC
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.chaos import events as TEV
from scalecube_cluster_tpu_torch.ops import dcn
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.sim import SimDriver
from scalecube_cluster_tpu_torch.telemetry.openmetrics import parse_exposition
from test_torch_pview_fused import _assert_state_equal, _jax_draws

torch.set_num_threads(1)

N, N_INITIAL = 64, 48


@pytest.fixture(scope="module")
def lane2():
    with dcn.LocalWorld(2, "cpu") as lw:
        yield lw


def _jparams(**over):
    """JAX tests/test_sharding.py's pview knobs with its scenario test's
    overrides (capacity 64, a 64-slot pool, SYNC every 6, FD every 2)."""
    kw = dict(capacity=N, view_slots=8, active_slots=4, fanout=2, ping_req_k=2, fd_every=2, sync_every=6,
              rumor_slots=4, seed_rows=(0, 1), mr_slots=64)
    kw.update(over)
    return JPV.PviewParams(**kw)


def _tparams(params):
    return convert.params_from_dict(dataclasses.asdict(params))


def _split_heal(ev):
    return ev.Scenario(name="split-heal-sharded",
                       events=[ev.Partition(groups=[range(0, 24), range(24, 48)], at=8, heal_at=48)],
                       horizon=160, check_interval=8)


def _same(a, b, path):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _states_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


# -- run_scenario -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_scenario():
    jp = _jparams()
    jd = JSimDriver(jp, N_INITIAL, warm=True, seed=0)
    rep = jd.run_scenario(_split_heal(JEV))
    _, draws = _jax_draws(jax.random.PRNGKey(0), 160, jp)
    return jd, rep, draws


def test_run_scenario_on_sharded_driver_equals_unsharded_and_jax(lane2):
    jd, jrep, draws = _jax_scenario()
    tparams = _tparams(_jparams())
    res = lane2.run(RK.scenario_run, tparams, N_INITIAL, 0, _split_heal(TEV), draws)
    one = RK.scenario_run(tparams, N_INITIAL, 0, _split_heal(TEV), draws, sharded=False)
    jrep = dict(jrep)
    jrep.pop("host_cpus", None)
    assert jrep.pop("backend") and one["report"]["backend"] == "cpu"
    for r, rank in enumerate(res):
        _same(one, rank, f"rank {r}")
    rep = dict(one["report"])
    rep.pop("backend")
    assert rep == jrep, "the port's report differs from JAX's"
    for k, v in JPV.snapshot(jd.state).items():
        v = np.asarray(v)
        assert np.array_equal(one["state"][k], v.view(np.int32) if v.dtype == np.uint32 else v), k
    assert one["members"] == {r: m.id for r, m in jd.members.items()}
    assert rep["ok"] and rep["violations"] == 0, rep
    assert [e["event"] for e in rep["events_applied"]] == ["partition@8", "heal@48"]


# -- arm_control ------------------------------------------------------------------


def _static_spec(**kw):
    spec = TC.ControlSpec(**kw)
    return dataclasses.replace(spec, ladder=tuple(dataclasses.replace(r, adaptive=False) for r in spec.ladder))


def test_arm_control_on_mesh_is_armed_idle_bit_identical(lane2):
    """JAX test_obs_mesh.py's armed-idle case: a never-actuating controller
    on a sharded driver leaves the trajectory of an unarmed sharded driver,
    with one ring read per control epoch."""
    tparams = _tparams(_jparams())
    spec = _static_spec(epoch_windows=2)
    armed = lane2.run(RK.control_run, tparams, N_INITIAL, 7, spec, 8, 4)
    bare = lane2.run(RK.control_run, tparams, N_INITIAL, 7, spec, 8, 4, 0.0, False)
    for a, b in zip(armed, bare):
        assert a["actuations"] == 0 and a["rung"] == 0
        assert _states_equal(a["state"], b["state"])
        assert a["params"] == b["params"]
        assert a["readbacks"] - b["readbacks"] == 4  # 8 windows, an epoch of 2
    assert _states_equal(armed[0]["state"], armed[1]["state"])


def test_controller_that_actuates_on_mesh_matches_unsharded(lane2):
    """Under a 25% loss floor the default ladder climbs (its upper rungs arm
    adaptive FD, through the sharded adaptive window): rung history,
    decision log, params, adaptive planes and state equal the unsharded
    driver's."""
    tparams = _tparams(_jparams())
    spec = TC.ControlSpec(epoch_windows=1, dwell_up=1)
    res = lane2.run(RK.control_run, tparams, N_INITIAL, 7, spec, 6, 8, 0.25)
    one = RK.control_run(tparams, N_INITIAL, 7, spec, 6, 8, 0.25, sharded=False)
    assert one["rung"] >= 1 and one["actuations"] >= 1, one["history"]
    assert "ad" in one, "the climb never armed adaptive FD"
    for r, rank in enumerate(res):
        _same(one, rank, f"rank {r}")


# -- the profiler -----------------------------------------------------------------


def test_profile_ticks_on_mesh_equals_sharded_fused_window(lane2):
    tparams = _tparams(_jparams(capacity=256, full_metrics=True))
    start = TPV.init_pview_state(tparams, 64, warm=True, device="cpu")
    res = lane2.run(RK.profile_window, tparams, convert.state_to_numpy(start), 5, 3, 1)
    one, _, _ = TPV.make_pview_fused_run(tparams, 4)(start, torch.Generator().manual_seed(5))
    want = convert.state_to_numpy(one)
    for rank in res:
        assert _states_equal(rank["profiled"], rank["window"])
        assert _states_equal(rank["profiled"], want)
        r = rank["result"]
        assert r["mesh"] == {"members": 2} and r["engine"] == "pview" and r["ticks"] == 3
        assert set(r["phases_s"]) == {"rand", "fd", "suspicion", "gossip", "sync", "refute", "sweep", "alloc",
                                      "telemetry"}
        assert set(r["phases_s_max_over_ranks"]) == set(r["phases_s"])
        assert all(r["phases_s_max_over_ranks"][k] >= v for k, v in r["phases_s"].items())
        assert r["wall_s_max_over_ranks"] >= r["wall_s"]
    # rank 0's times, the same dict on every rank
    assert res[0]["result"] == res[1]["result"]


def test_profile_driver_on_mesh_leaves_the_trajectory(lane2):
    tparams = _tparams(_jparams(capacity=256, full_metrics=True))
    res = lane2.run(RK.profile_driver_run, tparams, 64, 9, 4, 4)
    d = SimDriver(tparams, 64, seed=9, device="cpu")
    d.step(8)
    want = convert.state_to_numpy(d.state)
    for rank in res:
        assert rank["result"]["mesh"] == {"members": 2} and rank["result"]["engine"] == "pview"
        assert abs(rank["result"]["phase_coverage"] - 1.0) <= 0.2, rank["result"]["phase_coverage"]
        assert _states_equal(rank["state"], want)


# -- checkpoint / restore -----------------------------------------------------------


def _counters(text: str) -> dict:
    out = {}
    for fam in parse_exposition(text):
        if fam["type"] == "counter":
            for name, _labels, value in fam["samples"]:
                out[name] = out.get(name, 0.0) + value
    return out


def test_checkpoint_restore_between_sharded_and_unsharded_drivers(lane2, tmp_path):
    """A sharded driver's archive is the unsharded driver's: it restores
    into an unsharded driver, and an unsharded driver's archive into a
    sharded one; every continuation equals the unsharded driver's, and the
    exposition's counters never fall across a restore."""
    tparams = _tparams(_jparams())
    steps = 4
    # the unsharded twin of the rank script, and its own archive
    u = SimDriver(tparams, N_INITIAL, seed=2, device="cpu")
    u.watch(3)
    u.step(steps)
    u.spread_rumor(N // 2 + 1, "x")
    u.step(steps)
    foreign = str(tmp_path / "unsharded.npz")
    u.checkpoint(foreign)
    u.step(steps)
    ahead = convert.state_to_numpy(u.state)
    u2 = SimDriver(tparams, N_INITIAL, seed=2, device="cpu")
    u2.restore(foreign)
    u2.step(steps)
    path = str(tmp_path / "sharded.npz")
    res = lane2.run(RK.checkpoint_run, tparams, N_INITIAL, 2, path, foreign, steps)
    for r, rank in enumerate(res):
        assert _states_equal(rank["ahead"], ahead), f"rank {r}: the sharded run"
        assert _states_equal(rank["again"], ahead), f"rank {r}: after its own restore"
        assert _states_equal(rank["foreign"], ahead), f"rank {r}: after the unsharded archive"
        c1, c2, c3 = (_counters(t) for t in rank["text"])
        assert {"scalecube_delivery_overflow_total", "scalecube_ring_wraps_total",
                "scalecube_ring_windows_total"} <= set(c1)
        for name in c1:
            assert c2.get(name, 0.0) >= c1[name] and c3.get(name, 0.0) >= c1[name], name
    assert res[0]["events"] == res[1]["events"]
    # the sharded driver's archive restores into an unsharded driver
    v = SimDriver(tparams, N_INITIAL, seed=2, device="cpu")
    v.restore(path)
    v.step(steps)
    assert _states_equal(convert.state_to_numpy(v.state), ahead)
    with np.load(path) as a, np.load(foreign) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k not in ("_host", "_crc32"):
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


# -- the flight dump ----------------------------------------------------------------


def test_sharded_flight_dump_carries_mesh_axes_and_replays(lane2, tmp_path):
    from scalecube_cluster_tpu_torch.replay import ReplayError, incident_from_flight
    from scalecube_cluster_tpu_torch.telemetry.flight import load_flight_dump

    tparams = _tparams(_jparams())
    scenario = TEV.Scenario(name="mesh-crash", events=[TEV.Crash(rows=[3], at=4)], horizon=24, check_interval=8)
    res = lane2.run(RK.flight_run, tparams, N_INITIAL, 21, str(tmp_path), scenario)
    docs = [load_flight_dump(rank["armed"]) for rank in res]
    for dump in docs:
        rec = dump["reconstruction"]
        assert rec["mesh_axes"] == {"members": 2}
        assert "mesh_axes" not in rec["params"]  # a sibling, never a params field
        inc = incident_from_flight(dump)
        assert inc.engine == "pview" and inc.seed == 21 and inc.params == tparams
    assert json.dumps(docs[0]["reconstruction"], sort_keys=True) == json.dumps(docs[1]["reconstruction"],
                                                                               sort_keys=True)
    # the rebuild is unsharded, and it replays: the same scenario on a
    # one-process driver gives the recorded verdict
    inc = incident_from_flight(docs[0])
    d = SimDriver(inc.params, N_INITIAL, seed=inc.seed, device="cpu")
    rep = d.run_scenario(scenario, max_window=8)
    assert docs[0]["reconstruction"]["verdict"]["ok"] == rep["ok"]
    for rank in res:
        dump = load_flight_dump(rank["partial"])
        assert not isinstance(dump.get("reconstruction"), dict)
        with pytest.raises(ReplayError, match="partial|timeline"):
            incident_from_flight(rank["partial"])
