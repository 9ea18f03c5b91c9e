"""The PyTorch port's chaos plane (``chaos/``) against the JAX package's,
without a driver: ``schedule()`` for every event kind, ``StateTimeline``
on each engine (the state after every applied action equals the JAX
timeline's, a loss storm with a mid-storm partition heal included), the
storm stash's independence from later in-place writes, the scenarios the
JAX package refuses, the sentinel plan (``build_spec``) and report, and
each engine's ``sentinel_init`` / ``sentinel_reduce`` on the same states
(a seeded false-DEAD tombstone and a seeded false positive both caught).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu.chaos import engine as JE
from scalecube_cluster_tpu.chaos import events as JEV
from scalecube_cluster_tpu.chaos import sentinels as JSN
from scalecube_cluster_tpu.ops import engine_api as jengine_api
from scalecube_cluster_tpu.ops import kernel as JK
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu_torch import chaos as TCH
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.chaos import engine as TE
from scalecube_cluster_tpu_torch.chaos import events as TEV
from scalecube_cluster_tpu_torch.chaos import sentinels as TSN
from scalecube_cluster_tpu_torch.ops import engine_api
from scalecube_cluster_tpu_torch.ops import pview as TPV
from scalecube_cluster_tpu_torch.ops import sparse as TSP
from scalecube_cluster_tpu_torch.ops import state as TS
from test_torch_pview_fused import _assert_state_equal

torch.set_num_threads(1)

N = 24
A, B = list(range(0, 12)), list(range(12, 24))


def _block_scenario(ev):
    """Block-plane events: a partition healed inside a loss storm, a flap,
    a crash and its restart, a zone outage, a refute drop, a churn storm."""
    return ev.Scenario(name="blocks", events=(
        ev.LossStorm(pct=30.0, at=2, until=12),
        ev.Partition(groups=[A, B], at=4, heal_at=8),
        ev.Crash(rows=[5], at=3),
        ev.Restart(rows=[5], at=10, seed_rows=(0,)),
        ev.LinkFlap(pairs=[(1, 2), (3, 20)], at=14, period=2, until=19),
        ev.ZoneOutage(rows=[8, 9], at=20, until=23),
        ev.DroppedRefute(rows=[3], at=24, until=27),
        ev.ChurnStorm(rows=[15, 16, 17, 18], at=28, waves=2, period=4, down_for=2),
    ), horizon=60)


def _degraded_scenario(ev):
    """The loss-adversarial family: asymmetric inbound loss, a flaky
    observer, a slow member, then a slow epoch; a storm over the asym."""
    return ev.Scenario(name="degraded", events=(
        ev.AsymmetricLoss(rows=[4, 5], pct=70.0, at=2, until=10, direction="in"),
        ev.FlakyObserver(rows=[9], pct=60.0, at=3, until=9),
        ev.SlowMember(rows=[11], mean_delay_ticks=2.0, at=2, until=12),
        ev.LossStorm(pct=20.0, at=5, until=8),
        ev.SlowEpoch(mean_delay_ticks=1.5, at=14, until=18),
        ev.Crash(rows=[20], at=6),
    ), horizon=40)


def _group_scenario(ev):
    """What the pview engine runs: group partitions, storms, crashes,
    restarts."""
    return ev.Scenario(name="groups", events=(
        ev.Partition(groups=[A, B], at=2, heal_at=9),
        ev.LossStorm(pct=25.0, at=5, until=12),
        ev.Crash(rows=[3, 13], at=4),
        ev.Restart(rows=[3], at=14, seed_rows=(0,)),
        ev.ChurnStorm(rows=[20, 21], at=16, waves=2, period=4, down_for=2),
    ), horizon=40)


def _steps(steps):
    return [(s.tick, s.seq, s.kind, s.label, s.payload) for s in steps]


@pytest.mark.parametrize("build", [_block_scenario, _degraded_scenario, _group_scenario])
def test_schedule_matches_jax_for_every_event_kind(build):
    js, ts = build(JEV), build(TEV)
    assert _steps(TE.schedule(ts)) == _steps(JE.schedule(js))
    assert TE.schedule(ts, horizon=30) and ts.last_event_tick() == js.last_event_tick()
    assert ts.fault_touched_rows(N, 50.0) == js.fault_touched_rows(N, 50.0)
    assert ts.degraded_rows() == js.degraded_rows()


def test_schedule_covers_every_action_kind():
    kinds = {s.kind for b in (_block_scenario, _degraded_scenario) for s in TE.schedule(b(TEV))}
    assert kinds == {
        "partition_block", "partition_heal", "storm_start", "storm_end", "flap_down", "flap_up", "crash",
        "restart", "zone_down", "zone_up", "refute_drop", "slow_start", "slow_end", "asym_start", "asym_end",
        "slow_epoch_start", "slow_epoch_end",
    }


def _dense_pair(delay: bool):
    params = JS.SimParams(capacity=N, fanout=2, fd_every=2, sync_every=6, rumor_slots=2, seed_rows=(0,),
                          delay_slots=3 if delay else 0)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = JS.init_state(params, N - 2, uniform_loss=0.05)
    tst = TS.init_state(tparams, N - 2, uniform_loss=0.05, device="cpu")
    return jst, tst


def _sparse_pair():
    params = JSP.SparseParams(capacity=N, fanout=2, fd_every=2, sync_every=6, rumor_slots=2, mr_slots=16,
                              announce_slots=8, seed_rows=(0,))
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jst = JSP.init_sparse_state(params, N - 2, dense_links=True, uniform_loss=0.05)
    tst = TSP.init_sparse_state(tparams, N - 2, dense_links=True, uniform_loss=0.05, device="cpu")
    return jst, tst


def _pview_pair():
    params = JPV.PviewParams(capacity=N, view_slots=8, active_slots=4, mr_slots=16, announce_slots=8,
                             seed_rows=(0,))
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    return JPV.init_pview_state(params, N - 2), TPV.init_pview_state(tparams, N - 2, device="cpu")


CASES = {
    "dense-blocks": (JS, TS, lambda: _dense_pair(False), _block_scenario),
    "dense-degraded": (JS, TS, lambda: _dense_pair(True), _degraded_scenario),
    "sparse-blocks": (JSP, TSP, _sparse_pair, lambda ev: ev.Scenario(
        name="sparse-blocks", events=[e for e in _block_scenario(ev).events
                                      if not isinstance(e, ev.DroppedRefute)], horizon=60)),
    "pview-groups": (JPV, TPV, _pview_pair, _group_scenario),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_timeline_matches_jax_after_each_action(case):
    jmod, tmod, pair, build = CASES[case]
    jst, tst = pair()
    jtl = JE.StateTimeline(build(JEV), jmod, dense_links=jst.loss.ndim != 0)
    ttl = TE.StateTimeline(build(TEV), tmod, dense_links=tst.loss.dim() != 0)
    assert ttl.boundaries() == jtl.boundaries()
    applied = 0
    for t in range(45):
        jst, jl = jtl.apply_due(jst, t)
        tst, tl = ttl.apply_due(tst, t)
        assert tl == jl, t
        applied += len(tl)
        _assert_state_equal(jst, tst, f"{case}: after the actions due at {t}: {tl}")
        assert (ttl._storm_stash is None) == (jtl._storm_stash is None)
    assert applied == len(TE.schedule(build(TEV))) and ttl.next_tick() is None


def test_mid_storm_heal_keeps_storm_floor():
    """A heal landing inside a loss storm clears the block only down to the
    storm floor; the full clear replays at storm end (as in JAX)."""
    params = TS.SimParams(capacity=8, fanout=2, fd_every=2, sync_every=6, rumor_slots=2, seed_rows=(0,))
    st = TS.init_state(params, 8, device="cpu")
    scn = TEV.Scenario(name="storm-heal", events=[
        TEV.LossStorm(pct=40.0, at=0, until=20),
        TEV.Partition(groups=[[0, 1, 2, 3], [4, 5, 6, 7]], at=5, heal_at=10),
    ], horizon=30)
    tl = TE.StateTimeline(scn, TS, dense_links=True)
    st, _ = tl.apply_due(st, 5)
    assert float(st.loss[0, 4]) == 1.0 and st.loss[0, 1] == np.float32(0.4)
    st, _ = tl.apply_due(st, 10)
    assert st.loss[0, 4] == np.float32(0.4), "the heal punched a hole in the storm"
    assert st.fetch_rt[0, 4] == np.float32(0.6) * np.float32(0.6)
    st, _ = tl.apply_due(st, 20)
    assert (st.loss == 0.0).all() and (st.fetch_rt == 1.0).all()


def test_storm_stash_is_independent_of_later_in_place_writes():
    params = TS.SimParams(capacity=8, fanout=2, rumor_slots=2, seed_rows=(0,))
    st = TS.init_state(params, 8, uniform_loss=0.1, device="cpu")
    scn = TEV.Scenario(name="storm", events=[TEV.LossStorm(pct=50.0, at=1, until=4)], horizon=10)
    tl = TE.StateTimeline(scn, TS, dense_links=True)
    before = st.loss.clone()
    st, _ = tl.apply_due(st, 1)
    stash = tl._storm_stash
    assert stash.data_ptr() != st.loss.data_ptr() and torch.equal(stash, before)
    # the mutators write the live plane in place; the stash must not follow
    st = TS.set_link_loss(st, [0], [1, 2], 0.9)
    st = TS.set_uniform_loss(st, 0.7, floor=True)
    assert torch.equal(tl._storm_stash, before)
    st, _ = tl.apply_due(st, 4)
    assert torch.equal(st.loss, before)
    # a scalar plane goes back through set_uniform_loss as a 0-d tensor
    lean = TS.init_state(params, 8, uniform_loss=0.1, dense_links=False, device="cpu")
    tl2 = TE.StateTimeline(scn, TS, dense_links=False)
    lean, _ = tl2.apply_due(lean, 1)
    assert lean.loss == np.float32(0.5) and tl2._storm_stash == np.float32(0.1)
    lean, _ = tl2.apply_due(lean, 4)
    assert lean.loss.dim() == 0 and lean.loss == np.float32(0.1)


def test_scenarios_the_jax_package_refuses_are_refused():
    drop = TEV.Scenario(name="drop", events=[TEV.DroppedRefute(rows=[3], at=1, until=4)], horizon=10)
    for mod in (TSP, TPV):
        with pytest.raises(TEV.ScenarioError, match="DroppedRefute"):
            TE.StateTimeline(drop, mod, dense_links=True)
        with pytest.raises(JEV.ScenarioError, match="DroppedRefute"):
            JE.StateTimeline(JEV.Scenario(name="drop", events=[JEV.DroppedRefute(rows=[3], at=1, until=4)],
                                          horizon=10), {TSP: JSP, TPV: JPV}[mod], dense_links=True)
    TE.StateTimeline(drop, TS, dense_links=True)  # dense has drop_refutes
    flap = TEV.Scenario(name="flap", events=[TEV.LinkFlap(pairs=[(1, 2)], period=2, at=0, until=8)])
    asym = TEV.Scenario(name="asym", events=[TEV.AsymmetricLoss(rows=[2], pct=50.0, at=1, until=5)])
    part = TEV.Scenario(name="part", events=[TEV.Partition(groups=[[0], [1]], at=1, heal_at=5)])
    for scn, match in ((flap, "per-link"), (asym, "loss-adversarial"), (part, "per-link")):
        with pytest.raises(TEV.ScenarioError, match=match):
            TE.StateTimeline(scn, TSP, dense_links=False)
    TE.StateTimeline(part, TPV, dense_links=False)  # pview's group partitions
    with pytest.raises(TEV.ScenarioError, match="per-link"):
        TE.StateTimeline(flap, TPV, dense_links=False)
    params = TS.SimParams(capacity=12)
    for scn in (TEV.Scenario(name="oob", events=[TEV.Crash(rows=[12], at=2)]),
                TEV.Scenario(name="oob-group", events=[TEV.Partition(groups=[[0], [99]], at=1, heal_at=5)])):
        with pytest.raises(TEV.ScenarioError, match="outside"):
            TSN.build_spec(scn, params)
    with pytest.raises(TEV.ScenarioError, match="overlap"):
        TE.schedule(TEV.Scenario(name="x", events=[
            TEV.AsymmetricLoss(rows=[2], pct=50.0, at=1, until=5),
            TEV.Partition(groups=[[0], [1]], at=2, heal_at=6)]))
    # the emulator runner refuses what JAX's refuses (tests/test_torch_scalar.py
    # holds its replay against JAX's)
    with pytest.raises(TEV.ScenarioError, match="DroppedRefute"):
        TCH.EmulatorChaosRunner(drop, [None] * 16, [f"a{i}" for i in range(16)])


def _spec_dicts(spec):
    out = dataclasses.asdict(spec)
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in out.items()}


@pytest.mark.parametrize("build", [_block_scenario, _degraded_scenario, _group_scenario])
def test_build_spec_and_report_match_jax(build):
    jparams = JS.SimParams(capacity=N, fd_every=2, sync_every=6, rumor_slots=2, seed_rows=(0,))
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jspec = JSN.build_spec(build(JEV), jparams)
    tspec = TSN.build_spec(build(TEV), tparams)
    assert _spec_dicts(tspec) == _spec_dicts(jspec)
    rng = np.random.default_rng(3)
    host = {
        "detect_tick": rng.integers(-1, 80, len(tspec.crash_rows)).astype(np.int32),
        "conv_tick": rng.integers(-1, 200, len(tspec.conv_from)).astype(np.int32),
        "false_dead_max": np.int32(0), "key_regressions": np.int32(0), "fp_dead_max": np.int32(1),
        "n_live_drift": np.int32(0),
    }
    for final in (10, 100, 10_000):
        assert TSN.sentinel_report(host, tspec, final) == JSN.sentinel_report(host, jspec, final)
    dev = tspec.device_arrays(t0=7, device="cpu")
    jdev = jspec.device_arrays(t0=7)
    assert set(dev) == set(jdev) and dev["t0"] == 7
    for k in set(dev) - {"t0"}:
        assert dev[k].device.type == "cpu" and np.array_equal(dev[k].numpy(), np.asarray(jdev[k])), k


# -- each engine's sentinel reductions on the same states --------------------------


def _busy_states(engine: str):
    """A few JAX states of one engine after crashes and suspicion (the
    port's copies come from their snapshots)."""
    if engine == "dense":
        params = JS.SimParams(capacity=N, fanout=2, ping_req_k=1, fd_every=1, sync_every=6, suspicion_mult=1,
                              rumor_slots=2, seed_rows=(0,))
        st = JS.init_state(params, N - 2, uniform_loss=0.2)
        run = JK.make_run(params, 6, donate=False)
        mod = JS
    elif engine == "sparse":
        params = JSP.SparseParams(capacity=N, fanout=2, ping_req_k=1, fd_every=1, sync_every=6,
                                  suspicion_mult=1, sweep_every=2, rumor_slots=2, mr_slots=16,
                                  announce_slots=8, seed_rows=(0,))
        st = JSP.init_sparse_state(params, N - 2, dense_links=True, uniform_loss=0.2)
        run = JSP.make_sparse_run(params, 6, donate=False)
        mod = JSP
    else:
        params = JPV.PviewParams(capacity=N, view_slots=8, active_slots=4, fanout=2, ping_req_k=1, fd_every=1,
                                 sync_every=6, suspicion_mult=1, sweep_every=2, mr_slots=16, announce_slots=8,
                                 seed_rows=(0,))
        st = JPV.init_pview_state(params, N - 2, uniform_loss=0.2)
        run = JPV.make_pview_run(params, 6, donate=False)
        mod = JPV
    st = mod.crash_rows(st, [4, 13])
    key = jax.random.PRNGKey(2)
    states = [st]
    for _ in range(5):
        st, key, _ms, _w = run(st, key)
        states.append(st)
    return params, mod, states


SENT_SCENARIO = dict(events=lambda ev: (
    ev.Crash(rows=[4, 13], at=0), ev.Partition(groups=[[10, 11], [22, 23]], at=3, heal_at=9),
    ev.LossStorm(pct=20.0, at=12, until=20)), fp_watch_rows=(2,), horizon=40)


def _snapshot(engine, st):
    return {"dense": JS, "sparse": JSP, "pview": JPV}[engine].snapshot(st)


@pytest.mark.parametrize("engine", ["dense", "sparse", "pview"])
def test_sentinel_reductions_match_jax(engine):
    params, _mod, states = _busy_states(engine)
    tparams = convert.params_from_dict(dataclasses.asdict(params))
    jscn = JEV.Scenario(name="s", events=SENT_SCENARIO["events"](JEV), fp_watch_rows=(2,), horizon=40)
    tscn = TEV.Scenario(name="s", events=SENT_SCENARIO["events"](TEV), fp_watch_rows=(2,), horizon=40)
    jspec, tspec = JSN.build_spec(jscn, params), TSN.build_spec(tscn, tparams)
    jeng, teng = jengine_api.resolve(params), engine_api.resolve(tparams)
    t0 = int(states[0].tick)
    tst0 = convert.state_from_numpy(_snapshot(engine, states[0]), device="cpu")
    jsent, tsent = jeng.sentinel_init(states[0], jspec), teng.sentinel_init(tst0, tspec)
    jdev, tdev = jspec.device_arrays(t0), tspec.device_arrays(t0, device="cpu")
    assert set(tsent) == set(jsent)
    for k, st in enumerate(states):
        if k == 3:
            # a forged DEAD record about a never-faulted member, and one
            # about the watched (degraded but alive) member
            st = _forge_dead(engine, st, observer=0, subjects=(9, 2))
        tst = convert.state_from_numpy(_snapshot(engine, st), device="cpu")
        jsent = jeng.sentinel_reduce(st, jsent, jdev)
        tsent = teng.sentinel_reduce(tst, tsent, tdev)
        assert set(tsent) == set(jsent)
        for name, v in jsent.items():
            g, v = tsent[name].numpy(), np.asarray(v)
            assert g.dtype == v.dtype and np.array_equal(g, v), f"{engine}, check {k}: {name}"
    host = {k: v.numpy() for k, v in tsent.items()}
    rep = TSN.sentinel_report(host, tspec, final_tick=40)
    assert rep["false_dead_members_max"] >= 1, "the forged tombstone was not caught"
    assert rep["false_positive_dead_max"] >= 1, "the forged false positive was not caught"
    assert not rep["ok"] and rep == JSN.sentinel_report({k: np.asarray(v) for k, v in jsent.items()}, jspec, 40)


def _forge_dead(engine, st, observer: int, subjects):
    if engine == "pview":
        ids = np.asarray(st.nbr_id).copy()
        keys = np.asarray(st.nbr_key).copy()
        for slot, subj in enumerate(subjects):
            ids[observer, slot] = subj
            keys[observer, slot] = 3
        return st.replace(nbr_id=jnp.asarray(ids), nbr_key=jnp.asarray(keys))
    vk = st.view_key
    for subj in subjects:
        vk = vk.at[observer, subj].set((5 << 2) | 3)
    return st.replace(view_key=vk)
