"""``SimDriver.run_scenario`` and the adaptive driver surfaces of the
PyTorch port against the JAX package's driver.

The port's driver is fed the JAX driver's own key chain through its
``draws=`` seam, so both step the same uniforms through the same windows
(the runner splits them at event and check ticks). The reports must be
equal except the ``backend`` stamp, and so must the final state, the
adaptive planes and the member identities. Covered: a partition and its
heal on the dense engine, on sparse with dense links and on pview's group
partitions; the mixed detection-and-restart scenario; one config13 entry
per arm (N = 48, seed 0, a 10% loss floor, the script's own 260-tick
horizon). Then ``set_adaptive`` swaps and guards against the JAX driver's,
an adaptive checkpoint round trip, ``chaos_snapshot`` and the ``chaos``
section of ``health_snapshot``, armed stepping without readbacks or extra
flag reads, and ``adaptive_state`` on a static driver.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.ops.pview as JPV
import scalecube_cluster_tpu.ops.sparse as JSP
from scalecube_cluster_tpu import adaptive as JA
from scalecube_cluster_tpu.chaos import events as JEV
from scalecube_cluster_tpu.ops import state as JS
from scalecube_cluster_tpu.sim import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import adaptive as TA
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.chaos import events as TEV
from scalecube_cluster_tpu_torch.chaos.engine import DriverChaosRunner
from scalecube_cluster_tpu_torch.ops import _tensor
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.sim import SimDriver
from test_torch_dense_driver import DenseChain
from test_torch_driver import JaxChain
from test_torch_pview_fused import _assert_state_equal

torch.set_num_threads(1)

C13_KNOBS = dict(min_mult=5, max_mult=10, conf_target=4, lh_max=8)


def _dense_params(n=12, seeds=(0, 6), **over):
    return JS.SimParams(capacity=n, fanout=3, repeat_mult=2, ping_req_k=2, fd_every=2, sync_every=6,
                        suspicion_mult=2, rumor_slots=2, seed_rows=seeds, **over)


def _sparse_params(n=12, seeds=(0, 6)):
    return JSP.SparseParams(capacity=n, fanout=3, repeat_mult=2, ping_req_k=2, fd_every=2, sync_every=6,
                            suspicion_mult=2, sweep_every=2, rumor_slots=2, mr_slots=24, announce_slots=8,
                            seed_rows=seeds)


def _pview_params(n=24, seeds=(0, 12)):
    return JPV.PviewParams(capacity=n, view_slots=10, active_slots=5, fanout=3, repeat_mult=2, ping_req_k=2,
                           fd_every=2, sync_every=6, suspicion_mult=2, sweep_every=2, rumor_slots=2,
                           mr_slots=24, announce_slots=8, seed_rows=seeds)


def _split(ev, n: int, horizon: int = 200):
    half = n // 2
    return ev.Scenario(name="split-heal", events=[
        ev.Partition(groups=[range(0, half), range(half, n)], at=10, heal_at=70)], horizon=horizon,
        check_interval=8)


def _mixed(ev):
    return ev.Scenario(name="mixed-faults", events=[
        ev.Crash(rows=[4], at=3),
        ev.Partition(groups=[range(0, 6), range(6, 12)], at=30, heal_at=90),
        ev.Restart(rows=[4], at=120, seed_rows=(0,)),
        ev.LossStorm(pct=20.0, at=150, until=170),
    ], horizon=260, check_interval=8)


def _config13(ev, until: int = 220, horizon: int = 260):
    """``benchmarks/config13_adaptive.py: _scenario``, verbatim."""
    return ev.Scenario(name="loss_adversarial_r14", events=(
        ev.AsymmetricLoss(rows=[5, 6, 7], pct=70.0, at=4, until=until, direction="in"),
        ev.FlakyObserver(rows=[9], pct=70.0, at=4, until=until),
        ev.SlowMember(rows=[11], mean_delay_ticks=2.0, at=4, until=until),
        ev.Crash(rows=[20], at=30),
    ), horizon=horizon)


def _pair(jparams, n: int, seed: int, chain_cls, **kw):
    tparams = convert.params_from_dict(dataclasses.asdict(jparams))
    jd = JSimDriver(jparams, n, warm=True, seed=seed, **kw)
    td = SimDriver(tparams, n, warm=True, seed=seed, device="cpu", draws=chain_cls(seed, jparams), **kw)
    return jd, td


def _assert_same_run(jd, td, jrep, trep, label):
    jrep, trep = dict(jrep), dict(trep)
    assert trep.pop("backend") == "cpu" and jrep.pop("backend")
    assert trep == jrep, f"{label}: reports differ"
    _assert_state_equal(jd.state, td.state, f"{label}: final state")
    assert (td.adaptive_state is None) == (jd.adaptive_state is None), label
    if td.adaptive_state is not None:
        for k in ("lh", "conf_key", "conf"):
            assert np.array_equal(getattr(td.adaptive_state, k).numpy(),
                                  np.asarray(getattr(jd.adaptive_state, k))), f"{label}: adaptive plane {k}"
    assert {r: m.id for r, m in td.members.items()} == {r: m.id for r, m in jd.members.items()}, label


CASES = {
    "dense-partition": (lambda: _dense_params(), 12, DenseChain, {}, _split),
    "sparse-partition": (lambda: _sparse_params(), 12, JaxChain, {"dense_links": True}, _split),
    "pview-group-partition": (lambda: _pview_params(), 24, JaxChain, {}, _split),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_and_heal_match_jax(case):
    make, n, chain, kw, build = CASES[case]
    jd, td = _pair(make(), n, 0, chain, **kw)
    jrep = jd.run_scenario(build(JEV, n))
    base = td.dispatch_stats["readbacks"]
    trep = td.run_scenario(build(TEV, n))
    # the report is the one readback of the whole scenario
    assert td.dispatch_stats["readbacks"] == base + 1
    _assert_same_run(jd, td, jrep, trep, case)
    assert trep["ok"] and trep["violations"] == 0, trep
    conv = trep["sentinels"]["convergence"]
    assert len(conv) == 1 and conv[0]["converged_at"] is not None
    assert [e["event"] for e in trep["events_applied"]] == ["partition@10", "heal@70"]


def test_mixed_detection_and_restart_match_jax():
    jd, td = _pair(_dense_params(), 12, 0, DenseChain)
    before = td.members[4].id
    jrep, trep = jd.run_scenario(_mixed(JEV)), td.run_scenario(_mixed(TEV))
    _assert_same_run(jd, td, jrep, trep, "mixed")
    assert trep["ok"], trep
    det = trep["sentinels"]["detections"]
    assert len(det) == 1 and det[0]["row"] == 4 and det[0]["detected_at"] <= det[0]["deadline"]
    assert td.members[4].id != before  # a restart is a new member identity


def _config13_case(seed: int, floor: float, arm: str):
    """One entry of ``benchmarks/config13_adaptive.py`` (its params, loss
    floor, scenario and horizon) on both drivers; returns the port's
    report."""
    spec = dict(enabled=True, **C13_KNOBS) if arm == "adaptive" else {}
    jparams = JS.SimParams(capacity=48, fd_every=1, sync_every=40, suspicion_mult=3, rumor_slots=8,
                           seed_rows=(0,), delay_slots=4, adaptive=JA.AdaptiveSpec(**spec))
    jd, td = _pair(jparams, 48, seed, DenseChain)
    if floor > 0:
        jd.state = jd._ops.set_uniform_loss(jd.state, floor, floor=True)
        td.state = td._ops.set_uniform_loss(td.state, floor, floor=True)
    jscn, tscn = _config13(JEV), _config13(TEV)
    if arm == "static":
        jscn, tscn = jscn.replace(fp_enforce=False), tscn.replace(fp_enforce=False)
    jrep, trep = jd.run_scenario(jscn), td.run_scenario(tscn)
    _assert_same_run(jd, td, jrep, trep, f"config13 seed {seed}, floor {floor}, {arm}")
    s = trep["sentinels"]
    assert s["detections"][0]["deadline"] == 146 and s["false_positive_watch_members"] == 5
    if arm == "adaptive":
        assert s["false_positive_dead_max"] == 0 and trep["violations"] == 0
    return trep


@pytest.mark.parametrize("arm", ["static", "adaptive"])
def test_config13_entry_matches_jax(arm):
    """One entry of config13 per arm: seed 0, a 10% loss floor."""
    rep = _config13_case(0, 0.1, arm)
    s = rep["sentinels"]
    det = s["detections"][0]
    assert det["ok"] and rep["violations"] == 0
    if arm == "adaptive":
        assert s["false_positive_enforced"]
        assert det["detected_at"] == 87  # ADAPTIVE_BENCH_r14.json's entries
    else:
        assert s["false_positive_dead_max"] >= 1 and not s["false_positive_enforced"]
        assert det["detected_at"] == 58


@pytest.mark.slow
@pytest.mark.parametrize("arm", ["static", "adaptive"])
@pytest.mark.parametrize("floor", [0.0, 0.1, 0.2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_config13_sweep_matches_jax(seed, floor, arm):
    """config13's whole 3 × 3 sweep, both arms, against the JAX driver."""
    _config13_case(seed, floor, arm)


ASPEC = dict(enabled=True, lh_max=4, min_mult=2, max_mult=6, conf_target=3)


def _compare_planes(jd, td, label):
    _assert_state_equal(jd.state, td.state, label)
    assert td.params.adaptive == TA.AdaptiveSpec(**dataclasses.asdict(jd.params.adaptive)), label
    if jd.adaptive_state is None:
        assert td.adaptive_state is None, label
        return
    for k in ("lh", "conf_key", "conf"):
        assert np.array_equal(getattr(td.adaptive_state, k).numpy(), np.asarray(getattr(jd.adaptive_state, k))), \
            f"{label}: {k}"


def test_set_adaptive_swaps_and_guards_match_jax():
    jd, td = _pair(_dense_params(n=16, seeds=(0,), delay_slots=3), 16, 1, DenseChain)
    for d in (jd, td):
        assert d.adaptive_state is None
        d.set_link_loss(range(8), range(8, 16), 0.6)
    script = [
        ("arm", lambda d, m: d.set_adaptive(m.AdaptiveSpec(**ASPEC))),
        ("same spec: a no-op", lambda d, m: d.set_adaptive(m.AdaptiveSpec(**ASPEC))),
        ("knob override", lambda d, m: d.set_adaptive(lh_max=2)),
        ("disarm", lambda d, m: d.set_adaptive(None)),
        ("arm by override", lambda d, m: d.set_adaptive(enabled=True, conf_target=2)),
    ]
    for label, swap in script:
        ad_before = td.adaptive_state
        swap(jd, JA)
        swap(td, TA)
        if label.startswith("same"):
            assert td.adaptive_state is ad_before  # the planes carry on
        for d in (jd, td):
            d.step(6)
        _compare_planes(jd, td, label)
    assert td.adaptive_state is not None and int(td.adaptive_state.lh.max()) > 0
    for bad in (dict(lh_max=-1), dict(min_mult=9, max_mult=3)):
        with pytest.raises(ValueError):
            jd.set_adaptive(**bad)
        with pytest.raises(ValueError):
            td.set_adaptive(**bad)
    _compare_planes(jd, td, "after the refused swaps")


def test_adaptive_checkpoint_round_trips(tmp_path):
    n = 24
    params = TS.SimParams(capacity=n, fanout=3, ping_req_k=2, fd_every=2, sync_every=10, suspicion_mult=2,
                          rumor_slots=8, seed_rows=(0,), delay_slots=3, adaptive=TA.AdaptiveSpec(**ASPEC))
    d = SimDriver(params, n, warm=True, seed=3, device="cpu")
    d.set_link_loss(range(12), range(12, 24), 0.6)
    d.step(16)
    d.crash(7)
    d.step(16)
    lh1 = d.adaptive_state.lh.clone()
    assert int(lh1.max()) > 0
    ck = str(tmp_path / "a.npz")
    d.checkpoint(ck)
    d.step(8)
    d2 = SimDriver(params, n, warm=True, seed=3, device="cpu")
    d2.restore(ck)
    assert torch.equal(d2.adaptive_state.lh, lh1)
    d2.step(8)
    assert torch.equal(d2.state.view_key, d.state.view_key)
    for k in ("lh", "conf_key", "conf"):
        assert torch.equal(getattr(d2.adaptive_state, k), getattr(d.adaptive_state, k)), k
    # a static driver ignores the planes; an adaptive one restoring a static
    # checkpoint starts them fresh
    static = SimDriver(dataclasses.replace(params, adaptive=TA.AdaptiveSpec()), n, warm=True, seed=3, device="cpu")
    static.restore(ck)
    assert static.adaptive_state is None and static.state.tick == 32
    ck2 = str(tmp_path / "s.npz")
    static.checkpoint(ck2)
    d2.restore(ck2)
    assert int(d2.adaptive_state.lh.abs().sum()) == 0 and int(d2.adaptive_state.conf.sum()) == 0


def test_chaos_snapshot_and_health_section():
    n = 12
    d = SimDriver(convert.params_from_dict(dataclasses.asdict(_dense_params())), n, warm=True, seed=0,
                  device="cpu")
    assert d.chaos_snapshot() == {"armed": False}
    assert "chaos" not in d.health_snapshot()
    scn = TEV.Scenario(name="crash", events=[TEV.Crash(rows=[4], at=2)], horizon=48, check_interval=8)
    runner = DriverChaosRunner(d, scn)
    live = d.health_snapshot()["chaos"]
    assert live["armed"] is True and live["ticks_run"] == 0 and live["scenario"] == "crash"
    assert d.chaos_snapshot()["sentinels"]["detections"][0]["detected_at"] is None
    rep = runner.run()
    snap = d.chaos_snapshot()
    assert snap == rep and snap["armed"] is False and d.health_snapshot()["chaos"] == rep
    assert rep["ok"] and rep["ticks_run"] == 48 and rep["tick_range"] == [0, 48]


def test_armed_stepping_reads_nothing_back():
    """Between arming and the report the driver reads nothing back, and
    the tick reads no more branch flags than the same windows unarmed."""
    n = 12
    tparams = convert.params_from_dict(dataclasses.asdict(_dense_params()))
    scn = TEV.Scenario(name="busy", events=[
        TEV.Crash(rows=[4], at=3), TEV.Partition(groups=[range(0, 6), range(6, 12)], at=9, heal_at=30),
        TEV.LossStorm(pct=20.0, at=40, until=50)], horizon=96, check_interval=8)
    armed = SimDriver(tparams, n, warm=True, seed=0, device="cpu")
    runner = DriverChaosRunner(armed, scn)
    base, flags = armed.dispatch_stats["readbacks"], _tensor.HOST_SYNCS.count
    # the runner's own loop, without its final report
    stops = sorted({0, *runner.timeline.boundaries(), *range(0, 97, runner.spec.check_interval), 96})
    t = 0
    for stop in stops[1:]:
        armed.state, _labels = runner.timeline.apply_due(armed.state, t)
        runner._run_check()
        armed.step(stop - t)
        t = stop
    assert armed.dispatch_stats["readbacks"] == base, "armed stepping read the device"
    armed_flags = _tensor.HOST_SYNCS.count - flags
    plain = SimDriver(tparams, n, warm=True, seed=0, device="cpu")
    flags = _tensor.HOST_SYNCS.count
    t = 0
    for stop in stops[1:]:
        plain.step(stop - t)
        t = stop
    assert armed_flags == _tensor.HOST_SYNCS.count - flags == 96  # one flag read per dense tick
    rep = runner.report()
    assert armed.dispatch_stats["readbacks"] == base + 1 and rep["ticks_run"] == 0


def test_static_driver_has_no_adaptive_state():
    for params in (_dense_params(), _sparse_params(), _pview_params()):
        d = SimDriver(convert.params_from_dict(dataclasses.asdict(params)), params.capacity, device="cpu")
        assert d.adaptive_state is None
        d.set_adaptive(None)  # disarming a static driver is a no-op
        assert d.adaptive_state is None and d.params.adaptive.is_default
