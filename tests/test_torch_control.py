"""The closed-loop control plane of the PyTorch port against the JAX
package's, on the CPU.

* the host policy (``target_rung``, ``advance``, ``sensors_from_window``,
  the spec checks) against JAX's on the JAX package's own cases
  (``tests/test_control.py``): every returned rung and every controller
  state after every epoch, exactly (the policy reads host floats only);
* an armed but idle driver is bit-identical to an unarmed one, with one
  readback per control epoch;
* a dense driver under loss climbs the ladder: its decision log, its
  applied knobs, its adaptive planes and its state equal the JAX driver's
  on the same key chain (the port fed the JAX chain with the driver's own
  current params, whose fanout the controller sets);
* ``set_protocol_knobs``: validation and the no-op; the ``control_state``
  checkpoint round trip; the exclusions and the falsifiability refusal;
* ``run_controlled_fleet`` (n = 48, 8 seeds, every arm, the JAX fleet's
  per-row key chains) gives JAX's record — every per-seed fold summed
  into it: SLO counts, failures by kind, false-DEAD scenarios, detection
  latencies, cost, spread statistics, actuations, knob changes and the
  decision log tail;
* ``certify_controller_mc``'s verdict and intervals at 8 seeds.

The miss and suspect rates come from exact counts, so every decision
must match exactly. One driver arms the spread-lag gate, whose f32
``spread_lag`` series is held to 2 ulp: its rung history equals JAX's and
no reading comes within 2 ulp of the gate.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import scalecube_cluster_tpu.control as JC
import scalecube_cluster_tpu.ops.state as JS
from scalecube_cluster_tpu.chaos import shifting as JSH
from scalecube_cluster_tpu.ops import fleet as JFL
from scalecube_cluster_tpu.sim.driver import SimDriver as JSimDriver
from scalecube_cluster_tpu_torch import control as TC
from scalecube_cluster_tpu_torch import convert
from scalecube_cluster_tpu_torch.chaos import shifting as TSH
from scalecube_cluster_tpu_torch.ops import state as TS
from scalecube_cluster_tpu_torch.sim.driver import SimDriver
from test_torch_dense import dense_draws
from test_torch_fleet import FleetChain

torch.set_num_threads(1)


# -- 1. the host policy against JAX's -------------------------------------------


def _sense(miss, suspect=0.0):
    return {"miss_rate": miss, "suspect_rate": suspect, "probes": 1000.0}


#: (spec fields, initial controller state fields, sensor sequence) — the
#: JAX package's own policy cases, run through both packages
POLICY_CASES = {
    "dwell_up_clamped": ({"dwell_up": 2, "max_step": 1}, {}, [_sense(0.10)] * 4),
    "dwell_down_hysteresis": (
        {"dwell_up": 1, "dwell_down": 3}, {"rung": 2, "actuated": True},
        [_sense(0.0)] * 2 + [_sense(0.10)] + [_sense(0.0)] * 3,
    ),
    "dropout": ({"dwell_up": 1}, {"rung": 2, "actuated": True}, [None, _sense(0.0), None, _sense(0.0)]),
    "blind": ({"blind": True, "dwell_up": 1}, {}, [_sense(0.25)] * 6),
    "unclamped": ({"clamped": False}, {}, [_sense(0.08), _sense(0.05), _sense(0.05), _sense(0.0)]),
    "suspect_gate_off": ({}, {}, [_sense(0.0, 0.9)] * 8),
    "suspect_gate_on": (
        {"suspect_gate": 0.5, "dwell_up": 2, "dwell_down": 4}, {},
        [_sense(0.0, 0.8), _sense(0.0, 0.0), _sense(0.0, 0.8), _sense(0.0, 0.8)]
        + [_sense(0.0, 0.0)] * 3 + [_sense(0.0, 0.8)],
    ),
    "spread_lag_gate": (
        {"spread_lag_gate": 0.2, "dwell_up": 1},
        {}, [{**_sense(0.0), "spread_lag": 0.3}] * 3 + [{**_sense(0.0), "spread_lag": 0.0}] * 5,
    ),
    "hysteresis_band": ({"dwell_up": 1, "dwell_down": 1}, {}, [_sense(x) for x in (0.08, 0.045, 0.035, 0.01, 0.0)]),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_advance_matches_jax(case):
    spec_kw, st_kw, seq = POLICY_CASES[case]
    jspec, tspec = JC.ControlSpec(**spec_kw), TC.ControlSpec(**spec_kw)
    jst, tst = JC.ControllerState(**st_kw), TC.ControllerState(**st_kw)
    for i, sensors in enumerate(seq):
        jr = JC.advance(jspec, jst, sensors, tick=8 * i)
        tr = TC.advance(tspec, tst, sensors, tick=8 * i)
        assert (jr is None) == (tr is None), (case, i)
        if jr is not None:
            assert jr.as_dict() == tr.as_dict(), (case, i)
        assert jst.state_dict() == tst.state_dict(), (case, i)
    assert jst.log, case


def test_target_rung_and_sensors_match_jax():
    for cur in range(3):
        for miss in np.linspace(0.0, 0.2, 81):
            assert JC.target_rung(JC.ControlSpec(), float(miss), cur) == TC.target_rung(
                TC.ControlSpec(), float(miss), cur)
    for sums in ({}, {"fd_probes": 400.0, "fd_failed_probes": 20.0, "fd_new_suspects": 4.0},
                 {"fd_probes": 9.0, "fd_failed_probes": 3.0, "alive_view_fraction": 0.5,
                  "convergence_lag": 0.5}):
        assert JC.sensors_from_window(sums) == TC.sensors_from_window(sums)
    assert [r.as_dict() for r in JC.DEFAULT_LADDER] == [r.as_dict() for r in TC.DEFAULT_LADDER]
    assert dataclasses.asdict(JC.DEFAULT_SLO) == dataclasses.asdict(TC.DEFAULT_SLO)


@pytest.mark.parametrize("kw", [
    {"ladder": (TC.DEFAULT_LADDER[0],)}, {"ladder": (TC.DEFAULT_LADDER[1], TC.DEFAULT_LADDER[2])},
    {"hysteresis": 0.0}, {"epoch_windows": 0}, {"dwell_up": 0}, {"max_step": 0},
    {"suspect_gate": -0.1}, {"spread_lag_gate": -0.1},
])
def test_spec_validation_matches_jax(kw):
    jkw = dict(kw)
    if "ladder" in jkw:
        jkw["ladder"] = tuple(JC.Rung(**r.as_dict()) for r in kw["ladder"])
    with pytest.raises(ValueError) as jerr:
        JC.ControlSpec(**jkw)
    with pytest.raises(ValueError) as terr:
        TC.ControlSpec(**kw)
    assert str(jerr.value) == str(terr.value)


# -- 2. the driver-attached plane ------------------------------------------------

N = 24


def _jparams():
    return JS.SimParams(capacity=N, fd_every=1, sync_every=40, rumor_slots=8, seed_rows=(0,), full_metrics=False)


def _tdriver(seed=7, **kw):
    tparams = convert.params_from_dict(dataclasses.asdict(_jparams()))
    return SimDriver(tparams, N, seed=seed, device="cpu", **kw)


class DriverChain:
    """The JAX driver's key chain replayed as dense draws with the port
    driver's CURRENT params (the controller swaps its fanout)."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.driver = None

    def __call__(self, n_ticks: int):
        self.key, draws = dense_draws(self.key, n_ticks, self.driver.params)
        return draws


def _states_equal(a, b) -> bool:
    sa, sb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    return all(np.array_equal(sa[k], sb[k]) for k in sa)


def test_armed_idle_driver_is_bit_identical_to_unarmed():
    d1, d2 = _tdriver(), _tdriver()
    plane = d2.arm_control(spec=TC.ControlSpec(epoch_windows=2))
    for _ in range(6):
        d1.step(8)
        d2.step(8)
    assert _states_equal(d1.state, d2.state)
    assert plane.state.actuations == 0 and plane.state.epoch == 3
    assert all(e["action"] in ("hold", "dwell") for e in plane.state.log)
    # one ring read per control epoch, nothing else
    assert d2.dispatch_stats["readbacks"] - d1.dispatch_stats["readbacks"] == 3
    assert d2.params == d1.params


def test_driver_under_loss_climbs_like_jax():
    jd = JSimDriver(_jparams(), N, seed=7)
    chain = DriverChain(7)
    td = _tdriver(draws=chain)
    chain.driver = td
    spec_kw = dict(epoch_windows=1, dwell_up=1)
    jplane = jd.arm_control(spec=JC.ControlSpec(**spec_kw))
    tplane = td.arm_control(spec=TC.ControlSpec(**spec_kw))
    jd.state = JS.set_uniform_loss(jd.state, 0.25, floor=True)
    td.state = TS.set_uniform_loss(td.state, 0.25, floor=True)
    for w in range(6):
        jd.step(8)
        td.step(8)
        jsnap, tsnap = jd.control_snapshot(), td.control_snapshot()
        assert jsnap["decision_log"] == tsnap["decision_log"], f"window {w}"
        assert dataclasses.asdict(jd.params) == dataclasses.asdict(td.params), f"window {w}"
        assert _states_equal_jax(jd.state, td.state), f"window {w}"
        assert (jd.adaptive_state is None) == (td.adaptive_state is None)
        if jd.adaptive_state is not None:
            for f in ("lh", "conf_key", "conf"):
                assert np.array_equal(np.asarray(getattr(jd.adaptive_state, f)),
                                      getattr(td.adaptive_state, f).numpy()), (w, f)
    assert tplane.state.rung == jplane.state.rung == 2
    assert td.params.fanout == TC.DEFAULT_LADDER[2].fanout and td.params.adaptive.enabled
    assert td.health_snapshot()["control"]["actuations"] == 2


def test_spread_lag_gate_armed_matches_jax_rung_history():
    """The spread-lag gate armed (``spread_lag_gate`` 0.02, full metrics on
    so the f32 ``convergence_lag`` is live) under a 10% loss floor: the
    gate's votes climb the ladder while the miss rate alone would not,
    and the port's rung history, decision log and knobs equal JAX's window
    by window. The series is held to 2 ulp only, so a reading within 2 ulp
    of the gate could flip a rung: none comes that close here (the closest
    distance is asserted)."""
    gate = 0.02
    jp = dataclasses.replace(_jparams(), full_metrics=True)
    jd = JSimDriver(jp, N, seed=7)
    chain = DriverChain(7)
    td = SimDriver(convert.params_from_dict(dataclasses.asdict(jp)), N, seed=7, device="cpu", draws=chain)
    chain.driver = td
    spec_kw = dict(epoch_windows=1, dwell_up=1, spread_lag_gate=gate)
    jd.arm_control(spec=JC.ControlSpec(**spec_kw))
    td.arm_control(spec=TC.ControlSpec(**spec_kw))
    jd.state = JS.set_uniform_loss(jd.state, 0.1, floor=True)
    td.state = TS.set_uniform_loss(td.state, 0.1, floor=True)
    rungs, closest, voted = [], np.inf, 0
    for w in range(8):
        jd.step(8)
        td.step(8)
        jsnap, tsnap = jd.control_snapshot(), td.control_snapshot()
        assert jsnap["decision_log"] == tsnap["decision_log"], f"window {w}"
        assert dataclasses.asdict(jd.params) == dataclasses.asdict(td.params), f"window {w}"
        jl, tl = (np.float32(s["last_sensors"]["spread_lag"]) for s in (jsnap, tsnap))
        assert abs(int(jl.view(np.int32)) - int(tl.view(np.int32))) <= 2, f"window {w}: {jl} vs {tl}"
        if jl > 0:
            closest = min(closest, abs(int(jl.view(np.int32)) - int(np.float32(gate).view(np.int32))))
        voted += bool(jl >= gate and jsnap["last_sensors"]["miss_rate"] < JC.DEFAULT_LADDER[1].enter_miss_rate)
        rungs.append(tsnap["rung"])
    assert voted > 0 and rungs[-1] == 2, rungs
    assert closest > 2, f"a spread_lag reading came within {closest} ulp of the gate"


def _states_equal_jax(jst, tst) -> bool:
    ref, got = JS.snapshot(jst), convert.state_to_numpy(tst)
    return all(np.array_equal(got[k], v) for k, v in ref.items())


def test_set_protocol_knobs_validation_and_noop():
    d = _tdriver()
    with pytest.raises(ValueError, match="fanout"):
        d.set_protocol_knobs(fanout=0)
    with pytest.raises(ValueError, match="suspicion_mult"):
        d.set_protocol_knobs(suspicion_mult=0)
    d.step(8)
    before = d.params
    d.set_protocol_knobs(fanout=d.params.fanout)  # a no-op keeps the params object
    assert d.params is before
    snap = convert.state_to_numpy(d.state)
    d.set_protocol_knobs(fanout=4, suspicion_mult=2)
    assert d.params.fanout == 4 and d.params.suspicion_mult == 2
    assert all(np.array_equal(v, convert.state_to_numpy(d.state)[k]) for k, v in snap.items())
    d.step(8)
    assert int(d.state.up.sum()) == N


def test_control_state_checkpoint_round_trip(tmp_path):
    d = _tdriver()
    plane = d.arm_control(spec=TC.ControlSpec(epoch_windows=1, dwell_up=1))
    d.state = TS.set_uniform_loss(d.state, 0.25, floor=True)
    for _ in range(4):
        d.step(8)
    assert plane.state.rung == 2
    path = os.path.join(tmp_path, "ctl.npz")
    d.checkpoint(path)
    d2 = _tdriver()
    p2 = d2.arm_control(spec=TC.ControlSpec(epoch_windows=1, dwell_up=1))
    d2.restore(path)
    assert p2.state.rung == 2 and p2.state.actuated and p2.state.actuations == plane.state.actuations
    assert [e["action"] for e in p2.state.log] == [e["action"] for e in plane.state.log]
    assert d2.params.fanout == TC.DEFAULT_LADDER[2].fanout and d2.params.adaptive.enabled
    # the checkpointed adaptive evidence survives the rung re-application
    assert d.adaptive_state.lh.any()
    assert torch.equal(d2.adaptive_state.lh, d.adaptive_state.lh)
    assert torch.equal(d2.adaptive_state.conf, d.adaptive_state.conf)
    d2.step(8)
    # a checkpoint without controller state resets an armed controller and
    # re-bases an actuated plane's knobs to the base rung
    d3 = _tdriver()
    d3.step(8)
    path2 = os.path.join(tmp_path, "plain.npz")
    d3.checkpoint(path2)
    d2.restore(path2)
    assert d2.control.state.rung == 0 and not d2.control.state.actuated and d2.control.state.log == []
    assert d2.params.fanout == TC.DEFAULT_LADDER[0].fanout
    assert not d2.params.adaptive.enabled and d2.adaptive_state is None
    d2.step(8)


def test_arm_control_exclusions_and_falsifiability_refusal():
    d = _tdriver()
    d.arm_trace()
    with pytest.raises(ValueError, match="trace"):
        d.arm_control()
    d2 = _tdriver()
    with pytest.raises(ValueError, match="falsifiability"):
        d2.arm_control(spec=TC.ControlSpec(blind=True))
    with pytest.raises(ValueError, match="falsifiability"):
        d2.arm_control(spec=TC.ControlSpec(clamped=False))
    plane = d2.arm_control()
    assert d2.arm_control() is plane and d2.control is plane
    with pytest.raises(ValueError, match="control"):
        d2.arm_trace()
    assert d2.control_snapshot()["armed"] and _tdriver().control_snapshot() == {"armed": False}


# -- 3. the fleet certification harness ------------------------------------------

S = 8
ARMS = [("controlled", None), ("static", 0), ("static", 1), ("static", 2), ("blind", None), ("unclamped", None)]


# the JAX fleet runner itself: the certifier test below patches the module's
# name with a lookup into this cache, which must not call back into itself
_JAX_RUN_CONTROLLED_FLEET = JC.run_controlled_fleet


@functools.lru_cache(maxsize=None)
def _jax_record(cell: int, arm: str, static_rung):
    kw = {} if static_rung is None else {"static_rung": static_rung}
    return _JAX_RUN_CONTROLLED_FLEET(JSH.SHIFTING_FAMILY[cell](n=48), arm, n=48, n_seeds=S, **kw)


def _chain_source():
    chain = FleetChain(JFL.fleet_keys(1000 + np.arange(S)), None, dense_draws)

    def source(n_ticks, params):
        chain.params = params
        return chain(n_ticks)

    return source


@pytest.mark.parametrize("arm,static_rung", ARMS)
def test_run_controlled_fleet_matches_jax(arm, static_rung):
    kw = {} if static_rung is None else {"static_rung": static_rung}
    ref = _jax_record(0, arm, static_rung)
    got = TC.run_controlled_fleet(TSH.SHIFTING_FAMILY[0](n=48), arm, n=48, n_seeds=S, device="cpu",
                                  draws=_chain_source(), **kw)
    assert got == ref
    if arm == "controlled":
        assert got["actuations"] > 0 and got["knob_changes"]


def test_certify_controller_mc_matches_jax(monkeypatch):
    """The JAX certifier judged over the JAX records (cached above), the
    port's over its own fleets: one cell, 8 seeds — the verdicts, the
    intervals and the separations agree."""
    cell = JSH.SHIFTING_FAMILY[0](n=48)
    monkeypatch.setattr(JC, "run_controlled_fleet", lambda c, arm, static_rung=None, **kw: _jax_record(
        0, arm, static_rung))
    ref = JC.certify_controller_mc(cells=[cell], n=48, n_seeds=S)
    got = TC.certify_controller_mc(cells=[TSH.SHIFTING_FAMILY[0](n=48)], n=48, n_seeds=S, device="cpu",
                                   draws=lambda c, arm, rung: _chain_source())
    assert got == ref
    entry = got["entries"][0]
    assert entry["blind_fails_certification"] and entry["unclamped_fails_certification"]
